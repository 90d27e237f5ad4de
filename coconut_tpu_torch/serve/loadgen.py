"""Closed- and open-loop load generation against a CredentialService, with
the latency/goodput report the serving layer is judged by — the port's
copy of `coconut_tpu/serve/loadgen.py`, with the same report keys.

Two arrival disciplines, because they answer different questions:

  - CLOSED loop ("closed"): `concurrency` client threads, each submitting
    its next request the moment the previous verdict lands. Measures the
    service AT SATURATION — batch occupancy and goodput ceilings — the
    way a backfill or a load test drives it.
  - OPEN loop ("open"): one submitter with Poisson (exponential
    inter-arrival) timing at `rate_per_s`, never waiting for verdicts.
    Measures LATENCY UNDER LOAD the way real user traffic does — closed
    loops hide queueing delay because slow responses throttle the
    offered load (the classic coordinated-omission trap).

Each request draws (credential, messages, expected_verdict) from `pool`
(mix valid/forged by building the pool accordingly); verdicts are checked
against expectations so a demux bug shows up as `verdict_mismatches`, not
silently as throughput. Every future is awaited: `dropped_futures` counts
futures that never resolved (must be 0 — the service guarantees it) and
`errors` counts futures that resolved exceptionally.

The report embeds client-observed p50/p95/p99/mean/max latency, goodput
(verdicts delivered per second of wall), mean batch occupancy
(coalesced requests per flushed batch / max_batch, from the metrics
counters' delta over the run), and the admission rejection rate. With
tracing enabled (COCONUT_TRACE=1) it also embeds `stage_breakdown_s` —
the per-stage span totals accumulated DURING the run (queue_wait /
coalesce / dispatch / device / demux), which finally separates "slow
device" from "slow batcher" for the same requests the latency
percentiles describe; null when tracing is off. Against a dispatcher
POOL the report adds `devices` (per-executor dispatch/request/busy-second
deltas with occupancy = busy_s / wall) and `placement` (single vs sharded
routing decisions, plus capacity spills) — the per-device surfaces the
scaling sweep (bench.py BENCH_SERVE_DEVICES) is built from.

MIXED WORKLOAD (`issue_fraction` > 0, with `issue_service`/`issue_pool`):
each arrival is a coin flip between a verify request against `service`
and an ISSUANCE request against the threshold-issuance service
(issue/) — the deployment shape where one fleet both mints
and verifies credentials. Issuance outcomes are tallied separately (a
minted credential is the truthy verdict; `expect_valid` is always True —
every accepted mint must verify) and the report grows an "issue" section
with its own latency percentiles, goodput, batch occupancy, and the
quorum-health deltas (hedges, discarded partials, quorum-unreachable)
accumulated over the run. Both workloads share the arrival discipline:
under a closed loop they compete for the same client threads, which is
exactly the interference a mixed fleet sees.

FULL SESSIONS (`run_session_loadgen`): closed-loop clients each walk one
credential through prepare -> mint -> show_prove -> show_verify on a
ProtocolEngine, reporting session latency percentiles beside per-program
goodput. Unlike the reference, each show is verified under its
credential's mint epoch, so sessions stay valid across key rollovers.

RPC TRANSPORT (`transport="rpc"`): `service` / `engine` is a fleet
gateway client (net.GatewayClient or net.ReplicaRouter) in place of the
engine; each session gets a stable session id (routed with affinity
through a router's `bound(session)`), and the reports give
`rpc_overhead_s`, the mean client-observed latency minus the engine-side
mean (None on the direct transport).

AVAILABILITY: every verify report embeds an "availability"
section — a per-second goodput/error timeline, `error_free_seconds`,
and the raw settled-future events — plus an errors split into
`errors_retryable` (refusals a caller could resubmit: retryable or
transient types) and `errors_terminal` (everything else). The rolling-
restart drill asserts `errors_terminal == 0` while replicas cycle, and
`restart_to_first_slo(report["availability"], t_mark, slo_s)` turns a
restart timestamp into the restart-to-first-SLO-compliant-response
number the bench lane asserts on.

Determinism knobs: `rng` (arrival jitter + pool sampling), `clock`, and
`sleep` are injectable, so tests can drive the generator without
wall-clock flakiness; the 2-second CI smoke uses the real ones.
"""

import random
import threading
import time

from .. import metrics
from ..errors import (
    ServiceBrownoutError,
    ServiceClosedError,
    ServiceOverloadedError,
    ServiceRetryableError,
    TransientBackendError,
)
from ..obs import trace as otrace


def _stage_totals():
    """{span name: (count, total_s)} snapshot, or None when tracing is
    off — the loadgen reports the DELTA over its run."""
    tracer = otrace.get_tracer()
    if tracer is None:
        return None
    return {
        name: (s["count"], s["total_s"])
        for name, s in tracer.stage_summary().items()
    }


def _stage_delta(before, after):
    """Per-stage {count, total_s, mean_s} accumulated between two
    _stage_totals snapshots."""
    if after is None:
        return None
    before = before or {}
    out = {}
    for name, (count, total) in sorted(after.items()):
        c0, t0 = before.get(name, (0, 0.0))
        dc, dt = count - c0, total - t0
        if dc <= 0:
            continue
        out[name] = {
            "count": dc,
            "total_s": round(dt, 6),
            "mean_s": round(dt / dc, 6),
        }
    return out


def _device_report(before_counts, before_timers, elapsed):
    """Per-device {dispatches, requests, busy_s, occupancy} delta over the
    run, keyed by executor label — nonzero dispatches on EVERY device is
    the pool's "actually scaled out" invariant (bench/ci assert it)."""
    d_counts = metrics.counters_with_prefix("serve_dev")
    d_timers = metrics.timers_with_prefix("serve_dev")
    devices = {}
    for name, value in d_counts.items():
        label, _, field = name[len("serve_dev"):].rpartition("_")
        if field not in ("dispatches", "requests"):
            continue
        delta = value - before_counts.get(name, 0)
        if delta:
            devices.setdefault(label, {})[field] = delta
    for name, value in d_timers.items():
        if not name.endswith("_busy_s"):
            continue
        label = name[len("serve_dev"):-len("_busy_s")]
        busy = value - before_timers.get(name, 0.0)
        if label in devices or busy > 0:
            dev = devices.setdefault(label, {})
            dev["busy_s"] = round(busy, 6)
            dev["occupancy"] = round(min(busy / elapsed, 1.0), 4)
    return devices or None


def _placement_report(before_counts):
    """{single, sharded[, spill]} placement-decision deltas over the run."""
    out = {}
    for kind in ("single", "sharded", "spill"):
        name = "serve_placed_%s" % kind
        delta = metrics.get_count(name) - before_counts.get(name, 0)
        if delta or kind != "spill":
            out[kind] = delta
    return out if (out.get("single") or out.get("sharded")) else None


#: engine-side latency histogram per program (metric namespaces from
#: serve/batcher.py, the reference's engine/phases.py, issue/service.py) —
#: the server-side term of the rpc_overhead_s subtraction
_ENGINE_LATENCY_HISTS = (
    "serve_latency_s",   # verify
    "prep_latency_s",    # prepare
    "issue_latency_s",   # mint
    "prove_latency_s",   # show_prove
    "showv_latency_s",   # show_verify
)


def _engine_latency_totals():
    """Summed (count, total_s) over every engine-side latency hist."""
    count, total = 0, 0.0
    for name in _ENGINE_LATENCY_HISTS:
        c, t = metrics.hist_totals(name)
        count += c
        total += t
    return count, total


def _rpc_overhead(transport, client_latencies, eng0, eng1):
    """Client-observed mean latency minus the engine-side mean over the
    run — the per-request wire/framing/routing tax. None for the direct
    transport or when either side completed nothing."""
    if transport != "rpc" or not client_latencies:
        return None
    d_count = eng1[0] - eng0[0]
    d_total = eng1[1] - eng0[1]
    if d_count <= 0:
        return None
    client_mean = sum(client_latencies) / len(client_latencies)
    return round(max(client_mean - d_total / d_count, 0.0), 6)


#: availability events embedded per report — enough for any drill, small
#: enough that a report stays a readable JSON artifact
_MAX_AVAILABILITY_EVENTS = 20000


def _availability(events, t0, elapsed):
    """The drill's availability section: a per-second goodput/error
    timeline plus error-free seconds, built from the tally's settled-
    future events. `events` are (t_absolute, latency_s | None, ok);
    bucket k covers [k, k+1) seconds after t0."""
    seconds = max(1, int(elapsed) + (1 if elapsed > int(elapsed) else 0))
    goodput = [0] * seconds
    errs = [0] * seconds
    for t, _lat, ok in events:
        idx = min(max(int(t - t0), 0), seconds - 1)
        if ok:
            goodput[idx] += 1
        else:
            errs[idx] += 1
    out_events = [
        [round(t - t0, 4), None if lat is None else round(lat, 6), bool(ok)]
        for t, lat, ok in events[:_MAX_AVAILABILITY_EVENTS]
    ]
    return {
        "seconds": seconds,
        "per_second_goodput": goodput,
        "per_second_errors": errs,
        "error_free_seconds": sum(1 for e in errs if e == 0),
        "events": out_events,
        "events_truncated": len(events) > _MAX_AVAILABILITY_EVENTS,
    }


#: public name for the per-second goodput/error timeline builder (the
#: reference's scenario layer builds its availability section on it)
availability_timeline = _availability


def restart_to_first_slo(availability, t_mark, slo_s):
    """Seconds from `t_mark` (relative to the run's start, e.g. the
    moment a replica restart began) to the FIRST completion at/after it
    whose latency met `slo_s` — the drill's restart-to-first-SLO-
    compliant-response number. None when no compliant completion
    followed the mark."""
    best = None
    for t, lat, ok in availability["events"]:
        if ok and lat is not None and t >= t_mark and lat <= slo_s:
            if best is None or t < best:
                best = t
    return None if best is None else max(0.0, best - t_mark)


def latency_percentiles(latencies):
    return {
        "p50": metrics.percentile(latencies, 50),
        "p95": metrics.percentile(latencies, 95),
        "p99": metrics.percentile(latencies, 99),
        "mean": (sum(latencies) / len(latencies)) if latencies else None,
        "max": max(latencies) if latencies else None,
    }


class _Tally:
    """Shared, locked accounting across client threads."""

    def __init__(self):
        self.lock = threading.Lock()
        self.latencies = []
        self.submitted = 0
        self.rejected = 0
        self.shed = 0
        self.completed = 0
        self.errors = 0
        self.errors_retryable = 0
        self.errors_terminal = 0
        self.dropped = 0
        self.valid = 0
        self.invalid = 0
        self.mismatches = 0
        #: (t_absolute, latency_s | None, ok) per settled future — the
        #: availability timeline's raw material
        self.events = []

    def settle(self, future, expect_valid, t_submit, clock, timeout):
        """Await one future and fold its outcome in."""
        try:
            verdict = future.result(timeout)
        except TimeoutError:
            with self.lock:
                self.dropped += 1
            return
        except Exception as e:
            now = clock()
            retryable = isinstance(
                e, (ServiceRetryableError, TransientBackendError)
            )
            with self.lock:
                self.errors += 1
                if retryable:
                    # a refusal the caller could resubmit (drain handoff
                    # that ran out of ring, brownout, overload) — the
                    # rolling-restart drill asserts the TERMINAL count
                    # is zero, not this one
                    self.errors_retryable += 1
                else:
                    self.errors_terminal += 1
                self.events.append((now, None, False))
            return
        now = clock()
        dt = now - t_submit
        with self.lock:
            self.completed += 1
            self.latencies.append(dt)
            self.events.append((now, dt, True))
            if verdict:
                self.valid += 1
            else:
                self.invalid += 1
            if bool(verdict) != bool(expect_valid):
                self.mismatches += 1


def run_loadgen(
    service,
    pool,
    duration_s=2.0,
    arrival="closed",
    concurrency=8,
    rate_per_s=100.0,
    lane="interactive",
    rng=None,
    clock=time.monotonic,
    sleep=time.sleep,
    result_timeout=60.0,
    issue_service=None,
    issue_pool=None,
    issue_fraction=0.0,
    transport="direct",
):
    """Drive `service` for `duration_s` and return the report dict.

    pool: non-empty list of (sig, messages, expect_valid) tuples to sample
    from. arrival: "closed" (concurrency threads, submit-on-completion) or
    "open" (Poisson arrivals at rate_per_s, verdicts awaited at the end).
    The service must already be started; it is NOT drained here — callers
    own lifecycle (the bench lane drains after reading the report).

    Mixed workload: with `issue_service` (an issue.IssuanceService) and
    `issue_pool` (a list of (sig_request, messages, elgamal_sk) tuples),
    each arrival routes to issuance with probability `issue_fraction`;
    the report gains an "issue" section. issue_fraction=1.0 drives a
    pure-issuance run (the bench --issue lane).

    transport: "direct" (service IS the engine) or "rpc" (service is a
    net.GatewayClient / net.ReplicaRouter; the report adds
    `rpc_overhead_s` when the replica engines share this process)."""
    if not pool:
        raise ValueError("loadgen pool must be non-empty")
    if arrival not in ("closed", "open"):
        raise ValueError("unknown arrival discipline %r" % (arrival,))
    if transport not in ("direct", "rpc"):
        raise ValueError("unknown transport %r" % (transport,))
    if not 0.0 <= issue_fraction <= 1.0:
        raise ValueError(
            "issue_fraction must be in [0, 1] (got %r)" % (issue_fraction,)
        )
    if issue_fraction > 0.0 and (issue_service is None or not issue_pool):
        raise ValueError(
            "issue_fraction > 0 needs issue_service and a non-empty issue_pool"
        )
    rng = rng if rng is not None else random.Random(0x5E21E)
    tally = _Tally()
    issue_tally = _Tally()
    occ0_reqs = metrics.get_count("serve_batched_requests")
    occ0_batches = metrics.get_count("serve_batches")
    dev0_counts = metrics.counters_with_prefix("serve_dev")
    dev0_timers = metrics.timers_with_prefix("serve_dev")
    placed0 = metrics.counters_with_prefix("serve_placed")
    issue0 = metrics.counters_with_prefix("issue")
    stages0 = _stage_totals()
    eng_lat0 = _engine_latency_totals()
    t0 = clock()
    t_end = t0 + duration_s

    def submit_issue():
        sig_req, messages, elg_sk = issue_pool[rng.randrange(len(issue_pool))]
        t_submit = clock()
        try:
            fut = issue_service.submit(sig_req, messages, elg_sk, lane=lane)
        except ServiceOverloadedError:
            with issue_tally.lock:
                issue_tally.submitted += 1
                issue_tally.rejected += 1
            return None
        except ServiceBrownoutError:
            with issue_tally.lock:
                issue_tally.submitted += 1
                issue_tally.shed += 1
            return None
        except ServiceClosedError:
            return None
        with issue_tally.lock:
            issue_tally.submitted += 1
        # a minted credential is the truthy verdict; every accepted
        # issuance MUST mint (the service's verify-before-release gate
        # makes anything else an error, not an "invalid")
        return fut, True, t_submit, issue_tally

    def submit_one():
        if issue_fraction > 0.0 and rng.random() < issue_fraction:
            return submit_issue()
        sig, messages, expect_valid = pool[rng.randrange(len(pool))]
        t_submit = clock()
        try:
            fut = service.submit(sig, messages, lane=lane)
        except ServiceOverloadedError:
            with tally.lock:
                tally.submitted += 1
                tally.rejected += 1
            return None
        except ServiceBrownoutError:
            # graded load-shedding (retriable, typed): counted apart from
            # hard admission rejections so a report separates "queue
            # full" from "pool degraded, retry later"
            with tally.lock:
                tally.submitted += 1
                tally.shed += 1
            return None
        except ServiceClosedError:
            return None
        with tally.lock:
            tally.submitted += 1
        return fut, expect_valid, t_submit, tally

    if arrival == "closed":

        def client():
            while clock() < t_end:
                sub = submit_one()
                if sub is None:
                    continue
                fut, expect_valid, t_submit, t_acct = sub
                t_acct.settle(fut, expect_valid, t_submit, clock, result_timeout)

        threads = [
            threading.Thread(target=client, name="loadgen-%d" % i)
            for i in range(concurrency)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        outstanding = []
        while clock() < t_end:
            sub = submit_one()
            if sub is not None:
                outstanding.append(sub)
            sleep(rng.expovariate(rate_per_s))
        for fut, expect_valid, t_submit, t_acct in outstanding:
            t_acct.settle(fut, expect_valid, t_submit, clock, result_timeout)

    elapsed = max(clock() - t0, 1e-9)
    d_reqs = metrics.get_count("serve_batched_requests") - occ0_reqs
    d_batches = metrics.get_count("serve_batches") - occ0_batches
    # a gateway client has no max_batch (batching is server-side)
    max_batch = getattr(service, "max_batch", None)
    occupancy = (
        d_reqs / (d_batches * max_batch)
        if (d_batches and max_batch)
        else None
    )
    issue_report = None
    if issue_service is not None and issue_fraction > 0.0:
        issue_report = _issue_report(
            issue_tally, issue_service, issue0, elapsed
        )
    return {
        "arrival": arrival,
        "transport": transport,
        "duration_s": round(elapsed, 3),
        "concurrency": concurrency if arrival == "closed" else None,
        "offered_rate_per_s": rate_per_s if arrival == "open" else None,
        "submitted": tally.submitted,
        "rejected": tally.rejected,
        "shed": tally.shed,
        "completed": tally.completed,
        "errors": tally.errors,
        "errors_retryable": tally.errors_retryable,
        "errors_terminal": tally.errors_terminal,
        "dropped_futures": tally.dropped,
        "availability": _availability(tally.events, t0, elapsed),
        "valid": tally.valid,
        "invalid": tally.invalid,
        "verdict_mismatches": tally.mismatches,
        "latency_s": latency_percentiles(tally.latencies),
        "rpc_overhead_s": _rpc_overhead(
            transport, tally.latencies, eng_lat0, _engine_latency_totals()
        ),
        "stage_breakdown_s": _stage_delta(stages0, _stage_totals()),
        "devices": _device_report(dev0_counts, dev0_timers, elapsed),
        "placement": _placement_report(placed0),
        "goodput_per_s": round(tally.completed / elapsed, 2),
        "mean_batch_occupancy": (
            round(occupancy, 4) if occupancy is not None else None
        ),
        "batches": d_batches,
        "rejection_rate": (
            round(tally.rejected / tally.submitted, 4)
            if tally.submitted
            else None
        ),
        "issue_fraction": issue_fraction if issue_report else None,
        "issue": issue_report,
    }


#: the full-session pipeline's phase order (engine/session.ProtocolEngine)
SESSION_PHASES = ("prepare", "mint", "show_prove", "show_verify")


def run_session_loadgen(
    engine,
    pool,
    duration_s=2.0,
    concurrency=4,
    lane="interactive",
    rng=None,
    clock=time.monotonic,
    result_timeout=60.0,
    transport="direct",
):
    """Drive FULL protocol sessions against a ProtocolEngine: each client
    walks one credential through prepare -> mint -> show_prove ->
    show_verify, end to end, and the report gives end-to-end session
    latency percentiles NEXT TO per-program goodput — the number the
    paper's deployment story is judged by (a credential is only useful
    once it has been minted AND shown).

    pool: non-empty list of (messages, elgamal_pk, elgamal_sk) tuples to
    sample from (each session mints a fresh credential for its drawn
    identity). Closed loop only: `concurrency` session threads, each
    starting its next session when the previous one's show verdict
    lands — the arrival shape of a saturating enrollment pipeline. A
    session that fails at ANY hop counts one error (attributed to its
    phase in `phase_errors`); `failed_shows` counts sessions whose final
    verdict was False — a correctness alarm, since every minted
    credential must show-verify.

    The engine must already be started; callers own lifecycle.

    transport: "direct" (engine IS a ProtocolEngine) or "rpc" (engine is
    a net.GatewayClient / net.ReplicaRouter). Over RPC each session gets
    a stable session id — routed with consistent-hash affinity when the
    target is a router (its `bound(session)` seam) — and the report adds
    `rpc_overhead_s` (mean client-observed phase latency minus the
    engine-side mean, when the replica engines share this process)."""
    if not pool:
        raise ValueError("session loadgen pool must be non-empty")
    if transport not in ("direct", "rpc"):
        raise ValueError("unknown transport %r" % (transport,))
    rng = rng if rng is not None else random.Random(0x5E5510)
    lock = threading.Lock()
    session_lat = []
    phase_lat = {p: [] for p in SESSION_PHASES}
    phase_errors = {p: 0 for p in SESSION_PHASES}
    counts = {
        "started": 0,
        "completed": 0,
        "rejected": 0,
        "shed": 0,
        "failed_shows": 0,
    }
    stages0 = _stage_totals()
    eng_lat0 = _engine_latency_totals()
    t0 = clock()
    t_end = t0 + duration_s

    def run_one_session():
        messages, elg_pk, elg_sk = pool[rng.randrange(len(pool))]
        t_start = clock()
        with lock:
            counts["started"] += 1
            session_no = counts["started"]
        if transport == "rpc" and hasattr(engine, "bound"):
            # a router pins the whole prepare->mint->show flow to the
            # session's ring-primary replica (consistent-hash affinity)
            eng = engine.bound("sess-%d" % session_no)
        else:
            eng = engine
        phase = SESSION_PHASES[0]
        try:
            t_p = clock()
            sig_req, _rand = eng.submit_prepare(
                messages, elg_pk, lane=lane
            ).result(result_timeout)
            with lock:
                phase_lat["prepare"].append(clock() - t_p)
            phase = "mint"
            t_p = clock()
            cred = eng.submit_mint(
                sig_req, messages, elg_sk, lane=lane
            ).result(result_timeout)
            with lock:
                phase_lat["mint"].append(clock() - t_p)
            phase = "show_prove"
            t_p = clock()
            proof, challenge, revealed = eng.submit_show_prove(
                cred, messages, lane=lane
            ).result(result_timeout)
            with lock:
                phase_lat["show_prove"].append(clock() - t_p)
            phase = "show_verify"
            t_p = clock()
            # the shown credential's mint epoch picks the verkey its proof
            # verifies against (None on an engine without a keychain);
            # the reference omits it, so its sessions on a keychain engine
            # fail every show once the boot epoch is no longer active
            verdict = eng.submit_show_verify(
                proof, revealed, challenge,
                epoch=getattr(cred, "epoch", None), lane=lane,
            ).result(result_timeout)
            with lock:
                phase_lat["show_verify"].append(clock() - t_p)
        except ServiceOverloadedError:
            with lock:
                counts["rejected"] += 1
            return
        except ServiceBrownoutError:
            with lock:
                counts["shed"] += 1
            return
        except ServiceClosedError:
            return
        except Exception:
            with lock:
                phase_errors[phase] += 1
            return
        with lock:
            counts["completed"] += 1
            session_lat.append(clock() - t_start)
            if not verdict:
                counts["failed_shows"] += 1

    def client():
        while clock() < t_end:
            run_one_session()

    threads = [
        threading.Thread(target=client, name="session-loadgen-%d" % i)
        for i in range(concurrency)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    elapsed = max(clock() - t0, 1e-9)
    per_program = {}
    for phase, lats in phase_lat.items():
        per_program[phase] = {
            "completed": len(lats),
            "errors": phase_errors[phase],
            "goodput_per_s": round(len(lats) / elapsed, 2),
            "latency_s": latency_percentiles(lats),
        }
    all_phase_lat = [dt for lats in phase_lat.values() for dt in lats]
    return {
        "arrival": "closed",
        "transport": transport,
        "duration_s": round(elapsed, 3),
        "concurrency": concurrency,
        "sessions_started": counts["started"],
        "sessions_completed": counts["completed"],
        "rejected": counts["rejected"],
        "shed": counts["shed"],
        "errors": sum(phase_errors.values()),
        "failed_shows": counts["failed_shows"],
        "sessions_per_s": round(counts["completed"] / elapsed, 2),
        "session_latency_s": latency_percentiles(session_lat),
        "rpc_overhead_s": _rpc_overhead(
            transport, all_phase_lat, eng_lat0, _engine_latency_totals()
        ),
        "per_program": per_program,
        "stage_breakdown_s": _stage_delta(stages0, _stage_totals()),
    }


def _issue_report(t, issue_service, before_counts, elapsed):
    """The mixed-workload report's issuance section: client-observed
    outcomes plus the quorum-health counter deltas over the run. Every
    completion IS a minted-and-verified credential, so `mismatches` > 0
    (a falsy mint) or `errors` concentrated here point at the issuance
    pool, not the verify pool."""

    def delta(name):
        return metrics.get_count(name) - before_counts.get(name, 0)

    fanouts = delta("issue_batches")
    return {
        "submitted": t.submitted,
        "rejected": t.rejected,
        "shed": t.shed,
        "minted": t.completed,
        "errors": t.errors,
        "dropped_futures": t.dropped,
        "mint_mismatches": t.mismatches,
        "latency_s": latency_percentiles(t.latencies),
        "goodput_per_s": round(t.completed / elapsed, 2),
        "mean_batch_occupancy": (
            round(
                delta("issue_batched_requests")
                / (fanouts * issue_service.max_batch),
                4,
            )
            if fanouts
            else None
        ),
        "fanouts": fanouts,
        "hedges": delta("issue_hedges"),
        "partials_discarded": delta("issue_partials_discarded"),
        "corrupt_partials": delta("issue_corrupt_partials"),
        "quorum_unreachable": delta("issue_quorum_unreachable"),
    }
