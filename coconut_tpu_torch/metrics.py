"""The port's metrics registry: scoped timers, counters, gauges, bounded
latency histograms with nearest-rank percentiles, snapshot providers, and
`snapshot()` / `reset()` — a copy of `coconut_tpu/metrics.py` with the same
metric names, kept apart from the JAX package's registry.

The host layers report here:
  stream.py / retry.py / faults.py
      "retries", "fallbacks", "bisections", "dead_letters",
      "checkpoint_quarantined", "prefetch_wait" (timer),
      "prefetched_batches", "dead_letter_torn_lines", "flight_torn_lines";
  serve/ and engine/ (the online verify service)
      "serve_admitted" / "serve_rejected", "serve_batches" /
      "serve_batched_requests", "serve_pad_lanes", "serve_valid" /
      "serve_invalid", "serve_failed_requests", "serve_cancelled",
      "serve_jit_shapes", the "serve_latency_s" and "serve_batch_wait_s"
      histograms, the per-executor family "serve_dev<label>_dispatches" /
      "_requests" / "_busy_s" (timer) / "_load" and "_health" (gauges),
      "serve_placed_single" / "_sharded" / "_spill", "serve_queue_depth"
      and "serve_healthy_executors" (gauges), and the self-healing
      counters "serve_quarantined", "serve_probes", "serve_probe_failures",
      "serve_recovered", "serve_watchdog_timeouts",
      "serve_executor_crashes", "serve_redistributed_batches" /
      "_requests", "serve_redispatch_exhausted", "serve_shed_bulk",
      "serve_brownout" (gauge), "serve_health_tick_errors",
      "future_callback_errors";
  state/ (the durable state plane) and its consumers
      the journal: "wal_appends" (records framed into a WAL) against
      "wal_fsyncs" (the gap IS the group commit: one sync per engine
      batch, not per lane), "wal_torn_tails" (torn trailing frames
      truncated on open — exactly once per torn crash),
      "wal_replayed_records", "wal_segments_rotated"; the store:
      "state_records_applied" (local and remote applies),
      "state_snapshots" / "state_snapshot_loads" /
      "state_snapshot_corrupt" (a CRC-failed snapshot is quarantined
      `.corrupt` and the store rebuilds from the WAL),
      "state_compactions", "state_keyspaces_dropped",
      "state_nullifiers_compacted" (nullifiers dropped with a retired
      epoch); anti-entropy: "state_antientropy_pulls",
      "state_antientropy_dropped" (pulls swallowed by injected
      partitions), "state_replicator_errors"; the nullifier set:
      "nullifier_commits" (accepted shows journaled BEFORE their
      futures resolve), "nullifier_double_spends" (replays rejected
      with DoubleSpendError), "nullifier_probe_hits" (device-probe hits
      before the verify bit), "nullifier_probe_errors" (advisory probe
      failures — detection moves to commit time, never admits a double
      spend), "nullifier_commit_errors" (WAL failures that turned
      would-be accepts into TransientBackendError: no resolve without
      durability); "dead_letter_index_errors" / "dead_letter_errors"
      (lazy-durability write failures, counted and survived); and the
      breaker journal's "health_journal_errors" (journal writes that
      raised inside a state transition — durability degrades to memory,
      the transition never fails).

Histograms keep the most recent HIST_WINDOW samples for percentiles and
exact count / total / max over the whole run, so `snapshot()`'s
percentiles are over the retained window. While tracing is on (obs/,
COCONUT_TRACE=1) `snapshot()` embeds the "trace_stages" section through
`register_provider`, so this module never imports obs.
"""

import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager

_lock = threading.RLock()
_timers = defaultdict(float)
_counts = defaultdict(int)
_hists = {}
_gauges = {}
_providers = {}  # snapshot section name -> zero-arg callable

# per-histogram retained-sample window (memory bound; count/total/max stay
# exact over the full run)
HIST_WINDOW = 4096


@contextmanager
def timer(name):
    """Accumulate wall-clock seconds under `name`
    (e.g. "encode", "kernel", "readback")."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _timers[name] += dt


def count(name, n=1):
    """Add n to the counter `name` (e.g. "verifies", "transfer_bytes")."""
    with _lock:
        _counts[name] += n


def get_count(name):
    """Current value of counter `name` (0 if never counted)."""
    with _lock:
        return _counts.get(name, 0)


def counters_with_prefix(prefix):
    """{name: value} for every counter whose name starts with `prefix` —
    how the serving report reads a whole per-device family
    ("serve_dev<d>_dispatches") without enumerating device ids."""
    with _lock:
        return {k: v for k, v in _counts.items() if k.startswith(prefix)}


def timers_with_prefix(prefix):
    """{name: seconds} for every timer whose name starts with `prefix`
    (the per-device busy-time family)."""
    with _lock:
        return {k: v for k, v in _timers.items() if k.startswith(prefix)}


def set_gauge(name, value):
    """Set the point-in-time gauge `name` (e.g. "serve_queue_depth", a
    device executor's current load): last-write-wins, reported verbatim
    by snapshot() under "gauges" — unlike counters these go DOWN."""
    with _lock:
        _gauges[name] = value


def get_gauge(name, default=None):
    with _lock:
        return _gauges.get(name, default)


def observe(name, seconds):
    """Record one sample in the bounded histogram `name` (e.g.
    "serve_latency_s"). Keeps the most recent HIST_WINDOW samples for
    percentile readout plus exact count/total/max over the full run."""
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = {
                "count": 0,
                "total": 0.0,
                "max": 0.0,
                "window": deque(maxlen=HIST_WINDOW),
            }
        h["count"] += 1
        h["total"] += seconds
        if seconds > h["max"]:
            h["max"] = seconds
        h["window"].append(seconds)


def percentile(samples, q):
    """q-th percentile (q in [0, 100]) of `samples` by the nearest-rank
    method. Tiny-window behavior is PINNED, not emergent:

      n == 0  ->  None (there is no sample to report — never a fabricated
                  zero);
      n == 1  ->  the single sample, for EVERY q including 0 and 100;
      q outside [0, 100] -> ValueError (previously q=-5 silently read the
                  min and q=200 the max — a caller bug masquerading as a
                  statistic).

    Small-n honest in general: p99 of 10 samples is the max, not an
    interpolated fiction."""
    if not 0.0 <= q <= 100.0:
        raise ValueError("percentile q must be in [0, 100] (got %r)" % (q,))
    if not samples:
        return None
    import math

    s = sorted(samples)
    rank = max(0, min(len(s) - 1, math.ceil(q / 100.0 * len(s)) - 1))
    return s[rank]


def percentile_summary(samples, qs=(50, 95, 99)):
    """{"p50": ..., ...} nearest-rank readout with the tiny-window policy
    of `percentile` made structural: n=0 returns an EMPTY dict (absent
    keys, not None-or-zero values), n=1 returns the single sample under
    every requested quantile."""
    if not samples:
        return {}
    return {"p%g" % q: percentile(samples, q) for q in qs}


def _hist_readout(h):
    window = list(h["window"])
    n = h["count"]
    ps = percentile_summary(window)
    return {
        "count": n,
        "mean_s": round(h["total"] / n, 6) if n else None,
        "p50_s": round(ps["p50"], 6) if ps else None,
        "p95_s": round(ps["p95"], 6) if ps else None,
        "p99_s": round(ps["p99"], 6) if ps else None,
        "max_s": round(h["max"], 6),
    }


def hist_totals(name):
    """(count, total_seconds) of histogram `name` over the FULL run —
    exact, not window-bounded. (0, 0.0) if nothing was observed. Loadgen
    reads deltas of these (the engine-side term of rpc_overhead_s)."""
    with _lock:
        h = _hists.get(name)
        if h is None:
            return 0, 0.0
        return h["count"], h["total"]


def register_provider(name, fn):
    """Register a zero-arg callable whose result snapshot() embeds under
    `name` — how obs.trace contributes the per-stage span breakdown
    without this module importing it."""
    with _lock:
        _providers[name] = fn


def unregister_provider(name):
    with _lock:
        _providers.pop(name, None)


def snapshot():
    """{"timers_s": {...}, "counters": {...}[, "histograms": {...}]
    [, <provider sections>]} — current totals; histogram readouts
    (count / mean / p50 / p95 / p99 / max over the retained window)
    appear once anything has been observe()d; provider sections (e.g.
    "trace_stages" while tracing is enabled) appear while registered and
    non-empty."""
    with _lock:
        snap = {
            "timers_s": {k: round(v, 6) for k, v in sorted(_timers.items())},
            "counters": dict(sorted(_counts.items())),
        }
        if _hists:
            snap["histograms"] = {
                k: _hist_readout(h) for k, h in sorted(_hists.items())
            }
        if _gauges:
            snap["gauges"] = dict(sorted(_gauges.items()))
        providers = list(_providers.items())
    # provider callables run OUTSIDE the lock (they may take their own)
    for name, fn in providers:
        section = fn()
        if section:
            snap[name] = section
    return snap


def reset():
    with _lock:
        _timers.clear()
        _counts.clear()
        _hists.clear()
        _gauges.clear()


def rate(counter, timer_name):
    """counter / timer seconds, or None if either is missing/zero."""
    with _lock:
        t = _timers.get(timer_name)
        c = _counts.get(counter)
    if not t or not c:
        return None
    return c / t
