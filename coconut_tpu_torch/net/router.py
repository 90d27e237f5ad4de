"""Front-door replica router: consistent-hash session affinity with
least-loaded spill and beacon-driven demotion.

A credential session is a stateful FLOW on the client side
(prepare -> mint -> show_prove -> show_verify: the randomness from
prepare is the PoK witness at mint) but stateless on the replica side —
so the router's job is purely placement quality, not correctness:

  AFFINITY   sessions hash onto a consistent ring (sha256, `vnodes`
             virtual nodes per replica) and stick to their ring-primary
             replica while it is UP — warm batches, stable per-replica
             load, minimal reshuffling when the fleet changes size.
  SPILL      a demoted primary (DEGRADED/DOWN in the gossip directory)
             sends the session to the least-loaded routable replica
             (last-beacon queue depth), falling back to DEGRADED
             replicas only when nothing is UP — mirrors the graded
             executor demotion one level up.
  FAILOVER   a TransientBackendError from the data path (torn
             connection, dead loopback) marks the replica DOWN in the
             directory immediately (`note_failure`) and resubmits the
             request on the next candidate under the retry.py ladder —
             bounded attempts, deterministic jittered backoff. A
             ServiceClosedError (retryable over the wire) is the
             GRACEFUL twin: the replica is draining, so the directory
             learns DRAINING (`note_draining` — beacons keep flowing)
             and the request hands off to a ring successor the same
             way. Other typed engine refusals (brownout/overload/
             tenant) are NOT failover triggers: they propagate to the
             caller, whose backoff the retry_after_s hint already
             guides. DoubleSpendError is likewise TERMINAL:
             the nullifier is a deterministic digest of the replayed
             transcript, so every replica with the replicated fact
             returns the same rejection — failing over a double spend
             would only probe for a replica the anti-entropy pull has
             not reached yet, which is exactly the race the drill in
             probes/probe_nullifier.py proves closed.

Counters: "gateway_routed" / "gateway_affinity_hits" / "gateway_spills"
/ "gateway_failovers" / "gateway_drain_handoffs" / per-placement-state
"gateway_placed_<state>" (the rolling-restart drill's proof that no new
session lands on a WARMING or DRAINING replica), plus the directory's
own gateway_* set.
"""

import bisect
import hashlib
import time

from .. import metrics
from ..errors import ServiceClosedError, TransientBackendError
from ..retry import RetryPolicy, call_with_retry
from . import gossip

#: virtual nodes per replica on the hash ring — enough that removing one
#: replica spreads its sessions near-uniformly over the survivors
DEFAULT_VNODES = 64


def _hash64(key):
    return int.from_bytes(
        hashlib.sha256(key.encode("utf-8")).digest()[:8], "big"
    )


class _RoutedFuture:
    """A submitted request plus its failover plan: result() settles the
    current attempt and, on a transport failure, demotes the replica and
    resubmits on the next candidate under the router's retry policy."""

    def __init__(self, router, program, args, lane, session, rid, fut):
        self._router = router
        self._program = program
        self._args = args
        self._lane = lane
        self._session = session
        self._rid = rid
        self._fut = fut
        self._tried = {rid}

    @property
    def replica_id(self):
        """Replica the CURRENT attempt lives on (tests assert affinity)."""
        return self._rid

    def done(self):
        return self._fut.done()

    def add_done_callback(self, fn):
        """Callback-mode settle: fires `fn` with the CURRENT
        attempt's future — typed decode/raise semantics, but NO
        synchronous failover or retry sleeps (those would run on the
        transport reader thread). Async consumers like the scenario
        workflow runtime classify the typed error themselves and
        resubmit through the router, which re-routes around the
        unhealthy replica via the gossip directory."""
        self._fut.add_done_callback(lambda _f: fn(self._fut))

    def result(self, timeout=None):
        first = [True]
        last_exc = [None]

        def attempt():
            if not first[0]:
                metrics.count("gateway_failovers")
                if isinstance(last_exc[0], ServiceClosedError):
                    # graceful drain, not a crash: the replica still
                    # answers beacons — mark DRAINING, not DOWN
                    metrics.count("gateway_drain_handoffs")
                    self._router.directory.note_draining(self._rid)
                else:
                    self._router.directory.note_failure(self._rid)
                self._rid, self._fut = self._router._place(
                    self._program,
                    self._args,
                    self._lane,
                    self._session,
                    exclude=self._tried,
                )
                self._tried.add(self._rid)
            first[0] = False
            try:
                return self._fut.result(timeout)
            except Exception as e:
                last_exc[0] = e
                raise

        return call_with_retry(
            attempt, self._router.retry_policy, key=self._session
        )

    def exception(self, timeout=None):
        try:
            self.result(timeout)
            return None
        except TimeoutError:
            raise
        except Exception as e:
            return e


class _SessionClient:
    """A router bound to one session id: exposes the plain engine
    submit_* surface (no session kwarg), so session-flow code written
    against ProtocolEngine — serve/loadgen.py's full-session driver —
    runs over the fleet unchanged."""

    def __init__(self, router, session):
        self._router = router
        self.session = session

    def submit_verify(self, sig, messages, lane="interactive",
                      max_wait_ms=None):
        return self._router.submit_verify(
            sig, messages, lane=lane, session=self.session
        )

    def submit(self, sig, messages, lane="interactive", max_wait_ms=None):
        return self.submit_verify(sig, messages, lane=lane)

    def submit_prepare(self, messages, elgamal_pk, lane="bulk",
                       max_wait_ms=None):
        return self._router.submit_prepare(
            messages, elgamal_pk, lane=lane, session=self.session
        )

    def submit_mint(self, sig_request, messages, elgamal_sk,
                    lane="interactive", max_wait_ms=None):
        return self._router.submit_mint(
            sig_request, messages, elgamal_sk, lane=lane,
            session=self.session,
        )

    def submit_show_prove(self, sig, messages, lane="interactive",
                          max_wait_ms=None):
        return self._router.submit_show_prove(
            sig, messages, lane=lane, session=self.session
        )

    def submit_show_verify(self, proof, revealed_msgs, challenge=None,
                           epoch=None, domain=None, tag=None,
                           lane="interactive", max_wait_ms=None):
        return self._router.submit_show_verify(
            proof, revealed_msgs, challenge=challenge, epoch=epoch,
            domain=domain, tag=tag, lane=lane, session=self.session,
        )


class ReplicaRouter:
    """Spread sessions over `clients` ({replica_id: GatewayClient}) by
    consistent hash, guided by the gossip `directory`'s health view."""

    def __init__(
        self,
        clients,
        directory=None,
        vnodes=DEFAULT_VNODES,
        retry_policy=None,
        clock=time.monotonic,
    ):
        if not clients:
            raise ValueError("router needs at least one replica client")
        self.clients = dict(clients)
        self.directory = (
            gossip.HealthDirectory(self.clients)
            if directory is None
            else directory
        )
        self.clock = clock
        # one data-path attempt per replica plus one: a full ring sweep
        # can land back on the (possibly recovered) affinity target
        # ServiceClosedError rides along: a draining replica's
        # refusal is a handoff trigger, exactly like a torn transport
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=len(self.clients) + 1,
            base_delay=0.01,
            max_delay=0.5,
            retryable=(TransientBackendError, ServiceClosedError),
        )
        self.vnodes = vnodes
        self._ring = []
        self._order = sorted(self.clients)  # deterministic tie-break
        for rid in self._order:
            for v in range(vnodes):
                self._ring.append((_hash64("%s#%d" % (rid, v)), rid))
        self._ring.sort()
        self._keys = [h for h, _rid in self._ring]

    # -- placement -----------------------------------------------------------

    def candidates(self, session):
        """Every replica id in ring order from the session's hash point —
        [0] is the affinity primary, the rest the failover sequence."""
        start = bisect.bisect_right(self._keys, _hash64("s:%s" % session))
        out, seen = [], set()
        n = len(self._ring)
        for k in range(n):
            rid = self._ring[(start + k) % n][1]
            if rid not in seen:
                seen.add(rid)
                out.append(rid)
                if len(out) == len(self.clients):
                    break
        return out

    def route(self, session, exclude=()):
        """Choose the replica for one request of `session`. Affinity to
        the ring primary while it is UP; least-loaded spill otherwise;
        a fully-DOWN fleet still returns the primary (better to probe a
        possibly-recovering socket than refuse outright — the retry
        ladder bounds the cost)."""
        ring = self.candidates(session)
        live = [r for r in ring if r not in exclude]
        if not live:
            raise TransientBackendError(
                "no replicas left for session %r "
                "(all %d tried)" % (session, len(ring))
            )
        primary = live[0]
        if self.directory.routable(primary):
            metrics.count("gateway_affinity_hits")
            chosen = primary
        else:
            pool = [r for r in live if self.directory.routable(r)]
            if not pool:
                pool = [r for r in live if self.directory.usable(r)]
            if pool:
                d = self.directory
                chosen = min(
                    pool, key=lambda r: (d.queue_depth(r), ring.index(r))
                )
            else:
                chosen = primary  # last resort: everything is DOWN
            metrics.count("gateway_spills")
        metrics.count("gateway_routed")
        # the drill's audit trail: placements bucketed by the chosen
        # replica's directory state — "gateway_placed_warming" and
        # "gateway_placed_draining" staying at ZERO through a rolling
        # restart is the router-never-misplaces proof
        metrics.count("gateway_placed_%s" % self.directory.state(chosen))
        return chosen

    def _place(self, program, args, lane, session, exclude=()):
        rid = self.route(session, exclude=exclude)
        client = self.clients[rid]
        fut = getattr(client, "submit_" + program)(
            *args, lane=lane, session=session
        )
        return rid, fut

    def _submit(self, program, args, lane, session):
        rid, fut = self._place(program, args, lane, session)
        return _RoutedFuture(self, program, args, lane, session, rid, fut)

    # -- engine-shaped surface ------------------------------------------------

    def submit_verify(self, sig, messages, lane="interactive",
                      max_wait_ms=None, session=""):
        return self._submit("verify", (sig, messages), lane, session)

    def submit(self, sig, messages, lane="interactive", max_wait_ms=None,
               session=""):
        return self.submit_verify(
            sig, messages, lane=lane, session=session
        )

    def submit_prepare(self, messages, elgamal_pk, lane="bulk",
                       max_wait_ms=None, session=""):
        return self._submit(
            "prepare", (messages, elgamal_pk), lane, session
        )

    def submit_mint(self, sig_request, messages, elgamal_sk,
                    lane="interactive", max_wait_ms=None, session=""):
        return self._submit(
            "mint", (sig_request, messages, elgamal_sk), lane, session
        )

    def submit_show_prove(self, sig, messages, lane="interactive",
                          max_wait_ms=None, session=""):
        return self._submit("show_prove", (sig, messages), lane, session)

    def submit_show_verify(self, proof, revealed_msgs, challenge=None,
                           epoch=None, domain=None, tag=None,
                           lane="interactive", max_wait_ms=None,
                           session=""):
        return self._submit(
            "show_verify",
            (proof, revealed_msgs, challenge, epoch, domain, tag),
            lane, session,
        )

    def bound(self, session):
        """A client pinned to `session` with the plain engine surface —
        what the full-session loadgen drives one session flow through."""
        return _SessionClient(self, session)

    # -- gossip wiring --------------------------------------------------------

    def gossip_loop(self, interval_s=0.25, poll_timeout_s=2.0, clock=None):
        """A GossipLoop polling every replica's beacon endpoint through
        its own client connection. start() it for real fleets; call
        step() directly in fake-clock tests."""
        pollers = {
            rid: (lambda c=client: c.poll_beacon(timeout=poll_timeout_s))
            for rid, client in self.clients.items()
        }
        return gossip.GossipLoop(
            self.directory,
            pollers,
            interval_s=interval_s,
            clock=self.clock if clock is None else clock,
        )

    def close(self):
        for client in self.clients.values():
            try:
                client.close()
            except Exception:
                pass
