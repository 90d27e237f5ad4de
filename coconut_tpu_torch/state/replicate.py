"""Pull-based anti-entropy replication of WAL records — the port's copy
of `coconut_tpu/state/replicate.py`.

Replication is ASYNC and pull-based:

  - a directory (anything with `state_marks(rid)`) holds each peer's
    latest per-keyspace high-water marks, ((keyspace, origin, seq), ...)
    straight from that peer's `StateStore.marks()`;
  - `StateReplicator.step()` compares every peer's advertised marks
    with the local store and, for each gap (remote seq > local mark),
    pulls the missing page through the peer's client
    (`pull_state(keyspace, origin, after_seq, limit)`) and applies it
    via `StateStore.apply_remote` — idempotent, so overlapping pulls
    and redelivery are harmless. Counted under
    "state_antientropy_pulls" / "state_records_applied".

Because a replica serves records it merely REPLICATED (per-origin logs
in the store), facts spread transitively: A witnesses a show, B pulls it
from A, C can pull it from B after A dies.

Conflict resolution is the store's LWW by (epoch, apply-index,
origin); the replicator never interprets values.

Over the wire (net/): every beacon carries its replica's
`StateStore.marks()`, the gossip HealthDirectory keeps the latest marks
a replica (`state_marks(rid)`), `GatewayClient.pull_state` sends the
MSG_STATE_PULL, and a Replica answers it with a MSG_STATE_CHUNK from
its engine's store, also while it drains. `clients` and `directory` are
duck-typed, so tests may hand in any object with those methods.

Fault seam: `faults.ReplicationChaos.drop(peer, keyspace)` swallows
pulls to model a partitioned anti-entropy path; dropped pulls retry on
a later `step()`, so clearing the schedule shows convergence after
heal."""

import threading

from .. import metrics


class StateReplicator:
    """Periodic anti-entropy puller for one replica's StateStore.

    `clients` maps replica id -> an object with
    `pull_state(keyspace, origin, after_seq, limit)` returning an
    iterable of record dicts (net.GatewayClient, or any object with that
    method). `directory` is a net.HealthDirectory (or anything with
    `state_marks(rid)`)."""

    def __init__(
        self,
        store,
        directory,
        clients,
        interval_s=0.25,
        page=512,
        chaos=None,
        clock=None,
    ):
        self.store = store
        self.directory = directory
        self.clients = clients
        self.interval_s = interval_s
        self.page = page
        self.chaos = chaos
        self.clock = clock
        self._stop = threading.Event()
        self._thread = None

    # -- one anti-entropy round ----------------------------------------------

    def _gaps(self, peer):
        """(keyspace, origin, remote_seq, local_seq) for every mark
        where the peer advertises records we have not applied."""
        marks = self.directory.state_marks(peer)
        out = []
        for ks, origin, seq in marks:
            local = dict(
                (o, s)
                for k, o, s in self.store.marks()
                if k == ks
            ).get(origin, 0)
            if seq > local:
                out.append((ks, origin, seq, local))
        return out

    def step(self):
        """Pull every visible gap once. Returns records applied."""
        applied = 0
        for peer, client in list(self.clients.items()):
            if peer == self.store.replica_id:
                continue
            try:
                gaps = self._gaps(peer)
            except Exception:
                continue
            for ks, origin, remote_seq, local_seq in gaps:
                if self.chaos is not None and self.chaos.drop(
                    peer, ks
                ):
                    metrics.count("state_antientropy_dropped")
                    continue
                after = local_seq
                # page until the advertised mark is reached (or the
                # peer stops making progress — a concurrently
                # compacting peer still serves from its rebuilt logs)
                while after < remote_seq:
                    try:
                        recs = client.pull_state(
                            ks, origin, after, self.page
                        )
                    except Exception:
                        # peer died mid-pull: another peer (or a
                        # later step) will serve the same records
                        break
                    metrics.count("state_antientropy_pulls")
                    recs = list(recs)
                    if not recs:
                        break
                    applied += self.store.apply_remote(recs)
                    after = max(r["s"] for r in recs)
        return applied

    # -- background loop -----------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run,
            name="state-replicator-%s" % self.store.replica_id,
            daemon=True,
        )
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:  # pragma: no cover - belt and braces
                metrics.count("state_replicator_errors")

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
