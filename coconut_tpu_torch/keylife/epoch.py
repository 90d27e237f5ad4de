"""Key epochs — the port's copy of `coconut_tpu/keylife/epoch.py`:
versioned key material with a bounded live window and a two-phase
activate / retire handoff.

A KeySet is one consistent set of threshold key shares (every partial
aggregated into one credential must come from the same set). Two
coordinates version it: `epoch`, the public identity credentials carry and
verify resolves the verkey by (a reshare bumps it), and `gen`, the private
revision a proactive refresh bumps while the verkey stays byte-identical.

The EpochRegistry is the rollover state machine:

  PENDING   registered (keys installed on the authorities), not serving
  ACTIVE    the epoch new mints pin; exactly one at a time
  RETIRING  superseded, but pinned fan-outs still complete under it and
            its credentials still verify
  RETIRED   pushed out of the window of `window` live epochs: key material
            dropped, verify refuses with EpochRetiredError

`pin_active()` / `unpin()` are the handoff: a mint fan-out pins the active
KeySet when it opens and unpins when it closes. Retirement is driven by
window pressure and deferred while an epoch is pinned. Unknown (or still
PENDING) epochs refuse with EpochUnknownError.

Metrics: "keylife_active_epoch" / "keylife_live_epochs" gauges;
"keylife_activations" / "keylife_retirements" / "keylife_epoch_unknown" /
"keylife_epoch_retired" counters.

`store=` (a state.StateStore) journals the state machine's transitions
into the store's "epoch" keyspace, and a registry built over a store
restores which epoch ids exist and which are retired.
"""

import threading

from .. import metrics
from ..errors import EpochRetiredError, EpochUnknownError, GeneralError

PENDING = "pending"
ACTIVE = "active"
RETIRING = "retiring"
RETIRED = "retired"

#: wire codes for the beacon's per-epoch state byte (net/wire.py)
EPOCH_STATE_CODES = {PENDING: 0, ACTIVE: 1, RETIRING: 2, RETIRED: 3}
EPOCH_STATE_OF_CODE = {c: s for s, c in EPOCH_STATE_CODES.items()}


class KeySet:
    """One consistent share set: `signers` (keygen.Signer list — each
    authority takes its own entry's sigkey), the aggregated verkey `vk`
    every credential minted from this set verifies under, and the
    (epoch, gen) coordinates above. `qual`/`excluded` record the DKG
    round's dealer audit (who contributed, who was named)."""

    __slots__ = (
        "epoch", "gen", "threshold", "signers", "vk", "qual", "excluded",
    )

    def __init__(self, epoch, gen, threshold, signers, vk,
                 qual=(), excluded=()):
        self.epoch = epoch
        self.gen = gen
        self.threshold = threshold
        self.signers = list(signers)
        self.vk = vk
        self.qual = tuple(sorted(qual))
        self.excluded = tuple(sorted(excluded))

    @property
    def key(self):
        """The identity a fan-out pins and an authority keys its share
        store by: one (epoch, gen) pair = one consistent share set."""
        return (self.epoch, self.gen)

    @property
    def total(self):
        return len(self.signers)

    def verkeys_by_id(self):
        return {s.id: s.verkey for s in self.signers}

    def signer(self, signer_id):
        for s in self.signers:
            if s.id == signer_id:
                return s
        return None

    def __repr__(self):
        return "KeySet(epoch=%d, gen=%d, t=%d, n=%d)" % (
            self.epoch, self.gen, self.threshold, len(self.signers),
        )


class _Entry:
    __slots__ = ("keyset", "state", "pins")

    def __init__(self, keyset):
        self.keyset = keyset
        self.state = PENDING
        #: (epoch, gen) -> open-fan-out count; old gens linger here until
        #: their in-flight mints drain, keeping refresh non-disruptive
        self.pins = {}

    def total_pins(self):
        return sum(self.pins.values())


class EpochRegistry:
    """The epoch state machine plus the verify path's epoch -> verkey
    resolver. Thread-safe: mint fan-outs pin/unpin from authority
    threads while the lifecycle manager activates from its own."""

    def __init__(self, window=3, store=None):
        if window < 1:
            raise ValueError("window must be >= 1 (got %r)" % (window,))
        self.window = window
        self._lock = threading.Lock()
        self._entries = {}  # epoch id -> _Entry
        self._active = None  # epoch id
        self._max_registered = 0
        self._retired = set()  # epoch ids retired out of the window
        #: state.StateStore: the registry journals its state-machine
        #: transitions into the "epoch" keyspace. Key material is NOT
        #: journaled (shares cannot round-trip through a replicated log);
        #: what survives a restart is the METADATA — which epoch ids
        #: exist and which are retired — so a restarted replica keeps
        #: refusing retired-epoch credentials and never re-issues an
        #: already-used epoch id, even before its keysets are re-installed
        #: by the lifecycle manager.
        self._store = store
        #: callbacks fired after the registry lock is released, once per
        #: retired epoch id — the nullifier guard hangs its keyspace
        #: compaction here (state/nullifier.py retire_epoch); hooks may
        #: fsync and compact a WAL
        self._retire_hooks = []
        if store is not None:
            for key in store.keys("epoch"):
                epoch = int(key)
                self._max_registered = max(self._max_registered, epoch)
                rec = store.get("epoch", key)
                if rec and rec.get("event") == "retired":
                    self._retired.add(epoch)
        metrics.set_gauge("keylife_active_epoch", 0)
        metrics.set_gauge("keylife_live_epochs", 0)

    def add_retire_hook(self, fn):
        """Register fn(epoch_id), called after each retirement commits
        (lock released). Errors are swallowed — a hook failure must not
        wedge the epoch window."""
        with self._lock:
            self._retire_hooks.append(fn)

    def _fire_retire_hooks(self, victims):
        for epoch in victims:
            for fn in list(self._retire_hooks):
                try:
                    fn(epoch)
                except Exception:  # pragma: no cover - defensive
                    metrics.count("keylife_retire_hook_errors")

    def _journal_locked(self, epoch, event):
        if self._store is not None:
            self._store.put(
                "epoch", str(epoch), {"event": event}, epoch=epoch
            )

    # -- registration / activation (lifecycle-manager side) ------------------

    def next_epoch(self):
        with self._lock:
            return self._max_registered + 1

    def register(self, keyset):
        """Phase one of the handoff: the epoch exists (keys are installed
        on the authorities) but nothing serves under it yet."""
        with self._lock:
            if keyset.epoch <= self._max_registered:
                raise GeneralError(
                    "epoch ids are monotonic: %d already registered "
                    "(max %d)" % (keyset.epoch, self._max_registered)
                )
            self._entries[keyset.epoch] = _Entry(keyset)
            self._max_registered = keyset.epoch
            self._journal_locked(keyset.epoch, "registered")
            self._publish_locked()

    def activate(self, epoch):
        """Phase two: new mints pin `epoch`; the previously active epoch
        moves to RETIRING (still verifying), and the oldest retiring
        epochs retire once `window` live epochs crowd them out."""
        with self._lock:
            entry = self._entries.get(epoch)
            if entry is None:
                raise GeneralError("cannot activate unknown epoch %d" % epoch)
            if entry.state != PENDING:
                raise GeneralError(
                    "epoch %d is %s, not pending" % (epoch, entry.state)
                )
            if self._active is not None:
                self._entries[self._active].state = RETIRING
            entry.state = ACTIVE
            self._active = epoch
            metrics.count("keylife_activations")
            self._journal_locked(epoch, "active")
            victims = self._enforce_window_locked()
            self._publish_locked()
        self._fire_retire_hooks(victims)

    def install_gen(self, keyset):
        """Proactive refresh landed: swap epoch `keyset.epoch`'s current
        share set for the next gen. The verkey MUST be unchanged (the
        manager asserts bit-identity before calling); fan-outs pinned to
        the old gen keep minting from it until they drain."""
        with self._lock:
            entry = self._entries.get(keyset.epoch)
            if entry is None:
                raise GeneralError(
                    "cannot refresh unknown epoch %d" % keyset.epoch
                )
            if keyset.gen != entry.keyset.gen + 1:
                raise GeneralError(
                    "refresh gen %d does not follow current gen %d"
                    % (keyset.gen, entry.keyset.gen)
                )
            entry.keyset = keyset

    # -- pinning (mint side) -------------------------------------------------

    def pin_active(self):
        """The active KeySet, pinned: the caller's fan-out mints under it
        even if a refresh or reshare lands mid-flight. Pair with
        unpin()."""
        with self._lock:
            if self._active is None:
                raise GeneralError("no active key epoch")
            entry = self._entries[self._active]
            ks = entry.keyset
            entry.pins[ks.key] = entry.pins.get(ks.key, 0) + 1
            return ks

    def unpin(self, keyset):
        """A fan-out pinned to `keyset` closed; a crowded-out RETIRING
        epoch whose pins just drained retires now."""
        with self._lock:
            entry = self._entries.get(keyset.epoch)
            if entry is None:
                return
            n = entry.pins.get(keyset.key, 0) - 1
            if n > 0:
                entry.pins[keyset.key] = n
            else:
                entry.pins.pop(keyset.key, None)
            victims = self._enforce_window_locked()
            self._publish_locked()
        self._fire_retire_hooks(victims)

    # -- resolution (verify side) --------------------------------------------

    def resolve(self, epoch):
        """The KeySet a credential minted under `epoch` verifies against.
        ACTIVE and RETIRING epochs resolve (a pre-rollover credential
        stays verifiable through the handoff); RETIRED/evicted refuse
        with EpochRetiredError; unknown or not-yet-activated epochs with
        EpochUnknownError — both typed, both wire-coded."""
        with self._lock:
            entry = self._entries.get(epoch)
            if entry is not None and entry.state in (ACTIVE, RETIRING):
                return entry.keyset
            live = self._live_ids_locked()
            if epoch in self._retired:
                metrics.count("keylife_epoch_retired")
                raise EpochRetiredError(epoch, live=live)
            metrics.count("keylife_epoch_unknown")
            raise EpochUnknownError(epoch, live=live)

    def vk_for(self, epoch):
        return self.resolve(epoch).vk

    def active(self):
        with self._lock:
            if self._active is None:
                raise GeneralError("no active key epoch")
            return self._entries[self._active].keyset

    @property
    def active_epoch(self):
        with self._lock:
            return self._active

    def state(self, epoch):
        with self._lock:
            entry = self._entries.get(epoch)
            if entry is not None:
                return entry.state
            return RETIRED if epoch in self._retired else None

    def live_epochs(self):
        """[(epoch id, state)] for every serving-relevant epoch — what a
        replica's beacon advertises so routers know which epochs it can
        mint or verify under."""
        with self._lock:
            return [
                (e, entry.state)
                for e, entry in sorted(self._entries.items())
                if entry.state in (PENDING, ACTIVE, RETIRING)
            ]

    def pin_count(self, epoch):
        with self._lock:
            entry = self._entries.get(epoch)
            return entry.total_pins() if entry is not None else 0

    # -- internals (lock held) -----------------------------------------------

    def _live_ids_locked(self):
        return [
            e
            for e, entry in self._entries.items()
            if entry.state in (ACTIVE, RETIRING)
        ]

    def _enforce_window_locked(self):
        """Bound the window: at most `window` live (ACTIVE/RETIRING)
        epochs. Oldest RETIRING epochs retire first — their key material
        is DROPPED, not archived. An epoch with live pins defers until
        its last fan-out unpins; the ACTIVE epoch never retires.
        Returns the retired epoch ids so callers can fire the retire
        hooks AFTER releasing the registry lock."""
        victims = []
        while len(self._live_ids_locked()) > self.window:
            victim = None
            for e in sorted(self._entries):
                entry = self._entries[e]
                if entry.state == RETIRING and entry.total_pins() == 0:
                    victim = e
                    break
            if victim is None:
                break
            del self._entries[victim]
            self._retired.add(victim)
            self._journal_locked(victim, "retired")
            metrics.count("keylife_retirements")
            victims.append(victim)
        return victims

    def _publish_locked(self):
        metrics.set_gauge("keylife_active_epoch", self._active or 0)
        metrics.set_gauge(
            "keylife_live_epochs", len(self._live_ids_locked())
        )
