"""Epoch-scoped nullifier set: the double-spend detector — the port's copy
of `coconut_tpu/state/nullifier.py`, with the same derivations, keyspace
names and counters, and its membership probe as torch ops on a device.

A credential may be SHOWN at most once per epoch (the Coconut paper's
e-cash and petition applications). The nullifier is a deterministic
digest of the show transcript —

    sha256(b"coconut-nullifier/v1"
           || u32 epoch (0 when unscoped)
           || 32-byte big-endian Fiat-Shamir challenge
           || proof.to_bytes(ctx))           # canonical wire encoding

— so replaying the SAME show (same proof bytes, same challenge) derives
the same nullifier, while a fresh show of the same credential
re-randomizes sigma' and derives a new one. Scenario domains: an optional
`domain` (a scope string, e.g. "petition/save-the-bees", "ecash") puts
the nullifier in a keyspace of its own, and an optional 32-byte spend
`tag` (`spend_tag_of`) derives it from the tag instead of the transcript,
so any re-spend of the same credential in the same domain collides. With
either present the v2 derivation is used, so scoped digests never collide
with unscoped ones.

Two-tier membership check:

  1. `probe` — the advisory device pass fused ahead of the verify bit:
     spent digests become rows of a SORTED [pad, 8] limb table
     (big-endian sha256 limbs, `build_table`), padded to a power of two
     with all-ones sentinel rows, and each lane runs a BRANCHLESS lower
     bound: log2(pad) rounds of lexicographic row compare, gather and
     `where`, then one gather and row equality masked by `pos < n_real`.
     The limbs travel as int64 tensors: torch has no `<` on uint32, and
     int32 would order a limb >= 2^31 below a small one. A hit clears the
     lane's own verify bit. The table snapshot may lag a concurrent
     commit, so the probe never decides alone.
  2. `commit` — the authoritative host check-and-set under the store
     lock: accepted lanes re-check the live set AND each other (an
     intra-batch replay pair must not both land), then every new
     nullifier is WAL-appended in ONE group commit
     (`StateStore.put_many`, one fsync a keyspace a batch) BEFORE any
     future resolves, so an acknowledged show survives a SIGKILL.

The guard's device is explicit: `cuda` unless the caller names another,
and asking for `cuda` where no card is present raises (there is no silent
fall-back). `use_device=False` runs the plain version: the same function
on CPU tensors.

Counters: "nullifier_probe_hits" (the probe masked a lane),
"nullifier_double_spends" (commit-time rejections), "nullifier_commits"
(accepted + persisted), "state_nullifiers_compacted" (dropped with a
retired epoch)."""

import hashlib

import numpy as np
import torch

from .. import metrics

_TAG = b"coconut-nullifier/v1"
_TAG_V2 = b"coconut-nullifier/v2"
_SPEND_TAG = b"coconut-spend-tag/v1"
_LIMBS = 8  # sha256 = 8 big-endian u32 limbs


def nullifier_of(proof, challenge, epoch, params, domain=None, tag=None):
    """Hex nullifier for one show transcript.

    Unscoped (domain and tag both None): the v1 transcript digest —
    deterministic under replay, fresh under honest re-randomized shows.
    Scoped: a v2 digest over (epoch, domain, material) where material is
    the 32-byte spend `tag` when given (a re-spend of the same credential
    collides) or the transcript otherwise (replay-only detection, confined
    to the domain's keyspace)."""
    e = 0 if epoch is None else int(epoch)
    if domain is None and tag is None:
        return hashlib.sha256(
            _TAG
            + e.to_bytes(4, "big")
            + int(challenge).to_bytes(32, "big")
            + proof.to_bytes(params.ctx)
        ).hexdigest()
    dom = (domain or "").encode("utf-8")
    if tag is not None:
        material = bytes(tag)
        if len(material) != 32:
            raise ValueError("nullifier tag must be exactly 32 bytes")
    else:
        material = (
            int(challenge).to_bytes(32, "big") + proof.to_bytes(params.ctx)
        )
    return hashlib.sha256(
        _TAG_V2
        + e.to_bytes(4, "big")
        + len(dom).to_bytes(2, "big")
        + dom
        + material
    ).hexdigest()


def spend_tag_of(sig_bytes, domain):
    """Deterministic 32-byte spend tag binding a credential to a domain:
    sha256 over the MINTED credential's canonical bytes (which never
    change — shows re-randomize a copy) and the domain string. Same
    credential + same domain -> same tag -> the derived nullifier collides
    on any second spend; another domain yields an unrelated tag, so one
    credential signs many campaigns."""
    dom = (domain or "").encode("utf-8")
    return hashlib.sha256(
        _SPEND_TAG + len(dom).to_bytes(2, "big") + dom + bytes(sig_bytes)
    ).digest()


def keyspace_of(epoch, domain=None):
    """Nullifier keyspace name for an (epoch, domain) scope (epoch 0 =
    unscoped shows; no domain = the classic fleet-wide keyspace)."""
    e = 0 if epoch is None else int(epoch)
    if domain:
        return "nullifier/%s/%d" % (domain, e)
    return "nullifier/%d" % e


# -- membership probe ---------------------------------------------------------


def digests_to_limbs(hex_digests):
    """[n, 8] big-endian uint32 limb rows for sha256 hex digests."""
    if not hex_digests:
        return np.zeros((0, _LIMBS), dtype=np.uint32)
    raw = b"".join(bytes.fromhex(d) for d in hex_digests)
    return (
        np.frombuffer(raw, dtype=">u4")
        .reshape(-1, _LIMBS)
        .astype(np.uint32)
    )


def build_table(hex_digests):
    """Sorted, power-of-two-padded limb table and its real row count.
    Sentinel rows are all-ones (above any real digest, probability 2^-256
    aside), so the lower bound never lands on padding for a real query."""
    rows = digests_to_limbs(sorted(set(hex_digests)))
    n = len(rows)
    pad = 1
    while pad < max(1, n):
        pad *= 2
    if pad > n:
        filler = np.full(
            (pad - n, _LIMBS), 0xFFFFFFFF, dtype=np.uint32
        )
        rows = np.concatenate([rows, filler], axis=0)
    return rows, n


def limbs_on(rows, device):
    """uint32 limb rows (numpy) -> an int64 tensor on `device`; a tensor
    is moved as it is."""
    if isinstance(rows, torch.Tensor):
        return rows.to(device)
    return torch.from_numpy(np.asarray(rows, dtype=np.int64)).to(device)


def _row_weights(device):
    """Limb j's weight 2^(7-j) in the row compare: the first differing limb
    outweighs every later one together. Made on the device (no host copy,
    which would synchronize the stream every round)."""
    return 1 << torch.arange(_LIMBS - 1, -1, -1, dtype=torch.int64, device=device)


def _row_less(a, b, w):
    """Branchless lexicographic a < b over [m, 8] int64 limb rows: the
    sign of each limb's difference, weighted by `w` (_row_weights) so the
    first differing limb decides."""
    return (torch.sign(a - b) * w).sum(dim=1) < 0


def lower_bound_hits(table, n_real, queries):
    """The probe on the device: [m] bool hits of int64 `queries` [m, 8]
    against the sorted padded int64 `table` [pad, 8], both on one device.
    Fixed log2(pad) rounds (no data-dependent control flow), then one
    gather and row equality masked by pos < n_real."""
    m = queries.shape[0]
    pad = table.shape[0]
    pos = torch.zeros((m,), dtype=torch.int64, device=queries.device)
    w = _row_weights(queries.device)
    step = pad
    while step > 1:
        step //= 2
        cand = pos + step
        # advance while table[cand - 1] < query (pad is a power of two,
        # so log2(pad) rounds reach the lower bound)
        go = _row_less(table[cand - 1], queries, w)
        pos = torch.where(go, cand, pos)
    return (table[pos] == queries).all(dim=1) & (pos < n_real)


def membership_probe(table, n_real, queries, device="cpu"):
    """Boolean hit mask (numpy) for `queries` ([m, 8] limb rows) against a
    sorted padded `table` ([pad, 8]), run as torch ops on `device`. Rows
    may be numpy uint32 (as `build_table` gives them) or int64 tensors;
    on "cpu" this is the plain version."""
    m = queries.shape[0]
    if m == 0 or n_real == 0:
        return np.zeros((m,), dtype=bool)
    hits = lower_bound_hits(
        limbs_on(table, device), n_real, limbs_on(queries, device)
    )
    return hits.cpu().numpy().astype(bool)


class NullifierGuard:
    """Check-and-set front for the nullifier keyspaces of a StateStore.

    `probe` is the advisory device pass (fused into the show-verify bit);
    `commit` is the authoritative host pass that WAL-persists accepted
    nullifiers with one group commit per batch. `device` is where the
    probe runs (`cuda` by default; raises without a card);
    `use_device=False` runs the plain version on the CPU instead."""

    def __init__(self, store, use_device=True, device=None):
        from ..gpu.backend import resolve_device

        self.store = store
        self.use_device = use_device
        self.device = (
            resolve_device(device) if use_device else torch.device("cpu")
        )
        # table cache per keyspace, keyed by spent count (the set only
        # grows, so a stale count means a stale table): (count, n_real,
        # the limb rows on self.device)
        self._tables = {}

    # -- advisory device probe ------------------------------------------------

    def _table_for(self, ks):
        keys = self.store.keys(ks)
        cached = self._tables.get(ks)
        if cached is not None and cached[0] == len(keys):
            return cached[2], cached[1]
        table, n_real = build_table(keys)
        on_device = limbs_on(table, self.device)
        self._tables[ks] = (len(keys), n_real, on_device)
        return on_device, n_real

    def probe(self, hex_digests, epochs=None, domains=None):
        """Per-lane spent flags. Lanes are grouped by (epoch, domain)
        keyspace; each group is one batched probe on the guard's device."""
        n = len(hex_digests)
        if epochs is None:
            epochs = [None] * n
        if domains is None:
            domains = [None] * n
        out = [False] * n
        by_ks = {}
        for i, (d, e, dom) in enumerate(zip(hex_digests, epochs, domains)):
            by_ks.setdefault(keyspace_of(e, dom), []).append((i, d))
        for ks, lanes in by_ks.items():
            table, n_real = self._table_for(ks)
            if n_real == 0:
                continue
            queries = digests_to_limbs([d for _, d in lanes])
            hits = membership_probe(table, n_real, queries, self.device)
            for (i, _), h in zip(lanes, hits):
                if h:
                    out[i] = True
        n_hits = sum(out)
        if n_hits:
            metrics.count("nullifier_probe_hits", n_hits)
        return out

    # -- epoch retirement -----------------------------------------------------

    def retire_epoch(self, epoch):
        """Drop a retired epoch's nullifier keyspace wholesale and compact
        the WAL underneath it. Safe because the engine refuses
        retired-epoch shows at submit time (EpochRetiredError) BEFORE any
        membership probe. Domain-scoped keyspaces of the same epoch
        (suffix "/<epoch>") are dropped alongside the classic one. Returns
        the number of nullifiers compacted away."""
        e = 0 if epoch is None else int(epoch)
        suffix = "/%d" % e
        victims = [
            ks
            for ks in self.store.keyspaces()
            if ks.startswith("nullifier/") and ks.endswith(suffix)
        ]
        victims.append(keyspace_of(epoch))
        n = 0
        for ks in dict.fromkeys(victims):
            n += self.store.drop_keyspace(ks)
            self._tables.pop(ks, None)
        if n:
            metrics.count("state_nullifiers_compacted", n)
        return n

    # -- authoritative commit -------------------------------------------------

    def seen(self, hex_digest, epoch=None, domain=None):
        return self.store.seen(keyspace_of(epoch, domain), hex_digest)

    def commit(self, hex_digests, epochs=None, accept=None, domains=None):
        """Check-and-set under the store lock: for every lane with
        accept[i] truthy, re-check the live set and the batch itself;
        new nullifiers are WAL-appended with ONE fsync per keyspace group
        BEFORE this returns. Returns per-lane booleans: True = accepted and
        durable, False = double spend (or the lane was not accepted to
        begin with)."""
        n = len(hex_digests)
        if epochs is None:
            epochs = [None] * n
        if domains is None:
            domains = [None] * n
        if accept is None:
            accept = [True] * n
        ok = [False] * n
        with self.store._lock:
            fresh = {}  # ks -> (epoch, [(key, value), ...])
            batch_seen = set()
            for i, (d, e, dom) in enumerate(
                zip(hex_digests, epochs, domains)
            ):
                if not accept[i]:
                    continue
                ks = keyspace_of(e, dom)
                if (ks, d) in batch_seen or self.store.seen(ks, d):
                    metrics.count("nullifier_double_spends")
                    continue
                batch_seen.add((ks, d))
                fresh.setdefault(ks, (e, []))[1].append((d, 1))
                ok[i] = True
            for ks, (e, items) in fresh.items():
                self.store.put_many(ks, items, epoch=e, fsync=True)
        n_ok = sum(ok)
        if n_ok:
            metrics.count("nullifier_commits", n_ok)
        return ok
