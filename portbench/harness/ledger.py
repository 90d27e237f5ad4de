"""The inputs of the ledger cells, made from the seed on the host: one
Setup's params shared by several issuers, each with its own schema (an
attribute count), signing key, verkey and pool of valid credentials, and
the plan of each ledger segment (which issuer's credential each record
is, and which records are forged).

The credentials are made as fixtures.py makes them (the signing equations
under a master key, products by g from fixed-base tables), as plain ints
with the discrete logs that the signing-key check needs. The pools are
kept like fixtures.py's, under a key that holds a digest of this file.
"""

import collections
import hashlib
import random
from pathlib import Path

from . import fixtures
from .traffic import _rng
from ..reference.curve import G1_GEN, G2_GEN, g1, g2
from ..reference.fields import R

_DIGEST = hashlib.sha256(Path(__file__).read_bytes()).hexdigest()


def pools(seed, n, schemas):
    """Issuers of the attribute counts `schemas`, each with `n` valid
    credentials, under one params with h of length max(schemas).

    Returns {"params": {"g", "g_tilde", "h"}, "issuers": [{"sk": (x, [y]),
    "vk": (X_tilde, [Y_tilde]), "creds": [(sigma_1, sigma_2, msgs)],
    "logs": [(log sigma_1, log sigma_2)]}]}, one issuer a schema, in
    order."""
    schemas = list(schemas)
    return fixtures._kept(
        "ledger", (seed, n, schemas, _DIGEST), lambda: _pools(seed, n, schemas)
    )


def _pools(seed, n, schemas):
    rng = random.Random(seed)
    g = g1.mul(G1_GEN, rng.randrange(1, R))
    g_tilde = g2.mul(G2_GEN, rng.randrange(1, R))
    h = [g1.mul(G1_GEN, rng.randrange(1, R)) for _ in range(max(schemas))]
    g_mul = fixtures.FixedBase(g1, g).mul
    issuers = []
    for msg_count in schemas:
        x = rng.randrange(1, R)
        y = [rng.randrange(1, R) for _ in range(msg_count)]
        vk = (g2.mul(g_tilde, x), [g2.mul(g_tilde, yj) for yj in y])
        creds, logs = [], []
        for _ in range(n):
            msgs = [rng.randrange(R) for _ in range(msg_count)]
            t = rng.randrange(1, R)
            e = (x + sum(yj * m for yj, m in zip(y, msgs))) % R
            creds.append((g_mul(t), g_mul(t * e), msgs))
            logs.append((t, t * e % R))
        issuers.append({"sk": (x, y), "vk": vk, "creds": creds, "logs": logs})
    return {"params": {"g": g, "g_tilde": g_tilde, "h": h}, "issuers": issuers}


def segment_plan(seed, index, pool_n, segment, forge_every, schemas):
    """Segment `index` of a ledger cell: [((issuer, pool index), forged
    attribute or None)] a record, in ledger order.

    The issuer of each record is drawn from the seed, uniform over
    `schemas` and independently of every other record, so a segment's
    share of each issuer varies; an issuer's records are a seeded
    permutation of its pool (drawn again when the share outgrows it).
    segment // forge_every records at seeded positions change one
    attribute of their own issuer's schema."""
    rng = _rng(seed, "segment", index)
    k = len(schemas)
    owner = [rng.randrange(k) for _ in range(segment)]
    need = collections.Counter(owner)
    order = {}
    for i in range(k):
        order[i] = []
        while len(order[i]) < need[i]:
            order[i] += rng.sample(range(pool_n), min(pool_n, need[i] - len(order[i])))
    forged = set(rng.sample(range(segment), segment // forge_every))
    return [
        ((i, order[i].pop()), rng.randrange(schemas[i]) if pos in forged else None)
        for pos, i in enumerate(owner)
    ]
