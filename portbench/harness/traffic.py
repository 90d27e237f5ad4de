"""The one traffic generator: it reads a cell's parameters (batch, pool,
forgery share, arrival rate) and the seed, and says what each batch or
request holds. It draws only indices into the pool and the planted
forgeries; the pool itself comes from fixtures.py.

Every seed gets the same amount of work in another order: each batch is a
permutation of the pool with exactly batch // forge_every forged lanes,
and the open-loop arrivals are one fixed set of gaps, shuffled by the
seed, so runs with different seeds differ only in which credential lands
where.
"""

import math
import random

from ..reference.fields import R


def _rng(seed, *tags):
    """A generator of its own for (seed, tags): a string seed, hashed by
    SHA-512, so it is the same in every process and Python build."""
    return random.Random("/".join(str(t) for t in (seed,) + tags))


def batch_plan(seed, index, pool_n, batch, forge_every, attrs):
    """Batch `index` of a bulk cell: [(pool index, forged attribute or
    None)] a lane. The lanes are a seeded permutation of the pool (drawn
    again when the batch outgrows it); batch // forge_every lanes at seeded
    positions change one attribute, drawn from `attrs`."""
    rng = _rng(seed, "batch", index)
    order = []
    while len(order) < batch:
        order += rng.sample(range(pool_n), min(pool_n, batch - len(order)))
    forged = set(rng.sample(range(batch), batch // forge_every))
    return [
        (p, rng.choice(attrs) if lane in forged else None)
        for lane, p in enumerate(order)
    ]


def pool_forgeries(seed, pool_n, forge_every, attrs):
    """{pool index: forged attribute} for a served cell's pool: pool_n //
    forge_every entries at seeded positions."""
    rng = _rng(seed, "pool")
    return {p: rng.choice(attrs) for p in sorted(rng.sample(range(pool_n), pool_n // forge_every))}


def arrivals(seed, rate, seconds):
    """Open-loop Poisson arrivals at `rate` a second over `seconds`:
    [(due time from the window's start, pool slot k)]. The gaps are one set
    for every seed (drawn from the rate and the length alone) in an order
    drawn from the seed; arrivals past `seconds` are dropped."""
    n = int(math.ceil(rate * seconds * 1.25)) + 16
    fixed = _rng("gaps", repr(float(rate)), n)
    gaps = [fixed.expovariate(rate) for _ in range(n)]
    _rng(seed, "order").shuffle(gaps)
    out, t = [], 0.0
    for g in gaps:
        t += g
        if t >= seconds:
            break
        out.append(t)
    return out


def request_order(seed, pool_n, count):
    """Which pool entry each of `count` requests sends: seeded permutations
    of the pool one after another, so every entry is sent equally often."""
    rng = _rng(seed, "requests")
    out = []
    while len(out) < count:
        out += rng.sample(range(pool_n), pool_n)
    return out[:count]


def forge(values, attr):
    """A copy of a lane's messages (a list, or a dict of the revealed
    ones) with attribute `attr` changed by one; the values as they are
    where `attr` is None."""
    if attr is None:
        return values
    values = values.copy()
    values[attr] = (values[attr] + 1) % R
    return values


def sample(seed, lanes, forged, k):
    """k lanes for the spec check, drawn from the seed: half from `forged`
    (those the forgery changed), the rest from the other lanes."""
    rng = _rng(seed, "sample")
    forged = sorted(forged)
    honest = sorted(set(lanes) - set(forged))
    kf = min(len(forged), k // 2)
    kh = min(len(honest), k - kf)
    return sorted(rng.sample(forged, kf) + rng.sample(honest, kh))
