"""The inputs of every cell, made from the seed on the host: a pool of PS
credentials (BASELINE config 2) and a pool of shows of such credentials
(config 3), as plain ints, with the discrete logs that the secret-key
check needs.

The construction follows the signing equations with a master key (the
output shape of unblind + aggregate, so no hash to the curve is needed):
sigma_1 = g * t and sigma_2 = sigma_1 * (x + sum_j y_j m_j). A show of a
credential re-randomizes it (sigma'_1 = sigma_1 * r, sigma'_2 = sigma'_1 *
(e + t')) and proves the opening of J = g_tilde * t' + sum_hidden
Y_tilde_j * m_j with a Schnorr proof whose commitment and responses are
computed from the discrete logs of its bases, two G1 and two G2 scalar
multiplications a proof. Products by g and g_tilde use fixed-base tables,
as the pools need thousands of them.

Only the signature assignment "G1" is made: sigma in G1, the verkey and
J in G2.

A pool is kept once made, under the checkout's build/portbench_pools/,
by its seed, size and shape and a digest of the code that makes it, so a
second run of a seed loads it instead of making it again. A kept file
whose digest does not match its contents is made again; a pool that is
wrong all the same disagrees with the output check's spec sample.
"""

import hashlib
import os
import pickle
import random
from pathlib import Path

from ..reference.curve import G1_GEN, G2_GEN, g1, g2
from ..reference.fields import R


class FixedBase:
    """k * p for one point p and many k: tables of p * j * 256^i (j < 256,
    i < 32), so a product is 32 additions instead of ~380 doublings and
    additions. The points equal group.mul(p, k)'s."""

    def __init__(self, group, p):
        self.group = group
        self.tables = []
        base = group.to_jacobian(p)
        for _ in range(32):  # 32 bytes cover r's 255 bits
            row = [(group.one, group.one, group.zero), base]
            for _ in range(254):
                row.append(group.jadd(row[-1], base))
            self.tables.append(row)
            base = group.jadd(row[-1], base)

    def mul(self, k):
        k %= R
        group = self.group
        acc = (group.one, group.one, group.zero)
        for row in self.tables:
            acc = group.jadd(acc, row[k & 255])
            k >>= 8
        return group.to_affine(acc)


CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "portbench_pools"
_CODE = Path(__file__).resolve().parents[1] / "reference"


def _code_digest():
    """A digest of this file and the reference arithmetic it uses."""
    h = hashlib.sha256(Path(__file__).read_bytes())
    for name in ("curve.py", "fields.py"):
        h.update((_CODE / name).read_bytes())
    return h.hexdigest()


def _kept(kind, key, make):
    """make(), or the pool kept for (kind, key) under CACHE_DIR. A file is
    its payload's SHA-256 followed by the pickled payload."""
    tag = hashlib.sha256(repr((kind, key, _code_digest())).encode()).hexdigest()[:32]
    path = CACHE_DIR / ("%s-%s.pickle" % (kind, tag))
    try:
        data = path.read_bytes()
    except OSError:
        data = b""
    if len(data) > 32 and hashlib.sha256(data[32:]).digest() == data[:32]:
        return pickle.loads(data[32:])
    pool = make()
    body = pickle.dumps(pool, protocol=pickle.HIGHEST_PROTOCOL)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name("%s.%d.tmp" % (path.name, os.getpid()))
    tmp.write_bytes(hashlib.sha256(body).digest() + body)
    os.replace(tmp, path)
    return pool


def _keys(rng, msg_count):
    """params (g, g_tilde, h), the signing key (x, y) and the verkey
    (X_tilde, Y_tilde) of one deployment."""
    g = g1.mul(G1_GEN, rng.randrange(1, R))
    g_tilde = g2.mul(G2_GEN, rng.randrange(1, R))
    h = [g1.mul(G1_GEN, rng.randrange(1, R)) for _ in range(msg_count)]
    x = rng.randrange(1, R)
    y = [rng.randrange(1, R) for _ in range(msg_count)]
    vk = (g2.mul(g_tilde, x), [g2.mul(g_tilde, yj) for yj in y])
    return {"g": g, "g_tilde": g_tilde, "h": h}, (x, y), vk


def credential_pool(seed, n, msg_count):
    """`n` valid credentials under one key, drawn from `seed`.

    Returns {"params", "sk", "vk", "creds": [(sigma_1, sigma_2, msgs)],
    "logs": [(log sigma_1, log sigma_2)]}, the logs over g."""
    return _kept("cred", (seed, n, msg_count), lambda: _credential_pool(seed, n, msg_count))


def _credential_pool(seed, n, msg_count):
    rng = random.Random(seed)
    params, sk, vk = _keys(rng, msg_count)
    x, y = sk
    g_mul = FixedBase(g1, params["g"]).mul
    creds, logs = [], []
    for _ in range(n):
        msgs = [rng.randrange(R) for _ in range(msg_count)]
        t = rng.randrange(1, R)
        e = (x + sum(yj * m for yj, m in zip(y, msgs))) % R
        creds.append((g_mul(t), g_mul(t * e), msgs))
        logs.append((t, t * e % R))
    return {"params": params, "sk": sk, "vk": vk, "creds": creds, "logs": logs}


def show_pool(seed, n, msg_count, revealed):
    """`n` valid shows revealing the attributes `revealed`, each of its own
    credential under one key, drawn from `seed`.

    Returns {"params", "sk", "vk", "revealed", "hidden", "shows": [(s1,
    s2, J, T, responses, {index: message}, challenge)], "logs": [(log s1,
    log s2, log J, log T)]}: the logs of the sigmas over g, of J and T
    over g_tilde; sigma'_2 = sigma'_1 * (e + t) and J = g_tilde * t +
    sum_hidden Y_tilde_j * m_j."""
    revealed = sorted(set(revealed))
    return _kept(
        "show", (seed, n, msg_count, revealed),
        lambda: _show_pool(seed, n, msg_count, revealed),
    )


def _show_pool(seed, n, msg_count, revealed):
    rng = random.Random(seed)
    params, sk, vk = _keys(rng, msg_count)
    x, y = sk
    revealed = sorted(set(revealed))
    hidden = [i for i in range(msg_count) if i not in revealed]
    bases_logs = [1] + [y[i] for i in hidden]  # [g_tilde, hidden Y_tilde] over g_tilde
    g_mul = FixedBase(g1, params["g"]).mul
    gt_mul = FixedBase(g2, params["g_tilde"]).mul
    shows, logs = [], []
    for _ in range(n):
        msgs = [rng.randrange(R) for _ in range(msg_count)]
        log_s1 = rng.randrange(1, R)
        t = rng.randrange(1, R)
        blindings = [rng.randrange(R) for _ in bases_logs]
        c = rng.randrange(R)
        e = (x + sum(yj * m for yj, m in zip(y, msgs))) % R
        secrets = [t] + [msgs[i] for i in hidden]
        log_j = sum(a * s for a, s in zip(bases_logs, secrets)) % R
        log_t = sum(a * b for a, b in zip(bases_logs, blindings)) % R
        log_s2 = log_s1 * (e + t) % R
        J, T = gt_mul(log_j), gt_mul(log_t)
        responses = [(b - c * s) % R for b, s in zip(blindings, secrets)]
        shows.append((
            g_mul(log_s1), g_mul(log_s2), J, T, responses,
            {i: msgs[i] for i in revealed}, c,
        ))
        logs.append((log_s1, log_s2, log_j, log_t))
    return {
        "params": params, "sk": sk, "vk": vk, "revealed": revealed,
        "hidden": hidden, "shows": shows, "logs": logs,
    }
