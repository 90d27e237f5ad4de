"""Entry points of the port's paths: a fixture of PS credentials and the
three kinds of forged lane (verify, BASELINE config 2), a fixture of shown
credentials and the four kinds of forged show (show-verify, config 3), the
keys and messages of a threshold issuance (config 4; one user key pair, or
one a user for the issuance service), the issuance keys from a seeded
dealerless DKG instead (`keylife_fixture`), and the fused verify program
with example operands.

`fixture` draws from the same seeded sequence as the JAX package's
`__graft_entry__._fixture`, so one seed gives the same credentials in
both (under the default G1 assignment; under G2 the same draw multiplies
the other groups' generators). Credentials are signed with a master key
(the output shape of unblind + aggregate) and need no hash-to-curve.
"""

import contextlib
import functools
import random
import secrets

from .elgamal import elgamal_keygen
from .keygen import trusted_party_SSS_keygen
from .ops.fields import R
from .params import GroupContext, Params, SIGNATURES_IN_G1, Sigkey, Signature, Verkey
from .pok_vc import Proof as SchnorrProof
from .ps import PoKOfSignatureProof

MSG_COUNT = 6  # attributes per credential (BASELINE config 2)


def fixture(batch, msg_count=MSG_COUNT, seed=0xC0C0, ctx="G1"):
    """(params, sigkey, verkey, sigs, messages_list) for `batch` valid
    credentials over `msg_count` attributes, under the signature assignment
    `ctx` ("G1": g, sigma and h in G1, g_tilde and the verkey in G2; "G2":
    the reverse)."""
    return _credentials(random.Random(seed), batch, msg_count, GroupContext(ctx))


def _credentials(rng, batch, msg_count, ctx=SIGNATURES_IN_G1):
    params, sk, vk, sigs, msgs_list, _ = _credentials_and_logs(rng, batch, msg_count, ctx)
    return params, sk, vk, sigs, msgs_list


FIXED_BASE_MIN = 64  # from this many products on one base, its tables pay


class _FixedBase:
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


def _base_mul(group, p, uses):
    """A function k -> k * p, with tables when `uses` products pay for them."""
    if uses >= FIXED_BASE_MIN:
        return _FixedBase(group, p).mul
    return functools.partial(group.mul, p)


def _credentials_and_logs(rng, batch, msg_count, ctx):
    """_credentials, and each sigma_1's discrete log over params.g."""
    g = ctx.sig.mul(ctx.sig_gen, rng.randrange(1, R))
    g_tilde = ctx.other.mul(ctx.other_gen, rng.randrange(1, R))
    h = [ctx.sig.mul(ctx.sig_gen, rng.randrange(1, R)) for _ in range(msg_count)]
    params = Params(g, g_tilde, h, ctx)
    sk = Sigkey(
        rng.randrange(1, R), [rng.randrange(1, R) for _ in range(msg_count)]
    )
    vk = Verkey(
        ctx.other.mul(g_tilde, sk.x),
        [ctx.other.mul(g_tilde, y) for y in sk.y],
    )
    g_mul = _base_mul(ctx.sig, params.g, 2 * batch)
    sigs, msgs_list, ts = [], [], []
    for _ in range(batch):
        msgs = [rng.randrange(R) for _ in range(msg_count)]
        t = rng.randrange(1, R)
        expo = (sk.x + sum(y * m for y, m in zip(sk.y, msgs))) % R
        # sigma_2 = sigma_1 * expo, sigma_1 = g * t
        sigs.append(Signature(g_mul(t), g_mul(t * expo)))
        msgs_list.append(msgs)
        ts.append(t)
    return params, sk, vk, sigs, msgs_list, ts


FORGERIES = ("tampered_sigma_2", "wrong_message", "identity_sigma_1")


def forge(params, sigs, msgs_list, every=8):
    """Forge one lane in `every` (lanes every-1, 2*every-1, ...), cycling
    through the three kinds: sigma_2 doubled, the first message bumped by
    one, and an identity sigma_1 (both sigmas None). Returns new lists and
    the expected verdict per lane."""
    sigs, msgs_list = list(sigs), [list(m) for m in msgs_list]
    expect = [True] * len(sigs)
    for n, i in enumerate(range(every - 1, len(sigs), every)):
        kind = FORGERIES[n % len(FORGERIES)]
        if kind == "tampered_sigma_2":
            s = sigs[i]
            sigs[i] = Signature(s.sigma_1, params.ctx.sig.mul(s.sigma_2, 2))
        elif kind == "wrong_message":
            msgs_list[i][0] = (msgs_list[i][0] + 1) % R
        else:
            sigs[i] = Signature(None, None)
        expect[i] = False
    return sigs, msgs_list, expect


SHOW_REVEALED = (2, 3, 4, 5)  # BASELINE config 3: 2 hidden / 4 revealed


def show_fixture(batch, revealed=SHOW_REVEALED, seed=0xC0C0):
    """(params, sigkey, verkey, proofs, revealed_msgs_list, challenges):
    `batch` valid shows of fixture(batch, seed=seed)'s credentials, each
    revealing the attributes `revealed`.

    r, t, the blindings and the challenge c of each proof are drawn from the
    fixture's random sequence, after its credentials. The points are those
    the prover computes for them (sigma'_1 = sigma_1 * r, sigma'_2 =
    (sigma_2 + sigma_1 * t) * r, J = g_tilde * t + sum_hidden Y_tilde_j *
    m_j, the commitment sum_k base_k * b_k over [g_tilde, hidden Y_tilde]),
    computed with the signing key as discrete logs of the bases: two G1 and
    two G2 scalar multiplications a proof."""
    rng = random.Random(seed)
    params, sk, vk, _, msgs_list, sigma_logs = _credentials_and_logs(
        rng, batch, MSG_COUNT, SIGNATURES_IN_G1
    )
    ctx = params.ctx
    revealed = sorted(set(revealed))
    hidden = [i for i in range(MSG_COUNT) if i not in revealed]
    logs = [1] + [sk.y[i] for i in hidden]  # the bases over g_tilde
    g_mul = _base_mul(ctx.sig, params.g, 2 * batch)
    g_tilde_mul = _base_mul(ctx.other, params.g_tilde, 2 * batch)
    proofs, revealed_msgs_list, challenges = [], [], []
    for log_1, msgs in zip(sigma_logs, msgs_list):
        r = rng.randrange(1, R)
        t = rng.randrange(1, R)
        blindings = [rng.randrange(R) for _ in logs]
        c = rng.randrange(R)
        e = (sk.x + sum(y * m for y, m in zip(sk.y, msgs))) % R
        # sigma'_1 = sigma_1 * r, sigma'_2 = sigma'_1 * (e + t), over g
        log_s1 = log_1 * r % R
        secrets = [t] + [msgs[i] for i in hidden]
        J = g_tilde_mul(sum(a * s for a, s in zip(logs, secrets)))
        T = g_tilde_mul(sum(a * b for a, b in zip(logs, blindings)))
        responses = [(b - c * s) % R for b, s in zip(blindings, secrets)]
        proofs.append(PoKOfSignatureProof(
            g_mul(log_s1), g_mul(log_s1 * (e + t)), J, SchnorrProof(T, responses), revealed
        ))
        revealed_msgs_list.append({i: msgs[i] for i in revealed})
        challenges.append(c)
    return params, sk, vk, proofs, revealed_msgs_list, challenges


SHOW_FORGERIES = (
    "wrong_revealed_value", "corrupted_response", "doubled_sigma_prime_2",
    "identity_sigma_prime_1",
)


def forge_shows(params, proofs, revealed_msgs_list, every=8):
    """Forge one show in `every` (lanes every-1, 2*every-1, ...), cycling
    through the four kinds: the lowest revealed value bumped by one, the
    first Schnorr response bumped by one, sigma'_2 doubled, and an identity
    sigma'_1 (both sigma' None). Returns new lists and the expected verdict
    per lane."""
    proofs, rmsgs = list(proofs), [dict(m) for m in revealed_msgs_list]
    expect = [True] * len(proofs)
    for n, i in enumerate(range(every - 1, len(proofs), every)):
        kind = SHOW_FORGERIES[n % len(SHOW_FORGERIES)]
        p = proofs[i]
        s1, s2, vc = p.sigma_prime_1, p.sigma_prime_2, p.proof_vc
        if kind == "wrong_revealed_value":
            j = min(rmsgs[i])
            rmsgs[i][j] = (rmsgs[i][j] + 1) % R
        elif kind == "corrupted_response":
            vc = SchnorrProof(vc.t, [(vc.responses[0] + 1) % R] + vc.responses[1:])
        elif kind == "doubled_sigma_prime_2":
            s2 = params.ctx.sig.mul(s2, 2)
        else:
            s1 = s2 = None
        proofs[i] = PoKOfSignatureProof(s1, s2, p.J, vc, p.revealed_msg_indices)
        expect[i] = False
    return proofs, rmsgs, expect


ISSUANCE_HIDDEN = 2  # BASELINE config 4: 2 hidden of 6 attributes
ISSUANCE_THRESHOLD, ISSUANCE_SIGNERS = 3, 5


@contextlib.contextmanager
def seeded_draws(seed):
    """Every rand_fr (it calls secrets.randbelow) inside the block draws
    from random.Random(seed) instead of the OS CSPRNG: for fixtures and
    replays only."""
    saved = secrets.randbelow
    secrets.randbelow = random.Random(seed).randrange
    try:
        yield
    finally:
        secrets.randbelow = saved


def issue_fixture(batch, ctx="G1", seed=0x1550E, user_keys=False):
    """(params, signers, elgamal_sk, elgamal_pk, messages_list) of a
    threshold issuance: label-derived params (Params.new, 6 attributes),
    ISSUANCE_THRESHOLD-of-ISSUANCE_SIGNERS trusted-dealer keys and one user
    ElGamal key pair drawn from `seed`, and `batch` message vectors. With
    `user_keys`, elgamal_sk and elgamal_pk are lists of `batch` key pairs,
    one a user (the issuance service's orders), drawn after the shared
    pair, which the default keeps alone."""
    params = Params.new(MSG_COUNT, b"coconut-issue", GroupContext(ctx))
    with seeded_draws(seed):
        _, _, signers = trusted_party_SSS_keygen(ISSUANCE_THRESHOLD, ISSUANCE_SIGNERS, params)
        esk, epk = elgamal_keygen(params.ctx.sig, params.g)
        if user_keys:
            pairs = [elgamal_keygen(params.ctx.sig, params.g) for _ in range(batch)]
            esk, epk = [sk for sk, _ in pairs], [pk for _, pk in pairs]
    rng = random.Random(seed)
    msgs = [[rng.randrange(R) for _ in range(MSG_COUNT)] for _ in range(batch)]
    return params, signers, esk, epk, msgs


def keylife_fixture(seed=0x4B1F, tamper=None):
    """(params, manager, keyset): config 4 with no trusted dealer. A
    KeyLifecycleManager (window 3) over the issuance fixture's G1
    label-derived params (Params.new, 6 attributes) bootstraps epoch 1 by
    DKG (ISSUANCE_THRESHOLD-of-ISSUANCE_SIGNERS; `tamper` is run_dkg's
    fault hook) with every rand_fr drawn from `seed`, so a run's keys
    repeat. Later rounds (refresh, reshare) draw from the OS CSPRNG."""
    from .keylife import KeyLifecycleManager

    params = Params.new(MSG_COUNT, b"coconut-issue")
    mgr = KeyLifecycleManager(params, label=b"coconut-keylife")
    with seeded_draws(seed):
        keyset = mgr.bootstrap(ISSUANCE_THRESHOLD, ISSUANCE_SIGNERS, tamper=tamper)
    return params, mgr, keyset


def entry(batch=64, device=None):
    """(fn, operands): the fused batch verifier and example operands, as
    `__graft_entry__.entry()` hands out the JAX program. `fn(*operands)`
    returns one bool per credential on `device` (cuda by default)."""
    from .gpu.backend import TorchBackend, fused_verify

    params, _, vk, sigs, msgs_list = fixture(batch)
    be = TorchBackend(device=device)
    operands = be.encode_verify_batch(sigs, msgs_list, vk, params)
    fn = functools.partial(fused_verify, params.ctx.name == "G1")
    return fn, operands


def dryrun_multichip(n_devices, devices=None):
    """Shard the verify programs over an n-device (dp, tp) mesh and run one
    step each on small shapes, checking the bits against the host spec, as
    `__graft_entry__.dryrun_multichip` does for the JAX package: phase 1 the
    per-credential program on (dp = n/2, tp = 2) (tp = 1 for odd n), one
    lane a dp row with one forged; phase 2 the grouped program on (dp = n,
    tp = 1), accepting the honest batch and rejecting the forged one.

    `devices` defaults to the first n CUDA cards; pass one card n times
    (`[torch.device("cuda")] * n`) for logical shards on it. Prints a
    flushed progress line a phase."""
    import time

    import torch

    from .gpu.backend import TorchBackend
    from .gpu.shard import batch_verify_grouped_sharded, batch_verify_sharded, default_mesh
    from .ps import ps_verify

    t_start = time.time()

    def progress(msg):
        print("[dryrun_multichip +%.1fs] %s" % (time.time() - t_start, msg), flush=True)

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)[:n_devices]
    ntp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = default_mesh(ndp=n_devices // ntp, ntp=ntp, devices=devices)
    progress("devices=%d mesh=(dp=%d, tp=%d), building fixture"
             % (n_devices, n_devices // ntp, ntp))

    params, _, vk, sigs, msgs_list = fixture(n_devices)
    good_sigs = list(sigs)
    sigs = list(sigs)
    sigs[1] = Signature(sigs[1].sigma_1, params.ctx.sig.mul(sigs[1].sigma_2, 2))

    be = TorchBackend(device=devices[0])
    p1 = n_devices // ntp  # one lane a dp row
    progress("phase 1/2: dp+tp sharded per-credential verify (batch=%d)" % p1)
    bits = batch_verify_sharded(be, sigs[:p1], msgs_list[:p1], vk, params, mesh)
    want = [ps_verify(s, m, vk, params) for s, m in zip(sigs[:p1], msgs_list[:p1])]
    if bits != want:
        raise AssertionError("sharded bits %s, the spec's %s" % (bits, want))
    progress("phase 1/2 ok: bits match the spec path (incl. one forged)")

    gmesh = default_mesh(ndp=n_devices, ntp=1, devices=devices)
    progress("phase 2/2: dp-sharded grouped verify (dp=%d)" % n_devices)
    ok = batch_verify_grouped_sharded(
        be, good_sigs, msgs_list, vk, params, gmesh, pad_batch_to=n_devices
    )
    if ok is not True:
        raise AssertionError("sharded grouped verify rejected a valid batch")
    bad = batch_verify_grouped_sharded(
        be, sigs, msgs_list, vk, params, gmesh, pad_batch_to=n_devices
    )
    if bad is not False:
        raise AssertionError("sharded grouped verify accepted a forged batch")
    progress("phase 2/2 ok: grouped accept+reject both correct")
