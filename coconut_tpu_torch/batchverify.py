"""Random-linear-combination (RLC) batch verification: the combiner
exponents and the transcripts they are drawn from — a copy of
`coconut_tpu/batchverify.py`, with the same domain tags, so the port draws
the same r_i as the JAX package for the same batch.

B pairing checks e(sigma1_i, acc_i) * e(-sigma2_i, g_tilde) == 1 collapse,
under per-lane exponents r_i, into one product

    prod_i e(r_i * sigma1_i, acc_i) * e(sum_i r_i * (-sigma2_i), g_tilde) == 1

with one shared final exponentiation. A forged lane survives only if its
pairing defect cancels under the r_i: probability <= 2^-lambda for a batch
fixed before the draw. The r_i come DETERMINISTICALLY from a
domain-separated SHA-256 of the batch transcript, which commits to every
signature, message, verkey byte and the key epoch, so a forger chooses
before the exponents exist (Fiat-Shamir applied to the batch check), and
runs replay bit for bit.

lambda is COCONUT_BATCH_LAMBDA: default 128, at least 64, at most 128 (the
combined programs' digit schedule carries 128-bit exponents).
COCONUT_BATCH_VERIFY (`env_batched_default`) puts new services on mode
"batched".
"""

import hashlib
import os

from .ops.fields import R
from .ops.serialize import show_proof_to_bytes, signature_to_bytes, verkey_to_bytes

DEFAULT_LAMBDA = 128
MIN_LAMBDA = 64
MAX_LAMBDA = 128

_DOMAIN_VERIFY = b"coconut-tpu/batchverify/v1/verify"
_DOMAIN_SHOW = b"coconut-tpu/batchverify/v1/show"


def batch_lambda():
    """The soundness parameter from COCONUT_BATCH_LAMBDA (default 128);
    ValueError outside [MIN_LAMBDA, MAX_LAMBDA]."""
    raw = os.environ.get("COCONUT_BATCH_LAMBDA")
    if raw is None:
        return DEFAULT_LAMBDA
    return _check_lambda(int(raw))


def env_batched_default():
    """True when COCONUT_BATCH_VERIFY selects the batched (RLC combined)
    verify path by default — the serve mode knob. Accepts "1", "true",
    "on", "yes" or "batched" (any case); anything else, unset included,
    keeps the exact per-lane default."""
    raw = os.environ.get("COCONUT_BATCH_VERIFY", "")
    return raw.strip().lower() in ("1", "true", "on", "yes", "batched")


def _check_lambda(lam):
    if not MIN_LAMBDA <= lam <= MAX_LAMBDA:
        raise ValueError(
            "COCONUT_BATCH_LAMBDA must be in [%d, %d] (got %r)"
            % (MIN_LAMBDA, MAX_LAMBDA, lam)
        )
    return lam


def derive_combiners(transcript, n, lam=None, domain=_DOMAIN_VERIFY):
    """n deterministic nonzero combiners r_i in [1, 2^lam - 1]: SHA-256 in
    counter mode over a seed that commits to the domain tag, lam and the
    transcript; r_i = (block_i mod (2^lam - 1)) + 1, a pure function of
    (seed, i)."""
    lam = batch_lambda() if lam is None else _check_lambda(lam)
    seed = hashlib.sha256(domain + b"|" + bytes([lam]) + b"|" + transcript).digest()
    span = (1 << lam) - 1
    out = []
    for i in range(n):
        block = hashlib.sha256(seed + i.to_bytes(8, "big")).digest()
        out.append(int.from_bytes(block, "big") % span + 1)
    return out


def _absorb(h, tag, data):
    """Length-prefixed absorption: adjacent fields cannot run together."""
    h.update(tag)
    h.update(len(data).to_bytes(4, "big"))
    h.update(data)


def _absorb_epoch(h, epoch):
    if epoch is None:
        h.update(b"E\x00")
    else:
        h.update(b"E\x01")
        h.update(int(epoch).to_bytes(8, "big"))


def verify_transcript(sigs, messages_list, vk, params, epoch=None):
    """Transcript digest of a combined verify: the verkey, the key epoch,
    and every lane's signature and messages."""
    ctx = params.ctx
    h = hashlib.sha256()
    _absorb(h, b"D", _DOMAIN_VERIFY)
    _absorb_epoch(h, epoch)
    _absorb(h, b"K", verkey_to_bytes(vk, ctx))
    h.update(len(sigs).to_bytes(4, "big"))
    for sig, msgs in zip(sigs, messages_list):
        _absorb(h, b"S", signature_to_bytes(sig, ctx))
        h.update(len(msgs).to_bytes(4, "big"))
        for m in msgs:
            h.update((m % R).to_bytes(32, "big"))
    return h.digest()


def show_transcript(proofs, vk, params, revealed_msgs_list, challenges, epoch=None):
    """Transcript digest of a combined show verify: the verkey, the key
    epoch, and every proof's wire bytes (an identity sigma' as zero
    bytes), its revealed messages by sorted index and its challenge."""
    ctx = params.ctx
    h = hashlib.sha256()
    _absorb(h, b"D", _DOMAIN_SHOW)
    _absorb_epoch(h, epoch)
    _absorb(h, b"K", verkey_to_bytes(vk, ctx))
    h.update(len(proofs).to_bytes(4, "big"))
    for proof, revealed, chal in zip(proofs, revealed_msgs_list, challenges):
        _absorb(h, b"P", show_proof_to_bytes(proof, ctx))
        items = sorted(revealed.items())
        h.update(len(items).to_bytes(4, "big"))
        for idx, m in items:
            h.update(int(idx).to_bytes(4, "big"))
            h.update((m % R).to_bytes(32, "big"))
        h.update((chal % R).to_bytes(32, "big"))
    return h.digest()
