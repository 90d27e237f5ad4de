"""The protocol entry of the batch checks — the port of `batch_verify` and
`batch_show_verify` of `coconut_tpu/ps.py`, over a batched backend
(`TorchBackend`).

mode="exact" returns the backend's per-lane verdicts. mode="batched" runs
the random-linear-combination check: ONE combined pairing product with ONE
shared final exponentiation for the whole batch and, only on a rejection,
a bisection ladder that names the forged lanes. Each sub-batch draws fresh
combiners from its own transcript, and a lone lane is a leaf (its single
combiner is invertible mod R, so the combined check of one lane is that
lane's exact check). All-valid batches give the exact mode's bits.

Where both halves of a rejected range pass (a <= 2^-lambda collision of
the parent draw), the reference settles the range with the spec's
`ps_verify` / `proof.verify`; the port settles it with the backend's exact
path over that range (`batch_verify` / `batch_show_verify`). The bits are
equal.

The port has no Fiat-Shamir and no spec prover yet: `challenges` is
required, and a show batch must share one revealed-index set.

The refusals the reference raises as `PSError` (batch-size mismatches, an
unknown mode, revealed messages that do not match a proof) raise the
port's `errors.PSError`, of the same name and code. A batch that mixes
revealed-index sets, which the reference verifies proof by proof, raises
ValueError.
"""

from .errors import PSError

MODES = ("exact", "batched")


def _check_mode(mode):
    if mode not in MODES:
        raise PSError("unknown verify mode %r" % (mode,))


def batch_verify(sigs, messages_list, vk, params, backend, mode="exact", epoch=None):
    """One bool per credential of a batch under one verkey. `epoch` (the
    key epoch) joins the combiners' domain separation in batched mode."""
    if len(sigs) != len(messages_list):
        raise PSError(
            "batch size mismatch: %d sigs, %d message vectors"
            % (len(sigs), len(messages_list))
        )
    _check_mode(mode)
    if mode == "exact":
        return backend.batch_verify(sigs, messages_list, vk, params)

    def combined(lo, hi):
        return backend.batch_verify_combined(
            sigs[lo:hi], messages_list[lo:hi], vk, params, epoch=epoch
        )

    def exact(lo, hi):
        return backend.batch_verify(sigs[lo:hi], messages_list[lo:hi], vk, params)

    B = len(sigs)
    bits = [True] * B
    if B == 0 or combined(0, B):
        return bits
    _bisect(combined, exact, bits, 0, B)
    return bits


def _bisect(combined, exact, bits, lo, hi):
    """The ladder under a rejected range [lo, hi): halves checked with fresh
    combiners, a lone lane a leaf, and a range whose halves both pass
    settled by the exact path. `combined(lo, hi)` returns the range's
    pairing bool; `bits` is set to False at each culprit."""
    if hi - lo == 1:
        bits[lo] = False
        return
    mid = (lo + hi) // 2
    left_ok = combined(lo, mid)
    right_ok = combined(mid, hi)
    if left_ok and right_ok:
        bits[lo:hi] = exact(lo, hi)
        return
    if not left_ok:
        _bisect(combined, exact, bits, lo, mid)
    if not right_ok:
        _bisect(combined, exact, bits, mid, hi)


def batch_show_verify(
    proofs, vk, params, revealed_msgs_list, challenges, backend, mode="exact",
    epoch=None,
):
    """One bool per shown credential (BASELINE config 3). In batched mode
    the Schnorr check stays per lane and the B pairing checks fold into one
    combined product; a lane's verdict is its Schnorr bit and its pairing
    bit. Dead lanes (identity sigma') fail through their Schnorr bit and
    never enter the fold or the ladder."""
    if len(proofs) != len(revealed_msgs_list):
        raise PSError(
            "batch size mismatch: %d proofs, %d revealed maps"
            % (len(proofs), len(revealed_msgs_list))
        )
    _check_mode(mode)
    if len(challenges) != len(proofs):
        raise PSError(
            "batch size mismatch: %d proofs, %d challenges"
            % (len(proofs), len(challenges))
        )
    for p, rm in zip(proofs, revealed_msgs_list):
        if set(rm.keys()) != p.revealed_msg_indices:
            raise PSError("revealed messages do not match proof's indices")
    if any(p.revealed_msg_indices != proofs[0].revealed_msg_indices for p in proofs):
        raise ValueError(
            "the batch mixes revealed-index sets; the port verifies one set "
            "a batch"
        )
    if mode == "exact":
        return backend.batch_show_verify(
            proofs, vk, params, revealed_msgs_list, challenges
        )

    def combined(lo, hi):
        return backend.batch_show_verify_combined(
            proofs[lo:hi], vk, params, revealed_msgs_list[lo:hi],
            challenges[lo:hi], epoch=epoch,
        )[1]

    def exact(lo, hi):
        # the full exact verdicts; the Schnorr half is known, so they
        # settle the pairing half
        return backend.batch_show_verify(
            proofs[lo:hi], vk, params, revealed_msgs_list[lo:hi], challenges[lo:hi]
        )

    B = len(proofs)
    if B == 0:
        return []
    schnorr, pair_ok = backend.batch_show_verify_combined(
        proofs, vk, params, revealed_msgs_list, challenges, epoch=epoch
    )
    pair_bits = [True] * B
    if not pair_ok:
        _bisect(combined, exact, pair_bits, 0, B)
    return [bool(s) and bool(p) for s, p in zip(schnorr, pair_bits)]
