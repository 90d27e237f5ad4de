"""Online DKG and proactive refresh rounds — the port's copy of
`coconut_tpu/keylife/dkg.py`.

  run_dkg      Gennaro-style DKG: every authority deals a Pedersen-VSS
               sharing of a fresh random secret per key dimension (1 for x,
               one per attribute for the y's); recipients verify each share
               against the dealer's coefficient commitments and complain,
               naming the dealer exactly, on mismatch. Complained-against
               and unreachable dealers are excluded and the key is the sum
               over the QUAL set only; fewer than `threshold` qualified
               dealers abort with the retryable DkgAbortedError. No code
               path reconstructs the master secret: per-recipient share sums
               are the only aggregation.

  run_refresh  Herzberg-style proactive refresh: every dealer deals a
               verifiable sharing of zero (PedersenVSS.deal_zero) and
               publishes its degree-0 blinding, so recipients check the
               zero opening comm[0] == h^{b0} as well as the share. New
               share = old share + sum of zero shares: every share changes,
               the secret (and the aggregated verkey, byte for byte) does
               not.

A t/n-changing reshare is run_dkg with the new parameters: a fresh secret
under a fresh epoch. Transport is synchronous and in-process; the
`unreachable` and `tamper` hooks inject faults deterministically. The draws
(rand_fr) come in the reference's order, so a seeded sequence gives the
same shares in both packages.
"""

from collections import namedtuple

from ..errors import DkgAbortedError, ShareVerificationError
from ..keygen import keygen_from_shares
from ..ops.fields import R
from ..sss import PedersenVSS

#: Outcome of a DKG or refresh round: per-signer key material (inside the
#: Signer objects) and the dealer audit trail, never a secret aggregate.
DkgResult = namedtuple(
    "DkgResult",
    ["signers", "qual", "excluded", "complaints", "threshold", "total"],
)


def _maybe_tamper(tamper, dealer_id, recipient_id, dim, share):
    if tamper is None:
        return share
    out = tamper(dealer_id, recipient_id, dim, share)
    return share if out is None else out


def _qualified(all_ids, unreachable, complaints, threshold):
    """(complaints as sorted tuples, QUAL, excluded); raises DkgAbortedError
    when fewer than `threshold` dealers qualify."""
    complaints = {d: tuple(sorted(rs)) for d, rs in complaints.items()}
    excluded = unreachable | set(complaints)
    qual = [i for i in all_ids if i not in excluded]
    if len(qual) < threshold:
        raise DkgAbortedError(threshold, len(qual), excluded=excluded)
    return complaints, qual, excluded


def run_dkg(threshold, total, params, g, h, round="dkg",
            unreachable=(), tamper=None):
    """One full DKG round over `1 + params.msg_count()` key dimensions.

    `unreachable`: dealer ids that never deal. `tamper(dealer_id,
    recipient_id, dim, (s, t))`: fault hook returning a replacement share
    for that one delivery (None = honest). Returns a DkgResult whose
    signers hold shares of the summed QUAL secret."""
    dims = 1 + params.msg_count()
    unreachable = set(unreachable)
    all_ids = list(range(1, total + 1))
    dealers = [i for i in all_ids if i not in unreachable]

    # deal: every reachable dealer commits one sharing per dimension
    deals = {}  # dealer_id -> [(comm_coeffs, s_shares, t_shares)] per dim
    for d in dealers:
        deals[d] = [
            PedersenVSS.deal(threshold, total, g, h)[2:] for _ in range(dims)
        ]

    # verify: each recipient checks every delivered share; a failed check
    # is a complaint naming that dealer
    complaints = {}  # dealer_id -> recipient ids
    for d in dealers:
        for r in all_ids:
            for dim in range(dims):
                comm, s_shares, t_shares = deals[d][dim]
                share = _maybe_tamper(tamper, d, r, dim, (s_shares[r], t_shares[r]))
                try:
                    PedersenVSS.check_share(
                        threshold, r, share, comm, g, h, dealer_id=d, round=round,
                    )
                except ShareVerificationError:
                    complaints.setdefault(d, set()).add(r)
                else:
                    deals[d][dim] = (comm, dict(s_shares), t_shares)
                    deals[d][dim][1][r] = share[0]
    complaints, qual, excluded = _qualified(
        all_ids, unreachable, complaints, threshold
    )

    # key derivation: per-recipient sums over QUAL dealers only; every
    # authority 1..total receives shares (an excluded dealer still serves
    # as a recipient)
    def summed(dim):
        return {r: sum(deals[d][dim][1][r] for d in qual) % R for r in all_ids}

    x_shares = summed(0)
    y_shares = [summed(1 + j) for j in range(dims - 1)]
    signers = keygen_from_shares(total, x_shares, y_shares, params)
    return DkgResult(
        signers=signers,
        qual=tuple(qual),
        excluded=tuple(sorted(excluded)),
        complaints=complaints,
        threshold=threshold,
        total=total,
    )


def run_refresh(signers, threshold, params, g, h, round="refresh",
                unreachable=(), tamper=None):
    """One proactive refresh round over an existing sharing: every
    reachable authority deals a zero-sharing per dimension and publishes
    its degree-0 blinding; recipients enforce the share check and the zero
    opening. New share_i = old share_i + sum over QUAL of zero share_i. Same
    hooks and abort as run_dkg; the new signers' verkeys aggregate to the
    same verkey."""
    dims = 1 + params.msg_count()
    total = len(signers)
    by_id = {s.id: s for s in signers}
    unreachable = set(unreachable)
    all_ids = sorted(by_id)
    dealers = [i for i in all_ids if i not in unreachable]
    ops = PedersenVSS.ops

    deals = {}  # dealer_id -> [(blind0, comm_coeffs, s_shares, t_shares)]
    for d in dealers:
        deals[d] = [
            PedersenVSS.deal_zero(threshold, total, g, h) for _ in range(dims)
        ]

    complaints = {}
    for d in dealers:
        for r in all_ids:
            for dim in range(dims):
                blind0, comm, s_shares, t_shares = deals[d][dim]
                share = _maybe_tamper(tamper, d, r, dim, (s_shares[r], t_shares[r]))
                ok = comm[0] == ops.mul(h, blind0)
                if ok:
                    try:
                        PedersenVSS.check_share(
                            threshold, r, share, comm, g, h, dealer_id=d, round=round,
                        )
                    except ShareVerificationError:
                        ok = False
                if not ok:
                    complaints.setdefault(d, set()).add(r)
                else:
                    deals[d][dim] = (blind0, comm, dict(s_shares), t_shares)
                    deals[d][dim][2][r] = share[0]
    complaints, qual, excluded = _qualified(
        all_ids, unreachable, complaints, threshold
    )

    def delta(dim):
        return {r: sum(deals[d][dim][2][r] for d in qual) % R for r in all_ids}

    dx = delta(0)
    x_shares = {r: (by_id[r].sigkey.x + dx[r]) % R for r in all_ids}
    y_shares = []
    for j in range(dims - 1):
        dy = delta(1 + j)
        y_shares.append({r: (by_id[r].sigkey.y[j] + dy[r]) % R for r in all_ids})
    new_signers = keygen_from_shares(total, x_shares, y_shares, params)
    return DkgResult(
        signers=new_signers,
        qual=tuple(qual),
        excluded=tuple(sorted(excluded)),
        complaints=complaints,
        threshold=threshold,
        total=total,
    )
