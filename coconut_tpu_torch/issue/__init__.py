"""Threshold-issuance service of the port — module for module after
`coconut_tpu/issue/`: quorum fan-out over a signing-authority pool,
first-t-of-n Lagrange aggregation, and straggler-hedged minting.

The issuance-side sibling of serve/ (which VERIFIES minted
credentials online): clients submit blind-sign requests, the service
fans each coalesced batch to every live authority, resolves on the first
t partial signatures, and releases only credentials that verify under
the subset's aggregated verkey. See issue/service.py for the design.

    from coconut_tpu_torch.issue import IssuanceService

    svc = IssuanceService(signers, params, threshold=3).start()  # cuda
    fut = svc.submit(sig_request, messages, elgamal_sk)
    credential = fut.result(timeout=5.0)   # a verified Signature
    svc.drain()
"""

from .authority import SigningAuthority
from .hedge import HedgePolicy, HedgeScheduler
from .quorum import CryptoMinter, Fanout, QuorumTracker
from .service import IssuanceOrder, IssuanceService

__all__ = [
    "CryptoMinter",
    "Fanout",
    "HedgePolicy",
    "HedgeScheduler",
    "IssuanceOrder",
    "IssuanceService",
    "QuorumTracker",
    "SigningAuthority",
]
