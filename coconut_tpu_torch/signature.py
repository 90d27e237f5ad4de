"""The challenge convention of the protocol — the port's copy of
`fiat_shamir_challenge` of `coconut_tpu/signature.py` (the issuance half of
that module is not part of the port)."""

from .ops.hashing import hash_to_fr


def fiat_shamir_challenge(transcript_bytes):
    """Hash a proof-of-knowledge transcript to Fr."""
    return hash_to_fr(transcript_bytes)
