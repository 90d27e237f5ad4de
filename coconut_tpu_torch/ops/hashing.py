"""Hashing to Fr — the port's host copy of the field half of the JAX
package's hashing spec (`coconut_tpu/ops/hashing.py`): RFC 9380 §5.3.1
expand_message_xmd with SHA-256, and 64 uniform bytes reduced mod r. The
Fiat-Shamir challenges of the show proofs are hash_to_fr of the proof
transcript (`signature.fiat_shamir_challenge`).
"""

import hashlib

from .fields import R

_HASH = hashlib.sha256
_B_IN_BYTES = 32
_R_IN_BYTES = 64

DST_FR = b"COCONUT-TPU-V2-FR"


def expand_message_xmd(msg, dst, len_in_bytes):
    """RFC 9380 §5.3.1 expand_message_xmd with SHA-256."""
    if len(dst) > 255:
        raise ValueError("DST longer than 255 bytes")
    ell = (len_in_bytes + _B_IN_BYTES - 1) // _B_IN_BYTES
    if ell > 255:
        raise ValueError("requested too many bytes")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * _R_IN_BYTES
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = _HASH(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = _HASH(b0 + b"\x01" + dst_prime).digest()
    blocks = [b1]
    for i in range(2, ell + 1):
        prev = blocks[-1]
        xored = bytes(x ^ y for x, y in zip(b0, prev))
        blocks.append(_HASH(xored + bytes([i]) + dst_prime).digest())
    return b"".join(blocks)[:len_in_bytes]


def hash_to_fr(msg, dst=DST_FR):
    """Arbitrary bytes -> a scalar in Fr."""
    u = expand_message_xmd(msg, dst, 64)
    return int.from_bytes(u, "big") % R
