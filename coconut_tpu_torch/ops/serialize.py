"""Canonical byte encodings the combined checks' transcripts absorb — a host
copy of the encoders of `coconut_tpu/ops/serialize.py` and of the wire
layouts of a verkey, a signature and a shown credential
(`coconut_tpu/signature.py`, `ps.py`, `pok_vc.py`).

  - Fr: 32 bytes big-endian; Fp: 48 bytes big-endian.
  - Fp2 (c0 + c1*u): c0 || c1 (96 bytes).
  - G1 point: 96 bytes uncompressed x || y; G2 point: 192 bytes; the
    identity (None) is all zero bytes.

Objects are read by their fields (duck typing), so the port's holders and
the JAX package's own objects give the same bytes. The decoders the request
proof's `from_bytes` needs (Fr, Fp, Fp2 and uncompressed G1 / G2 points)
validate as the reference's do: field elements below their modulus, points
on the curve and in the r-torsion subgroup; every refusal raises
`DeserializationError`. Compressed points (48 / 96 bytes, ZCash-style
flag bits in the top three bits of the first byte: compr | infinity |
y-sign) decode with the same checks.
"""

from ..errors import DeserializationError
from .curve import g1, g2
from .fields import (
    P,
    R,
    fp2_add,
    fp2_mul,
    fp2_sgn0,
    fp2_sq,
    fp2_sqrt,
    fp_sgn0,
    fp_sqrt,
)


def fr_to_bytes(a):
    return int(a % R).to_bytes(32, "big")


def fr_from_bytes(b):
    if len(b) != 32:
        raise DeserializationError("Fr must be 32 bytes, got %d" % len(b))
    v = int.from_bytes(b, "big")
    if v >= R:
        raise DeserializationError("non-canonical Fr encoding")
    return v


def fp_to_bytes(a):
    return int(a % P).to_bytes(48, "big")


def fp_from_bytes(b):
    if len(b) != 48:
        raise DeserializationError("Fp must be 48 bytes, got %d" % len(b))
    v = int.from_bytes(b, "big")
    if v >= P:
        raise DeserializationError("non-canonical Fp encoding")
    return v


def fp2_to_bytes(c):
    return fp_to_bytes(c[0]) + fp_to_bytes(c[1])


def fp2_from_bytes(b):
    if len(b) != 96:
        raise DeserializationError("Fp2 must be 96 bytes, got %d" % len(b))
    return (fp_from_bytes(b[:48]), fp_from_bytes(b[48:]))


def g1_to_bytes(p):
    if p is None:
        return b"\x00" * 96
    return fp_to_bytes(p[0]) + fp_to_bytes(p[1])


def g1_from_bytes(b):
    if len(b) != 96:
        raise DeserializationError("G1 must be 96 bytes, got %d" % len(b))
    if b == b"\x00" * 96:
        return None
    p = (fp_from_bytes(b[:48]), fp_from_bytes(b[48:]))
    if not g1.in_subgroup(p):
        raise DeserializationError("G1 point not in the r-torsion subgroup")
    return p


def g1_to_compressed(p):
    if p is None:
        return bytes([0xC0]) + b"\x00" * 47
    flags = 0x80 | (0x20 if fp_sgn0(p[1]) else 0)
    raw = bytearray(fp_to_bytes(p[0]))
    raw[0] |= flags
    return bytes(raw)


def g1_from_compressed(b):
    if len(b) != 48:
        raise DeserializationError("compressed G1 must be 48 bytes")
    flags = b[0] & 0xE0
    if not flags & 0x80:
        raise DeserializationError("compression flag not set")
    if flags & 0x40:
        if b != bytes([0xC0]) + b"\x00" * 47:
            raise DeserializationError("malformed G1 identity encoding")
        return None
    raw = bytearray(b)
    raw[0] &= 0x1F
    x = fp_from_bytes(bytes(raw))
    y = fp_sqrt((x * x % P * x + 4) % P)
    if y is None:
        raise DeserializationError("x not on curve")
    if fp_sgn0(y) != (1 if flags & 0x20 else 0):
        y = P - y
    p = (x, y)
    if not g1.in_subgroup(p):
        raise DeserializationError("G1 point not in the r-torsion subgroup")
    return p


def g2_to_bytes(p):
    if p is None:
        return b"\x00" * 192
    return fp2_to_bytes(p[0]) + fp2_to_bytes(p[1])


def g2_from_bytes(b):
    if len(b) != 192:
        raise DeserializationError("G2 must be 192 bytes, got %d" % len(b))
    if b == b"\x00" * 192:
        return None
    p = (fp2_from_bytes(b[:96]), fp2_from_bytes(b[96:]))
    if not g2.in_subgroup(p):
        raise DeserializationError("G2 point not in the r-torsion subgroup")
    return p


def g2_to_compressed(p):
    if p is None:
        return bytes([0xC0]) + b"\x00" * 95
    flags = 0x80 | (0x20 if fp2_sgn0(p[1]) else 0)
    raw = bytearray(fp2_to_bytes(p[0]))
    raw[0] |= flags
    return bytes(raw)


def g2_from_compressed(b):
    if len(b) != 96:
        raise DeserializationError("compressed G2 must be 96 bytes")
    flags = b[0] & 0xE0
    if not flags & 0x80:
        raise DeserializationError("compression flag not set")
    if flags & 0x40:
        if b != bytes([0xC0]) + b"\x00" * 95:
            raise DeserializationError("malformed G2 identity encoding")
        return None
    raw = bytearray(b)
    raw[0] &= 0x1F
    x = fp2_from_bytes(bytes(raw))
    y = fp2_sqrt(fp2_add(fp2_mul(fp2_sq(x), x), (4, 4)))
    if y is None:
        raise DeserializationError("x not on curve")
    if fp2_sgn0(y) != (1 if flags & 0x20 else 0):
        y = ((P - y[0]) % P, (P - y[1]) % P)
    p = (x, y)
    if not g2.in_subgroup(p):
        raise DeserializationError("G2 point not in the r-torsion subgroup")
    return p


def _encoders(ctx):
    """(signature group, other group) point encoders of a group context,
    by its name: "G1" puts signatures in G1, "G2" in G2."""
    if ctx.name == "G1":
        return g1_to_bytes, g2_to_bytes
    return g2_to_bytes, g1_to_bytes


def verkey_to_bytes(vk, ctx):
    """X_tilde || Y_tilde_1 || ... (`Verkey.to_bytes`)."""
    _, other = _encoders(ctx)
    return b"".join([other(vk.X_tilde)] + [other(y) for y in vk.Y_tilde])


def signature_to_bytes(sig, ctx):
    """sigma_1 || sigma_2 (`Signature.to_bytes`)."""
    sig_enc, _ = _encoders(ctx)
    return sig_enc(sig.sigma_1) + sig_enc(sig.sigma_2)


def schnorr_proof_to_bytes(proof_vc, elem_to_bytes):
    """t || count (4 bytes) || responses, 32 bytes each and not reduced
    (`pok_vc.Proof.to_bytes`)."""
    out = [elem_to_bytes(proof_vc.t), len(proof_vc.responses).to_bytes(4, "big")]
    out.extend(r.to_bytes(32, "big") for r in proof_vc.responses)
    return b"".join(out)


def show_proof_to_bytes(proof, ctx):
    """sigma'_1 || sigma'_2 || J || Schnorr proof || count (4 bytes) ||
    sorted revealed indices, 4 bytes each (`PoKOfSignatureProof.to_bytes`)."""
    sig_enc, other = _encoders(ctx)
    shown = sorted(proof.revealed_msg_indices)
    out = [
        sig_enc(proof.sigma_prime_1),
        sig_enc(proof.sigma_prime_2),
        other(proof.J),
        schnorr_proof_to_bytes(proof.proof_vc, other),
        len(shown).to_bytes(4, "big"),
    ]
    out.extend(i.to_bytes(4, "big") for i in shown)
    return b"".join(out)
