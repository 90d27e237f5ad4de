"""Carry the JAX side's state across to the port.

`operands_from_numpy(tree, device)` maps the operand tuple of the JAX
package's `encode_verify_batch`, `encode_show_verify_batch` or
`encode_grouped_batch` (comb tables, digits, points, g_tilde, identity
masks), each leaf taken as a numpy array, to tensors of the same dtype and
shape on `device`. Fed to `gpu.backend.fused_verify`, `fused_show_verify`
or `fused_verify_grouped`, they let a test run both fused programs on
identical operands.

The issuance converters take the JAX package's holders by their fields
(no import of that package) and return the port's: `params_from`,
`sigkey_from`, `verkey_from`, `signer_from` (a threshold signer's share of
the key), `signature_from`, `request_from` (a SignatureRequest, its cached
h kept) and `blind_signature_from`. ElGamal keys are an int and a point,
the same objects in both packages. Tests feed both packages the same state
through them. `keyset_from` carries a reference keylife.KeySet across
(signers, verkey, epoch, gen, threshold, QUAL and excluded).
"""

import numpy as np
import torch

from .keygen import Signer
from .keylife.epoch import KeySet
from .params import GroupContext, Params
from .signature import BlindSignature, Sigkey, Signature, SignatureRequest, Verkey


def operands_from_numpy(tree, device):
    """Nested tuples of array-likes -> the same nesting of tensors on
    `device` (dtype and shape kept)."""
    if isinstance(tree, (tuple, list)):
        return tuple(operands_from_numpy(t, device) for t in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def params_from(p):
    return Params(p.g, p.g_tilde, p.h, GroupContext(p.ctx.name))


def sigkey_from(sk):
    return Sigkey(sk.x, sk.y)


def verkey_from(vk):
    return Verkey(vk.X_tilde, vk.Y_tilde)


def signer_from(s):
    return Signer(s.id, sigkey_from(s.sigkey), verkey_from(s.verkey))


def signature_from(sig):
    return Signature(sig.sigma_1, sig.sigma_2)


def request_from(req):
    out = SignatureRequest(req.known_messages, req.commitment, req.ciphertexts)
    out._h_cache = req._h_cache
    return out


def blind_signature_from(bs):
    return BlindSignature(bs.h, bs.blinded)


def keyset_from(ks):
    return KeySet(
        ks.epoch,
        ks.gen,
        ks.threshold,
        [signer_from(s) for s in ks.signers],
        verkey_from(ks.vk) if ks.vk is not None else None,
        qual=ks.qual,
        excluded=ks.excluded,
    )
