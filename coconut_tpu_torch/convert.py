"""Carry the JAX side's encoded operands across to the port.

`operands_from_numpy(tree, device)` maps the operand tuple of the JAX
package's `encode_verify_batch`, `encode_show_verify_batch` or
`encode_grouped_batch` (comb tables, digits, points, g_tilde, identity
masks), each leaf taken as a numpy array, to tensors of the same dtype and
shape on `device`. Fed to `gpu.backend.fused_verify`, `fused_show_verify`
or `fused_verify_grouped`, they let a test run both fused programs on
identical operands.
"""

import numpy as np
import torch


def operands_from_numpy(tree, device):
    """Nested tuples of array-likes -> the same nesting of tensors on
    `device` (dtype and shape kept)."""
    if isinstance(tree, (tuple, list)):
        return tuple(operands_from_numpy(t, device) for t in tree)
    return torch.from_numpy(np.array(tree)).to(device)
