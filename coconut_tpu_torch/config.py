"""FrameworkConfig — the single explicit configuration struct, the port of
`coconut_tpu/config.py` with its fields and env overrides.

Group assignment is a runtime value (GroupContext, params.py) and the
execution knobs live here. `resolve_backend()` is the one place a backend
name becomes an instance (backend.get_backend's registry); `make_mesh()`
builds a gpu/shard.py mesh over the CUDA cards.

Env overrides (useful for benches/CI): COCONUT_BACKEND, COCONUT_BATCH.
By the port's rules the backend defaults to "torch" (a TorchBackend on
`cuda`), where the reference's defaults to its host spec ("python").
"""

import os
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class FrameworkConfig:
    # protocol shape
    msg_count: int = 6
    threshold: int = 3
    total_signers: int = 5
    count_hidden: int = 2
    label: bytes = b"coconut-tpu"
    # group assignment: "G1" = signatures in G1 (the default)
    signature_group: str = "G1"
    # execution
    backend: str = field(
        default_factory=lambda: os.environ.get("COCONUT_BACKEND", "torch")
    )
    batch_size: int = field(
        default_factory=lambda: int(os.environ.get("COCONUT_BATCH", "1024"))
    )
    # mesh shape (dp, tp) for the sharded path (gpu/shard.py); None = one
    # device
    mesh_shape: Optional[Tuple[int, int]] = None

    def group_context(self):
        from .params import SIGNATURES_IN_G1, SIGNATURES_IN_G2

        if self.signature_group == "G1":
            return SIGNATURES_IN_G1
        if self.signature_group == "G2":
            return SIGNATURES_IN_G2
        raise ValueError("signature_group must be 'G1' or 'G2'")

    def make_params(self):
        from .params import Params

        return Params.new(self.msg_count, self.label, ctx=self.group_context())

    def resolve_backend(self):
        from .backend import get_backend

        return get_backend(self.backend)

    def make_mesh(self):
        if self.mesh_shape is None:
            return None
        from .gpu.shard import default_mesh

        ndp, ntp = self.mesh_shape
        return default_mesh(ndp=ndp, ntp=ntp)
