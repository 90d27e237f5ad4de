"""coconut_tpu_torch — the PyTorch/CUDA port of coconut_tpu.

The JAX package (`coconut_tpu/`) is the reference; this package mirrors its
layout and names and imports nothing from it:

  ops/     host copies of the spec field and curve ops (Python ints)
  gpu/     the device layer, module for module after coconut_tpu/tpu/:
           limbs, fp (+ cuda_fp: the CUDA Montgomery kernel and its plain
           PyTorch version), tower, curve, pairing, backend (TorchBackend)
  csrc/    CUDA C++ sources, built with nvcc into build/ at first use
  params.py, entry.py, convert.py
           data holders, the verify and show-verify fixtures and the entry
           point, and the bridge that carries JAX-encoded operands across
           for differential tests
  ps.py, batchverify.py, errors.py
           the protocol layer's batch checks and ladders, their combiners,
           and the PSError they raise

Entry points run on `cuda` unless the caller passes device="cpu".
"""
