"""The least time an H100 could take for the field kernel `fp_mul` (the
Montgomery product of 52-limb operands), frozen for the benchmark: a copy
of the arithmetic of `coconut_tpu_torch.bench_fp_mul.bound()`.

Per lane the kernel reads two operand rows and writes one (3 x 52 float32
limbs, 624 bytes) and needs 6,786 multiply-adds: 52 x 52 for a * b, 52 x
53 / 2 for the low half of the product by N', 52 x 52 for the product by
p. Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit:
3.35 TB/s of HBM and 67 TFLOP/s of float32 outside the tensor cores.
"""

NLIMBS = 52
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FMA_PER_LANE = NLIMBS * NLIMBS + NLIMBS * (NLIMBS + 1) // 2 + NLIMBS * NLIMBS
BYTES_PER_LANE = 3 * NLIMBS * 4


def bound(lanes):
    """{bound_ms, bytes_ms, ops_ms, bound_by} for one launch of `lanes`
    lanes: bytes over the memory rate, multiply-adds (2 operations each)
    over the float32 rate, the larger of the two."""
    bytes_ms = BYTES_PER_LANE * lanes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * FMA_PER_LANE * lanes / FP32_FLOP_PER_S * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bytes_ms": bytes_ms,
        "ops_ms": ops_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def bound_s(widths):
    """The bound summed over launches, in seconds: `widths` maps a launch's
    lanes to how many launches had that many."""
    return sum(bound(n)["bound_ms"] * k for n, k in widths.items()) / 1e3
