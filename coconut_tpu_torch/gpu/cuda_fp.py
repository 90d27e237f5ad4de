"""The Montgomery multiply as a hand-written CUDA kernel, its wrapper and its
plain PyTorch version — the counterpart of `coconut_tpu/tpu/pallas_fp.py`.

`mul(a, b)` is the wrapper `fp.mul` calls. For CUDA tensors it launches
`csrc/fp_mul.cu` (built with nvcc into the repository's `build/` directory
at first use and loaded with ctypes); for CPU tensors it runs `mul_plain`,
the same function in PyTorch. Nothing falls back: a CUDA tensor goes to the
kernel or raises. `LAUNCHES` counts kernel launches and `PLAIN_CALLS`
counts calls of the plain version, so a run can show which one it took;
`LAUNCH_WIDTHS` counts the launches by their number of lanes (a CUDA
graph's replay credits the launches its capture recorded). The serve
layer's executor threads call the wrapper concurrently: the build and the
library load run under one module lock, and the counts under another.

The plain version repeats the kernel's pipeline step for step (see the
note at the top of fp_mul.cu and gpu/fp.py): a * b as sums of shifted
rows (on the CPU at narrow widths one outer product), the products by the
constants N' and p as matrix products with their Toeplitz matrices. Every
partial sum is an integer below 2^21, so it is exact in any order: in
float32 on the CPU and in float64 on the card (a CUDA float32 matrix
product may run in TF32; a float64 one never does).
"""

import collections
import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fields import P
from .limbs import MONT_R, NLIMBS, balanced_limbs

_OUT2 = 2 * NLIMBS - 1  # 103 coefficients of a full limb product

_P_BAL_NP = balanced_limbs(P)
_NPRIME_NP = balanced_limbs((-pow(P, -1, MONT_R)) % MONT_R, wrap=True)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fp_mul.cu"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # register / spill report, kept in BUILD_LOG
)

LAUNCHES = 0      # kernel launches, counted in `launch`
LAUNCH_WIDTHS = collections.Counter()  # launches by lanes n, counted in `launch`
PLAIN_CALLS = 0   # calls of `mul_plain`
BUILD_LOG = ""    # nvcc's output (ptxas' report) from the build of the library

_LIB = None
_BUILD_LOCK = threading.Lock()  # build() and the library load in _lib()
_COUNT_LOCK = threading.Lock()  # LAUNCHES, LAUNCH_WIDTHS, PLAIN_CALLS


# --- build and bind ---------------------------------------------------------


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found under CUDA_HOME=%s" % CUDA_HOME)
    return nvcc


def build():
    """Compile fp_mul.cu into BUILD_DIR unless a library built from the same
    source and flags is already there; returns the library's path. The
    name carries a hash of both, so an edited source never loads a stale
    library. nvcc's output is kept beside it and read into BUILD_LOG.
    Threads of one process serialize on a module lock; the temporary file
    carries the process and thread ids."""
    with _BUILD_LOCK:
        return _build_locked()


def _build_locked():
    global BUILD_LOG
    tag = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / ("libcoconut_fp_mul-%s.so" % tag)
    log = lib.with_suffix(".log")
    if lib.exists():
        BUILD_LOG = log.read_text() if log.exists() else ""
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(
        lib.name + ".%d.%d.tmp" % (os.getpid(), threading.get_ident())
    )
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True,
        text=True,
    )
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on %s:\n%s" % (SOURCE, BUILD_LOG))
    # lint: allow(durability, the nvcc log is diagnostics only; the library
    # it describes is published below by an atomic rename)
    log.write_text(BUILD_LOG)
    os.replace(tmp, lib)
    return lib


def _lib():
    """The loaded library, built and bound on first use (once, under the
    module lock)."""
    global _LIB
    with _BUILD_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build_locked()))
            fn = lib.coconut_fp_mul
            fn.argtypes = [
                ctypes.c_void_p,  # a
                ctypes.c_void_p,  # b
                ctypes.c_void_p,  # consts
                ctypes.c_void_p,  # out
                ctypes.c_longlong,  # n
                ctypes.c_void_p,  # stream
            ]
            fn.restype = ctypes.c_int
            lib.coconut_fp_mul_group.argtypes = []
            lib.coconut_fp_mul_group.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def group():
    """Threads that work on one lane in the built kernel (G)."""
    return _lib().coconut_fp_mul_group()


@functools.lru_cache(maxsize=None)
def _kernel_consts(device):
    """[104] f32 on `device`: balanced limbs of p, then of N'."""
    return torch.from_numpy(np.concatenate([_P_BAL_NP, _NPRIME_NP])).to(device)


# --- the wrapper ------------------------------------------------------------


def _flat(a, shape):
    return a.broadcast_to(shape).reshape(-1, NLIMBS).contiguous()


def mul(a, b):
    """Montgomery product a * b * 2^-416 mod p of LAZY limb tensors [..., 52]
    (broadcasting), NORMALIZED out. CUDA tensors run the kernel, CPU
    tensors the plain version; anything else raises."""
    if a.device != b.device:
        raise ValueError("operands on %s and %s" % (a.device, b.device))
    if a.device.type == "cpu":
        return mul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError("fp.mul has no path for device %s" % a.device)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a2, b2 = _flat(a, shape), _flat(b, shape)
    out = torch.empty_like(a2)
    launch(a2, b2, out)
    return out.reshape(shape)


def launch(a, b, out):
    """Run the kernel on row-major f32 [N, 52] CUDA tensors a, b into out,
    on the current stream. Checks everything the kernel assumes."""
    global LAUNCHES
    if not a.is_cuda:
        raise ValueError("a must be a CUDA tensor, not on %s" % a.device)
    for name, t in (("a", a), ("b", b), ("out", out)):
        if t.device != a.device:
            raise ValueError("%s lies on %s, a on %s" % (name, t.device, a.device))
        if t.dtype != torch.float32:
            raise ValueError("%s must be float32, not %s" % (name, t.dtype))
        if t.dim() != 2 or t.shape[1] != NLIMBS or t.shape[0] != a.shape[0]:
            raise ValueError("%s must be [N, %d], got %s" % (name, NLIMBS, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.data_ptr() % 16:
            raise ValueError("%s must be 16-byte aligned" % name)
    n = a.shape[0]
    if n == 0:
        return out
    fn = _lib().coconut_fp_mul
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(
            a.data_ptr(),
            b.data_ptr(),
            _kernel_consts(a.device).data_ptr(),
            out.data_ptr(),
            n,
            stream,
        )
    if err != 0:
        raise RuntimeError("fp_mul kernel launch failed: CUDA error %d" % err)
    with _COUNT_LOCK:
        LAUNCHES += 1
        LAUNCH_WIDTHS[n] += 1
    return out


def credit(widths):
    """Count launches that the device runs without a call of `launch`: a
    CUDA graph's replay of the launches its capture recorded. `widths` is
    a Counter of launches by lanes."""
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += sum(widths.values())
        LAUNCH_WIDTHS.update(widths)


# --- the plain version ------------------------------------------------------


def _toeplitz(row, out_len):
    """[52, out_len] matrix M with M[i, i + j] = row[j]: x @ M is
    the limb product of x with the constant `row`, truncated."""
    m = np.zeros((NLIMBS, _OUT2), dtype=np.float64)
    for i in range(NLIMBS):
        m[i, i : i + NLIMBS] = row
    return m[:, :out_len]


def _plain_dtype(device):
    """float32 on the CPU, float64 elsewhere. Every value of the pipeline
    is an integer below 2^21 (|limbs| <= 132 after the first passes, 52
    products of two such limbs, plus 52 of N' or p limbs and m limbs), so
    float32 holds it exactly; a CUDA float32 matrix product may run in
    TF32, which would not, so on the card the plain version keeps
    float64."""
    return torch.float32 if device.type == "cpu" else torch.float64


@functools.lru_cache(maxsize=None)
def _plain_consts(device):
    """Product-by-constant matrices for m = tlo * N' and m * p, and on the
    CPU the carry matrices of the two row widths the pipeline normalizes
    (52 and 55 limbs)."""
    dt = _plain_dtype(device)
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device, dt)
    carry = {}
    if device.type == "cpu":
        carry = {w: _carry_matrix(w, dt) for w in (NLIMBS, NLIMBS + 3)}
    return as_t(_toeplitz(_NPRIME_NP, NLIMBS)), as_t(_toeplitz(_P_BAL_NP, _OUT2)), carry


#: the CPU's narrow forms, where a PyTorch call's fixed cost dominates:
#: up to OUTER_LANES lanes the limb product is one outer product summed
#: along its anti-diagonals, up to CARRY_MATRIX_LANES a carry pass is one
#: product with a fixed matrix (crossovers and gains measured with
#: `python -m coconut_tpu_torch.bench_plain`). On the card the plain
#: version keeps the one path the kernel is held against.
OUTER_LANES = 64
CARRY_MATRIX_LANES = 24


@functools.lru_cache(maxsize=None)
def _diagonals(device):
    """Column k of the flattened 52 x 52 outer product x_i y_j: i + j."""
    i = torch.arange(NLIMBS, device=device)
    return (i[:, None] + i[None, :]).reshape(-1)


def _carry_matrix(width, dt):
    """[width, width] M with t + hi @ M = t - 256 hi + (hi shifted up a
    limb, the top limb's carry dropped): one carry pass after hi."""
    m = torch.diag(torch.full((width,), -256.0, dtype=dt))
    m += torch.diag(torch.ones(width - 1, dtype=dt), 1)
    return m


def _school(x, y):
    """c_k = sum_{i+j=k} x_i y_j over [N, 52] rows: the 103 coefficients of
    the limb product. On the CPU up to OUTER_LANES rows: the outer product
    added into its anti-diagonals. Else the limbs of x go in 4 blocks of
    13, one shifted multiply-add per limb of a block for all 4 blocks at
    once, then the blocks' partial products are added at their offsets.
    Every term and every sum is an integer below 2^21, so either working
    type adds them exactly in any order."""
    n, blk = x.shape[0], NLIMBS // 4
    if x.device.type == "cpu" and n <= OUTER_LANES:
        prod = (x[:, :, None] * y[:, None, :]).reshape(n, NLIMBS * NLIMBS)
        return x.new_zeros((n, _OUT2)).index_add_(1, _diagonals(x.device), prod)
    xb = x.reshape(n, 4, blk)
    yb = y[:, None, :]
    part = x.new_zeros((n, 4, NLIMBS + blk - 1))
    for i in range(blk):
        part.narrow(2, i, NLIMBS).addcmul_(xb.narrow(2, i, 1), yb)
    t = x.new_zeros((n, _OUT2))
    for j in range(4):
        t.narrow(1, blk * j, NLIMBS + blk - 1).add_(part[:, j])
    return t


def _norm(t, passes, carry=None):
    """`passes` carry passes: hi = round_half_even(t / 256) (torch.round
    rounds ties to even, like jnp.round), lo = t - 256 hi, hi shifted up a
    limb with the top limb's carry dropped. With `carry` (the rows' carry
    matrix, given on the CPU at narrow widths) a pass is t + hi @ carry:
    every value is an integer below 2^21, so that form is exact too."""
    width = t.shape[-1]
    for _ in range(passes):
        hi = (t * (1.0 / 256.0)).round_()
        if carry is not None:
            t = torch.addmm(t, hi, carry)
            continue
        t = t.add(hi, alpha=-256.0)
        t.narrow(-1, 1, width - 1).add_(hi.narrow(-1, 0, width - 1))
    return t


def mul_plain(a, b):
    """The kernel's function in plain PyTorch, on any device."""
    global PLAIN_CALLS
    with _COUNT_LOCK:
        PLAIN_CALLS += 1
    by_nprime, by_p, carry = _plain_consts(a.device)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a1, b1 = _flat(a, shape), _flat(b, shape)
    n = a1.shape[0]
    c52 = c55 = None
    if carry and n <= CARRY_MATRIX_LANES:
        c52, c55 = carry[NLIMBS], carry[NLIMBS + 3]
    # a and b normalized as one stack: half the PyTorch calls
    ab = _norm(torch.cat((a1, b1)).to(by_p.dtype), 2, c52)  # |limbs| <= 132
    t = _school(ab[:n], ab[n:])
    tlo = _norm(t[:, :NLIMBS], 3, c52)  # t mod 2^416 (truncation intended)
    m = _norm(tlo @ by_nprime, 3, c52)  # low 52 coefficients of tlo * N'
    w = torch.addmm(t, m, by_p)  # = t + m*p
    lo = _norm(F.pad(w[:, :NLIMBS], (0, 3)), 3, c55)  # carry lands in 52..54
    hi = F.pad(w[:, NLIMBS:], (0, 1))
    hi[:, :3] += lo[:, NLIMBS:]
    return _norm(hi, 3, c52).float().reshape(shape)
