"""CppBackend and the native core's other entry points — the port's own
ctypes binding of `native/ccbls.cpp`, with the names of
`coconut_tpu/native.py`.

The native library is a second oracle for the card's bits and the
const-time issuance schedule of CONSTTIME.md: `CppBackend(ct=True)`
("cpp_ct") accumulates its MSMs through the complete Renes-Costello-Batina
formulas over masked table lookups, with no secret-dependent branch or
memory access. `CppBackend()` ("cpp") runs the windowed variable-time
schedule. Both implement the `CurveBackend` seam of `backend.py`, so every
verdict and point is the spec's.

Build: at first use `load()` compiles `native/ccbls.cpp` with g++ (the
flags of `native/Makefile`) into the repository's `build/` directory,
under a name that carries a hash of the source and the flags, so an
edited source never loads a stale library. It writes nothing under
`native/`. Threads of one process serialize on a module lock; the
compiler writes a temporary file named by process and thread and the
library is published by an atomic rename, so concurrent processes never
load a half-written file. `cc_selftest` must return 0, or `load()`
raises. `CCBLS_SO` names a library to load instead of building one.

Wire codec (must match ccbls.cpp): Fp = 48B LE canonical; affine G1 = x||y
(96B), G2 = x.c0||x.c1||y.c0||y.c1 (192B); infinity = all-zero bytes
(0^3+4 != 0 so the encoding is unambiguous); scalars = 32B LE canonical Fr.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from .backend import CurveBackend
from .errors import GeneralError
from .ops.fields import R
from .ops.hashing import DST_FR, DST_G1, DST_G2

_ROOT = Path(__file__).resolve().parent.parent
SOURCE = _ROOT / "native" / "ccbls.cpp"
BUILD_DIR = _ROOT / "build"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

_LIB = None
_LOAD_ERROR = None  # the first failure of load(), raised again on retries
_LOCK = threading.Lock()


def build():
    """Compile ccbls.cpp into BUILD_DIR unless a library built from the same
    source and flags is there already; returns the library's path."""
    cxx = os.environ.get("CXX", "g++")
    tag = hashlib.sha256(
        SOURCE.read_bytes() + " ".join((cxx,) + CXX_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / ("libccbls-%s.so" % tag)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(lib.name + ".%d.%d.tmp" % (os.getpid(), threading.get_ident()))
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(
            "%s failed on %s:\n%s" % (cxx, SOURCE, proc.stdout + proc.stderr)
        )
    os.replace(tmp, lib)
    return lib


def load():
    """Load (building if needed) and selftest the native library."""
    global _LIB, _LOAD_ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _LOAD_ERROR is not None:
            raise _LOAD_ERROR
        try:
            _LIB = _bind(os.environ.get("CCBLS_SO") or str(build()))
        except Exception as e:
            _LOAD_ERROR = e
            raise
        return _LIB


def _bind(path):
    lib = ctypes.CDLL(path)
    lib.cc_selftest.restype = ctypes.c_int
    rc = lib.cc_selftest()
    if rc != 0:
        raise RuntimeError("ccbls selftest failed: %d" % rc)
    c_char_p, c_int, c_u32 = ctypes.c_char_p, ctypes.c_int, ctypes.c_uint32
    u32_p = ctypes.POINTER(c_u32)
    signatures = {
        # name: (argtypes, restype)
        "cc_msm_g1": ([c_char_p, c_char_p, c_int, c_int, c_char_p, c_int], None),
        "cc_msm_g2": ([c_char_p, c_char_p, c_int, c_int, c_char_p, c_int], None),
        "cc_pairing_product_is_one": ([c_char_p, c_char_p, c_int, c_int, c_char_p], None),
        "cc_g1_mul": ([c_char_p, c_char_p, c_int, c_char_p], None),
        "cc_msm_pippenger_g1": ([c_char_p, c_char_p, c_int, c_char_p], None),
        "cc_msm_pippenger_g2": ([c_char_p, c_char_p, c_int, c_char_p], None),
        "cc_fr_lagrange_basis_at_0": ([u32_p, c_int, c_u32, c_char_p], c_int),
        "cc_fr_poly_eval": ([c_char_p, c_int, c_u32, c_char_p], None),
        "cc_fr_reconstruct": ([u32_p, c_char_p, c_int, c_char_p], c_int),
        "cc_fr_random": ([c_char_p], c_int),
        "cc_pedersen_deal_from_coeffs": ([c_int, c_int] + [c_char_p] * 7, None),
        "cc_pedersen_deal": ([c_int, c_int] + [c_char_p] * 7, c_int),
        "cc_pedersen_verify_share": ([c_int, c_u32] + [c_char_p] * 5, c_int),
        "cc_dvss_new": ([c_u32, c_int, c_int, c_char_p, c_char_p], ctypes.c_void_p),
        "cc_dvss_deal": ([ctypes.c_void_p, c_char_p, c_char_p, c_char_p], None),
        "cc_dvss_receive": ([ctypes.c_void_p, c_u32, c_char_p, c_char_p, c_char_p], c_int),
        "cc_dvss_finalize": ([ctypes.c_void_p, c_char_p, c_char_p, c_char_p], c_int),
        "cc_dvss_free": ([ctypes.c_void_p], None),
        "cc_hash_to_fr": ([c_char_p, c_int, c_char_p, c_int, c_char_p], c_int),
        "cc_hash_to_g1": ([c_char_p, c_int, c_char_p, c_int, c_char_p], c_int),
        "cc_hash_to_g2": ([c_char_p, c_int, c_char_p, c_int, c_char_p], c_int),
        "cc_hash_to_g1_batch": (
            [c_char_p, ctypes.POINTER(c_int), c_int, c_char_p, c_int, c_char_p], c_int
        ),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def available():
    """True if the native library builds (or loads) and passes its selftest."""
    try:
        load()
        return True
    except Exception:
        return False


# --- hashing (bit-identical to ops/hashing.py) -------------------------------


def hash_to_fr(msg, dst=None):
    """Native hash-to-Fr, bit-identical to ops.hashing.hash_to_fr."""
    dst = DST_FR if dst is None else dst
    out = ctypes.create_string_buffer(32)
    rc = load().cc_hash_to_fr(msg, len(msg), dst, len(dst), out)
    if rc != 0:
        raise ValueError("cc_hash_to_fr failed: %d" % rc)
    return int.from_bytes(out.raw, "little")


def hash_to_g1(msg, dst=None):
    """Native hash-to-G1, bit-identical to ops.hashing.hash_to_g1."""
    dst = DST_G1 if dst is None else dst
    out = ctypes.create_string_buffer(96)
    rc = load().cc_hash_to_g1(msg, len(msg), dst, len(dst), out)
    if rc != 0:
        raise ValueError("cc_hash_to_g1 failed: %d" % rc)
    return _g1_parse(out.raw)


def hash_to_g1_batch(msgs, dst=None):
    """N messages hashed to G1 in one call; bit-identical to
    [hash_to_g1(m) for m in msgs]."""
    dst = DST_G1 if dst is None else dst
    msgs = list(msgs)
    lib = load()
    n = len(msgs)
    if n == 0:
        return []
    lens = (ctypes.c_int * n)(*[len(m) for m in msgs])
    out = ctypes.create_string_buffer(96 * n)
    rc = lib.cc_hash_to_g1_batch(b"".join(msgs), lens, n, dst, len(dst), out)
    if rc != 0:
        raise ValueError("cc_hash_to_g1_batch failed at msg %d" % (rc - 1))
    return _g1_rows(out.raw, n)


def hash_to_g2(msg, dst=None):
    """Native hash-to-G2, bit-identical to ops.hashing.hash_to_g2."""
    dst = DST_G2 if dst is None else dst
    out = ctypes.create_string_buffer(192)
    rc = load().cc_hash_to_g2(msg, len(msg), dst, len(dst), out)
    if rc != 0:
        raise ValueError("cc_hash_to_g2 failed: %d" % rc)
    return _g2_parse(out.raw)


# --- single MSMs: Pippenger buckets from PIPPENGER_MIN points ----------------

# Below this size the windowed row schedule beats the bucket combine (the
# reference's crossover, BASELINE.md "Pippenger crossover").
PIPPENGER_MIN = 96


def msm_g1_single(points, scalars, force_pippenger=False):
    """One variable-time MSM over n distinct G1 points: Pippenger buckets
    for n >= PIPPENGER_MIN (or when forced), the windowed row schedule
    below it. Returns a spec point (None is the identity)."""
    return _msm_single(points, scalars, force_pippenger, "g1")


def msm_g2_single(points, scalars, force_pippenger=False):
    """G2 variant of msm_g1_single."""
    return _msm_single(points, scalars, force_pippenger, "g2")


def _msm_single(points, scalars, force_pippenger, group):
    n = len(points)
    if n == 0:
        return None
    lib = load()
    if n < PIPPENGER_MIN and not force_pippenger:
        distinct = getattr(CppBackend(), "msm_%s_distinct" % group)
        return distinct([list(points)], [list(scalars)])[0]
    to_bytes, rows, width = _CODEC[group]
    out = ctypes.create_string_buffer(width)
    getattr(lib, "cc_msm_pippenger_%s" % group)(
        b"".join(to_bytes(p) for p in points),
        b"".join(_scalar_bytes(s) for s in scalars),
        n,
        out,
    )
    return rows(out.raw, 1)[0]


# --- Shamir over Fr (bit-identical to sss.py) --------------------------------


def _id_u32(v, what="signer id"):
    """The C ABI carries ids and evaluation points as uint32; refuse any
    that would wrap (sss.py takes ids of any size)."""
    v = int(v)
    if not 0 <= v < 1 << 32:
        raise GeneralError(
            "%s %d outside the native uint32 range; use coconut_tpu_torch.sss"
            % (what, v)
        )
    return v


def lagrange_basis_at_0(ids, my_id):
    """l_{my_id}(0) over `ids`, with sss.lagrange_basis_at_0's errors."""
    lib = load()
    ids = sorted({_id_u32(i) for i in ids})
    arr = (ctypes.c_uint32 * len(ids))(*ids)
    out = ctypes.create_string_buffer(32)
    rc = lib.cc_fr_lagrange_basis_at_0(arr, len(ids), _id_u32(my_id), out)
    if rc == 1:
        raise GeneralError("id %d not in interpolation set" % my_id)
    if rc:
        raise GeneralError("signer ids must be nonzero (1-based)")
    return int.from_bytes(out.raw, "little")


def poly_eval(coeffs, x):
    """Horner evaluation in Fr (the Shamir share map)."""
    lib = load()
    out = ctypes.create_string_buffer(32)
    lib.cc_fr_poly_eval(
        b"".join(_scalar_bytes(c) for c in coeffs), len(coeffs), _id_u32(x, "eval point"), out
    )
    return int.from_bytes(out.raw, "little")


def reconstruct_secret(threshold, shares):
    """Lagrange interpolation at 0 over the first `threshold` shares by id,
    with sss.reconstruct_secret's errors."""
    if len(shares) < threshold:
        raise GeneralError(
            "need %d shares to reconstruct, got %d" % (threshold, len(shares))
        )
    lib = load()
    use = sorted(shares.items())[:threshold]
    ids = (ctypes.c_uint32 * threshold)(*[_id_u32(i) for i, _ in use])
    out = ctypes.create_string_buffer(32)
    if lib.cc_fr_reconstruct(ids, b"".join(_scalar_bytes(s) for _, s in use), threshold, out):
        raise GeneralError("invalid share ids")
    return int.from_bytes(out.raw, "little")


def rand_fr():
    """A uniform Fr element from the operating system's entropy."""
    out = ctypes.create_string_buffer(32)
    if load().cc_fr_random(out):
        raise RuntimeError("native entropy source failed")
    return int.from_bytes(out.raw, "little")


# --- Pedersen VSS and DVSS ---------------------------------------------------


def _check_threshold(threshold, total):
    if not 0 < threshold <= total:
        raise GeneralError("invalid threshold %d for total %d" % (threshold, total))


def _dealt(threshold, total, comms, ss, ts):
    """(comm_coeffs {j: point}, s_shares {id: int}, t_shares {id: int})
    from the C ABI's output buffers."""
    comm_coeffs = dict(enumerate(_g1_rows(comms.raw, threshold)))
    s_shares = {i + 1: v for i, v in enumerate(_fr_rows(ss.raw, total))}
    t_shares = {i + 1: v for i, v in enumerate(_fr_rows(ts.raw, total))}
    return comm_coeffs, s_shares, t_shares


def _deal_buffers(threshold, total):
    return (
        ctypes.create_string_buffer(96 * threshold),
        ctypes.create_string_buffer(32 * total),
        ctypes.create_string_buffer(32 * total),
    )


def pedersen_deal_from_coeffs(threshold, total, g, h, f_coeffs, g_coeffs):
    """Pedersen deal from given polynomial coefficients: (comm_coeffs,
    s_shares, t_shares), bit-identical to sss.py's on the same
    coefficients."""
    _check_threshold(threshold, total)
    if len(f_coeffs) != threshold or len(g_coeffs) != threshold:
        raise GeneralError(
            "need %d coefficients per polynomial, got %d and %d"
            % (threshold, len(f_coeffs), len(g_coeffs))
        )
    lib = load()
    comms, ss, ts = _deal_buffers(threshold, total)
    lib.cc_pedersen_deal_from_coeffs(
        threshold, total, _g1_bytes(g), _g1_bytes(h),
        b"".join(_scalar_bytes(c) for c in f_coeffs),
        b"".join(_scalar_bytes(c) for c in g_coeffs),
        comms, ss, ts,
    )
    return _dealt(threshold, total, comms, ss, ts)


def pedersen_deal(threshold, total, g, h):
    """PedersenVSS.deal with fresh random polynomials from native entropy:
    (secret, blind_secret, comm_coeffs, s_shares, t_shares)."""
    _check_threshold(threshold, total)
    lib = load()
    fc = ctypes.create_string_buffer(32 * threshold)
    gc = ctypes.create_string_buffer(32 * threshold)
    comms, ss, ts = _deal_buffers(threshold, total)
    if lib.cc_pedersen_deal(threshold, total, _g1_bytes(g), _g1_bytes(h), fc, gc, comms, ss, ts):
        raise RuntimeError("native entropy source failed")
    secret = int.from_bytes(fc.raw[:32], "little")
    blind = int.from_bytes(gc.raw[:32], "little")
    return (secret, blind) + _dealt(threshold, total, comms, ss, ts)


def pedersen_verify_share(threshold, share_id, share, comm_coeffs, g, h):
    """PedersenVSS.verify_share: g^s h^t == prod_j comm_j^(id^j)."""
    s, t = share
    return bool(
        load().cc_pedersen_verify_share(
            threshold,
            _id_u32(share_id),
            _scalar_bytes(s),
            _scalar_bytes(t),
            b"".join(_g1_bytes(comm_coeffs[j]) for j in range(threshold)),
            _g1_bytes(g),
            _g1_bytes(h),
        )
    )


class DvssParticipant:
    """A DVSS participant whose dealing, share checks and combining run in
    C++; the protocol rounds run on the host. It has the attribute
    surface of sss.PedersenDVSSParticipant, so the two interoperate."""

    def __init__(self, participant_id, threshold, total, g, h):
        lib = load()
        self._lib = lib
        self.id = _id_u32(participant_id)
        self.threshold = threshold
        self.total = total
        self._h = lib.cc_dvss_new(self.id, threshold, total, _g1_bytes(g), _g1_bytes(h))
        if not self._h:
            raise GeneralError(
                "invalid DVSS parameters id=%d t=%d n=%d" % (participant_id, threshold, total)
            )
        comms, ss, ts = _deal_buffers(threshold, total)
        lib.cc_dvss_deal(self._h, comms, ss, ts)
        self.comm_coeffs, self.s_shares, self.t_shares = _dealt(threshold, total, comms, ss, ts)
        self.secret_share = None
        self.t_secret_share = None
        self.final_comm_coeffs = None

    def received_share(self, from_id, comm_coeffs, share, threshold=None, total=None,
                       g=None, h=None):
        """Verify and keep a share of `from_id`'s secret (the native handle
        carries what the extra arguments of the sss.py surface give)."""
        s, t = share
        rc = self._lib.cc_dvss_receive(
            self._h,
            _id_u32(from_id),
            b"".join(_g1_bytes(comm_coeffs[j]) for j in range(self.threshold)),
            _scalar_bytes(s),
            _scalar_bytes(t),
        )
        if rc == 1:
            raise GeneralError("participant %d received its own share" % self.id)
        if rc == 2:
            raise GeneralError("participant id %d out of range" % from_id)
        if rc == 3:
            raise GeneralError(
                "participant %d already has a share from %d" % (self.id, from_id)
            )
        if rc:
            raise GeneralError(
                "share from participant %d failed verification at %d" % (from_id, self.id)
            )

    def compute_final_comm_coeffs_and_shares(self, threshold=None, total=None, g=None,
                                             h=None):
        s32 = ctypes.create_string_buffer(32)
        t32 = ctypes.create_string_buffer(32)
        comms = ctypes.create_string_buffer(96 * self.threshold)
        if self._lib.cc_dvss_finalize(self._h, s32, t32, comms):
            raise GeneralError("participant %d is missing pairwise shares" % self.id)
        self.secret_share = int.from_bytes(s32.raw, "little")
        self.t_secret_share = int.from_bytes(t32.raw, "little")
        self.final_comm_coeffs = dict(enumerate(_g1_rows(comms.raw, self.threshold)))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.cc_dvss_free(h)
            self._h = None


def share_secret_dvss(threshold, total, g, h):
    """sss.share_secret_dvss with native participants: the dealerless
    three-round protocol run in one process."""
    participants = [DvssParticipant(i, threshold, total, g, h) for i in range(1, total + 1)]
    for recv in participants:
        for sender in participants:
            if sender.id != recv.id:
                recv.received_share(
                    sender.id,
                    sender.comm_coeffs,
                    (sender.s_shares[recv.id], sender.t_shares[recv.id]),
                )
    for p in participants:
        p.compute_final_comm_coeffs_and_shares()
    return participants


def derive_params(msg_count, label):
    """Params derivation through the native core: (g, g_tilde, h list) as
    spec points for the default signatures-in-G1 assignment."""
    g = hash_to_g1(bytes(label) + b" : g")
    g_tilde = hash_to_g2(bytes(label) + b" : g_tilde")
    hs = [hash_to_g1(bytes(label) + (" : y%d" % i).encode()) for i in range(msg_count)]
    return g, g_tilde, hs


# --- codec (ints <-> the C ABI's bytes) --------------------------------------


def _fp_bytes(x):
    return int(x).to_bytes(48, "little")


def _g1_bytes(p):
    if p is None:
        return b"\x00" * 96
    return _fp_bytes(p[0]) + _fp_bytes(p[1])


def _g2_bytes(p):
    if p is None:
        return b"\x00" * 192
    (x0, x1), (y0, y1) = p
    return _fp_bytes(x0) + _fp_bytes(x1) + _fp_bytes(y0) + _fp_bytes(y1)


def _g1_parse(b):
    if not any(b):
        return None
    return int.from_bytes(b[:48], "little"), int.from_bytes(b[48:96], "little")


def _g2_parse(b):
    if not any(b):
        return None
    v = [int.from_bytes(b[i * 48:(i + 1) * 48], "little") for i in range(4)]
    return (v[0], v[1]), (v[2], v[3])


def _g1_rows(raw, n):
    return [_g1_parse(raw[i * 96:(i + 1) * 96]) for i in range(n)]


def _g2_rows(raw, n):
    return [_g2_parse(raw[i * 192:(i + 1) * 192]) for i in range(n)]


def _fr_rows(raw, n):
    return [int.from_bytes(raw[i * 32:(i + 1) * 32], "little") for i in range(n)]


def _scalar_bytes(s):
    return (int(s) % R).to_bytes(32, "little")


# group -> (point encoder, parser of n points, bytes a point)
_CODEC = {"g1": (_g1_bytes, _g1_rows, 96), "g2": (_g2_bytes, _g2_rows, 192)}


class CppBackend(CurveBackend):
    """The native batched backend: shared-base MSMs as one call each, the
    distinct MSMs row by row, pairing products with one final
    exponentiation a row. `ct=True` selects the const-time MSM schedule."""

    name = "cpp"

    def __init__(self, ct=False):
        self._lib = load()
        self._ct = 1 if ct else 0

    def _msm_shared(self, group, bases, scalars_batch):
        to_bytes, rows, width = _CODEC[group]
        B = len(scalars_batch)
        out = ctypes.create_string_buffer(width * B)
        getattr(self._lib, "cc_msm_%s" % group)(
            b"".join(to_bytes(p) for p in bases),
            b"".join(_scalar_bytes(s) for row in scalars_batch for s in row),
            len(bases),
            B,
            out,
            self._ct,
        )
        return rows(out.raw, B)

    def msm_g1_shared(self, bases, scalars_batch):
        return self._msm_shared("g1", bases, scalars_batch)

    def msm_g2_shared(self, bases, scalars_batch):
        return self._msm_shared("g2", bases, scalars_batch)

    def msm_g1_distinct(self, points_batch, scalars_batch):
        # each row is a shared-base MSM of one lane
        return [self.msm_g1_shared(pts, [row])[0] for pts, row in zip(points_batch, scalars_batch)]

    def msm_g2_distinct(self, points_batch, scalars_batch):
        return [self.msm_g2_shared(pts, [row])[0] for pts, row in zip(points_batch, scalars_batch)]

    def pairing_product_is_one(self, pairs_batch):
        B = len(pairs_batch)
        n = len(pairs_batch[0]) if B else 0
        if any(len(row) != n for row in pairs_batch):
            raise ValueError("ragged pairing batch")
        out = ctypes.create_string_buffer(B)
        self._lib.cc_pairing_product_is_one(
            b"".join(_g1_bytes(p) for row in pairs_batch for p, _ in row),
            b"".join(_g2_bytes(q) for row in pairs_batch for _, q in row),
            n,
            B,
            out,
        )
        return [bool(out.raw[i]) for i in range(B)]
