"""The port's Fp layer (coconut_tpu_torch/gpu/fp.py + cuda_fp.py) against
the JAX reference on the CPU.

Inputs are made from numpy seeds and fed to both sides as numpy arrays.
Tolerance: exact (0) everywhere — every limb on both sides is an exact
integer, so the port must match the reference limb for limb, and decoded
values must equal the Python-int results.

Also here: the import rule of the port (no `jax`, nothing of
`coconut_tpu`), checked by walking the AST of every module, and the
default device (cuda, which raises where no card is present).
"""

import ast
import functools
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coconut_tpu.tpu import fp as jfp
from coconut_tpu.tpu import limbs as jlimbs
from coconut_tpu.tpu import pallas_fp
from coconut_tpu_torch import bench_plain
from coconut_tpu_torch.gpu import cuda_fp, fp, limbs
from coconut_tpu_torch.gpu.backend import TorchBackend, resolve_device
from coconut_tpu_torch.ops.fields import P

MONT_R = limbs.MONT_R
NLIMBS = limbs.NLIMBS
ROOT = pathlib.Path(__file__).resolve().parent.parent

_rng = np.random.default_rng(0x7F0C)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers on one machine,
    and these small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lazy(n):
    """[n, 52] f32 LAZY limbs in class: balanced-style limbs below limb 47
    (|value| < 2^376 < p) times a random signed weight up to 992."""
    x = _rng.integers(-128, 129, size=(n, NLIMBS)).astype(np.float64)
    x[:, 47:] = 0.0
    w = _rng.integers(1, 993, size=(n, 1)) * _rng.choice([-1, 1], size=(n, 1))
    return (x * w).astype(np.float32)


def _adversarial():
    """tests/test_pallas.py's extremes (all limbs +-132, alternating, half
    and half) and rows at +-2^17 with the top two limbs vacant."""
    half = NLIMBS // 2
    rows = [
        np.full(NLIMBS, 132.0),
        np.full(NLIMBS, -132.0),
        np.tile([132.0, -132.0], half),
        np.concatenate([np.full(half, 132.0), np.full(half, -132.0)]),
    ]
    big = np.full(NLIMBS, float(1 << 17))
    big[-2:] = 0.0
    rows += [big, -big, big * np.tile([1.0, -1.0], half)]
    return np.array(rows, dtype=np.float32)


def _value(row):
    return sum(int(v) << (8 * i) for i, v in enumerate(row))


def _port_mul(a, b):
    return fp.mul(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def _jax_mul(a, b):
    return np.asarray(jfp.mul(jnp.asarray(a), jnp.asarray(b)))


@functools.lru_cache(maxsize=None)
def _crossover_cases():
    """(a, b, the XLA path's a*b) at 1, 7, 24, 25, 64 and 65 lanes, the
    adversarial rows among them; the reference runs once, on all of them."""
    adv, widths = _adversarial(), (1, 7, 24, 25, 64, 65)
    a = [np.concatenate([adv, _lazy(n)])[-n:] for n in widths]
    b = [np.concatenate([_lazy(n), adv])[:n] for n in widths]
    want = np.split(_jax_mul(np.concatenate(a), np.concatenate(b)), np.cumsum(widths)[:-1])
    return list(zip(a, b, want))


class TestMul:
    def test_matches_xla_path_random_lazy(self):
        a, b = _lazy(96), _lazy(96)
        got = _port_mul(a, b)
        np.testing.assert_array_equal(got, _jax_mul(a, b))
        rinv = pow(MONT_R, -1, P)
        for i in range(96):
            assert (_value(got[i]) - _value(a[i]) * _value(b[i]) * rinv) % P == 0
        assert np.abs(got).max() <= fp.L_NORM  # NORMALIZED output class

    def test_matches_xla_path_adversarial(self):
        adv = _adversarial()
        a = np.repeat(adv, len(adv), axis=0)
        b = np.tile(adv, (len(adv), 1))
        np.testing.assert_array_equal(_port_mul(a, b), _jax_mul(a, b))

    def test_matches_interpreted_pallas_kernel(self):
        a = np.concatenate([_lazy(9), _adversarial()])
        b = np.concatenate([_adversarial(), _lazy(9)])
        want = np.asarray(
            pallas_fp.mul(jnp.asarray(a), jnp.asarray(b), interpret=True)
        )
        np.testing.assert_array_equal(_port_mul(a, b), want)

    @pytest.mark.parametrize("form", sorted(bench_plain.FORMS))
    def test_every_plain_form_matches_xla_path_across_its_crossovers(self, form):
        """float64 without the narrow forms is the card's plain path; the
        CPU's float32 forms must give the same bits at widths on both
        sides of OUTER_LANES and CARRY_MATRIX_LANES."""
        for a, b, want in _crossover_cases():
            with bench_plain.plain_form(*bench_plain.FORMS[form]):
                got = _port_mul(a, b)
            np.testing.assert_array_equal(got, want)

    def test_broadcast_and_stack(self):
        a = _lazy(12).reshape(3, 4, NLIMBS)
        c = _lazy(1)[0]
        got = fp.mul(torch.from_numpy(a), torch.from_numpy(c)).numpy()
        np.testing.assert_array_equal(got, _jax_mul(a, c))
        lhs = [torch.from_numpy(x) for x in (a[0], a[1])]
        rhs = [torch.from_numpy(c), torch.from_numpy(a[2])]
        outs = fp.mul_stack(lhs, rhs)
        jouts = jfp.mul_stack(
            [jnp.asarray(a[0]), jnp.asarray(a[1])],
            [jnp.asarray(c), jnp.asarray(a[2])],
        )
        for o, jo in zip(outs, jouts):
            np.testing.assert_array_equal(o.numpy(), np.asarray(jo))

    def test_counters_count_the_plain_version_on_cpu(self):
        before_plain, before_launch = cuda_fp.PLAIN_CALLS, cuda_fp.LAUNCHES
        fp.mul(torch.from_numpy(_lazy(2)), torch.from_numpy(_lazy(2)))
        assert cuda_fp.PLAIN_CALLS == before_plain + 1
        assert cuda_fp.LAUNCHES == before_launch

    def test_no_silent_path_for_other_devices(self):
        a = torch.zeros(2, NLIMBS, device="meta")
        with pytest.raises(ValueError):
            fp.mul(a, a)
        with pytest.raises(ValueError):
            fp.mul(a, torch.zeros(2, NLIMBS))


class TestFpOps:
    def _canon(self, n):
        return [int(x) % P for x in _rng.integers(0, 2**63, size=n)] + [0, 1, P - 1]

    def test_to_mont_matches_reference(self):
        vals = self._canon(8)
        raw = limbs.fp_encode_raw_batch(vals)
        got = fp.to_mont(torch.from_numpy(raw.copy())).numpy()
        np.testing.assert_array_equal(got, np.asarray(jfp.to_mont(jnp.asarray(raw))))
        assert limbs.fp_decode_batch(got) == vals

    def test_pow_static_and_inv(self):
        vals = [v for v in self._canon(4) if v]
        enc = limbs.fp_encode_batch(vals)
        got = fp.inv(torch.from_numpy(enc)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jfp.inv(jnp.asarray(enc))))
        assert limbs.fp_decode_batch(got) == [pow(v, -1, P) for v in vals]
        e = 0xC0C0_1234_5678
        got = fp.pow_static(torch.from_numpy(enc), e).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jfp.pow_static(jnp.asarray(enc), e))
        )
        assert limbs.fp_decode_batch(got) == [pow(v, e, P) for v in vals]

    def test_is_zero_and_eq(self):
        vals = self._canon(3)
        enc = limbs.fp_encode_batch(vals)
        p_limbs = limbs.balanced_limbs(P)[None]  # p itself: 0 mod p, not 0
        x = np.concatenate([enc, p_limbs, -p_limbs, 3 * p_limbs])
        got = fp.is_zero(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jfp.is_zero(jnp.asarray(x))))
        assert got.tolist() == [v == 0 for v in vals] + [True] * 3
        t = torch.from_numpy(enc)
        assert fp.eq(t, t + torch.from_numpy(p_limbs)).all()
        zs = fp.is_zero_many([t, t - t])
        assert zs[0].tolist() == [v == 0 for v in vals] and zs[1].all()


class TestLimbs:
    def test_codec_matches_reference(self):
        vals = [int(x) % P for x in _rng.integers(0, 2**63, size=6)] + [P - 1]
        np.testing.assert_array_equal(
            limbs.fp_encode_batch(vals), jlimbs.fp_encode_batch(vals)
        )
        np.testing.assert_array_equal(
            limbs.fp_encode_raw_batch(vals), jlimbs.fp_encode_raw_batch(vals)
        )
        enc = limbs.fp_encode_batch(vals) * 3 - 7
        assert limbs.fp_decode_batch(enc) == jlimbs.fp_decode_batch(enc)

    @pytest.mark.parametrize("window,nwin", [(6, 43), (9, 29)])
    def test_signed_digits_match_reference(self, window, nwin):
        from coconut_tpu_torch.ops.fields import R

        scal = [0, 1, R - 1, (1 << 255) % R] + [
            int(x) * 0x1234567 % R for x in _rng.integers(0, 2**63, size=8)
        ]
        mag, neg = limbs.fr_digits_signed_np(scal, nwin=nwin, window=window)
        jmag, jneg = jlimbs.fr_digits_signed_np(scal, nwin=nwin, window=window)
        assert mag.dtype == jmag.dtype == (np.int16 if window == 9 else np.uint8)
        np.testing.assert_array_equal(mag, jmag)
        np.testing.assert_array_equal(neg, jneg)
        base = 1 << window
        for s, m, n in zip(scal, mag, neg):
            back = 0
            for d, sgn in zip(m, n):
                back = back * base + (-int(d) if sgn else int(d))
            assert back == s


# --- the kernel's build ------------------------------------------------------


def test_kernel_build_keeps_exact_rounding():
    """The kernel's carries must round half to even, as jnp.round does in
    the reference: built for sm_90a without fast-math, rounding with rintf
    and never with roundf (half away from zero) or a (t + 128) >> 8 shift."""
    flags = " ".join(cuda_fp.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast-math" not in flags and "fast_math" not in flags
    assert "ftz" not in flags and "prec-div=false" not in flags
    code = "\n".join(
        line.split("//")[0] for line in cuda_fp.SOURCE.read_text().splitlines()
    )
    assert "rintf(" in code
    assert "roundf(" not in code and "__float2int_rn" not in code
    assert ">> 8" not in code and "+ 128" not in code


# --- the port's import rule --------------------------------------------------


def _imports(path):
    """Absolute module names a file imports (relative imports stay inside
    its own package)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def _port_files():
    return sorted((ROOT / "coconut_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    walked = {str(p.relative_to(ROOT)) for p in files}
    analysis = {
        "coconut_tpu_torch/analysis/%s.py" % m
        for m in ("__init__", "__main__", "core", "consttime", "durability", "lockcheck",
                  "lockorder", "metricsdoc", "schema", "wirecontract")
    }
    assert analysis | {"coconut_tpu_torch/native.py"} <= walked
    bad = []
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "coconut_tpu"):
                bad.append((str(path.relative_to(ROOT)), name))
    assert not bad, bad


def test_import_walker_catches_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text(
        "import jax.numpy as jnp\nfrom coconut_tpu.ops import fields\n"
        "from . import x\nfrom coconut_tpu_torch.gpu import fp\n"
    )
    tops = [n.split(".")[0] for n in _imports(p)]
    assert tops == ["jax", "coconut_tpu", "coconut_tpu_torch"]


# --- the default device ------------------------------------------------------


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert TorchBackend().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchBackend()
    assert resolve_device("cpu").type == "cpu"
    be = TorchBackend(device="cpu")
    assert (be.window, be.nwin, be.entries, be.raw_wire) == (6, 43, 33, False)
