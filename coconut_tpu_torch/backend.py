"""The host spec backend, the backend registry and the capability probes
of the optional asynchronous MSM contracts — the port's copy of
`PythonBackend` (with the verify surface `CurveBackend` composes over its
primitives), `register_backend` / `get_backend`, `_async_pair`,
`async_shared_many_api`, `async_distinct_api` and
`async_distinct_plus_offset_api` (`coconut_tpu/backend.py`). Each dispatch
half is probed together with the wait half that settles its handles, so a
backend that has only one of them is treated as having neither. The
issuance batch functions (`signature.py`) pick their schedule from these.

Registry names: "torch" is a `TorchBackend` on `cuda` (raises without a
card), "spec" (alias "python") the host spec backend.
"""

from . import metrics
from .ops import pairing as _pairing
from .ops.curve import g1, g2
from .ops.fields import R


class SpecBackend:
    """The sequential host spec, row by row on Python ints (the JAX
    package's PythonBackend): what `backend=ps.SPEC` runs on, the serve
    layer's fallback and its bisection oracle. It has no asynchronous
    contract and no device hash. Points are affine tuples (None is the
    identity), scalars Python ints; every verdict is the spec's."""

    name = "spec"

    @staticmethod
    def msm_g1_shared(bases, scalars_batch):
        return [g1.msm(bases, row) for row in scalars_batch]

    @staticmethod
    def msm_g2_shared(bases, scalars_batch):
        return [g2.msm(bases, row) for row in scalars_batch]

    @staticmethod
    def msm_g1_distinct(points_batch, scalars_batch):
        return [g1.msm(pts, row) for pts, row in zip(points_batch, scalars_batch)]

    @staticmethod
    def msm_g2_distinct(points_batch, scalars_batch):
        return [g2.msm(pts, row) for pts, row in zip(points_batch, scalars_batch)]

    @staticmethod
    def pairing_product_is_one(pairs_batch):
        """[B] rows of (G1, G2) pairs -> [B] bools: prod e(P, Q) == 1."""
        return [_pairing.pairing_check(row) for row in pairs_batch]

    # -- composed verify (coconut_tpu/backend.py CurveBackend) ---------------

    def verify_accumulators(self, vk, messages_list, params):
        """X_tilde * prod Y_j^{m_j} per credential, one shared-base MSM in
        the other group: bases [X_tilde, Y_1..Y_q], scalars [1, m]."""
        bases = [vk.X_tilde] + list(vk.Y_tilde)
        scalars = [[1] + [m % R for m in msgs] for msgs in messages_list]
        if params.ctx.name == "G1":
            return self.msm_g2_shared(bases, scalars)
        return self.msm_g1_shared(bases, scalars)

    def batch_verify_pairs(self, sig_pairs, params):
        """[B] rows of (signature-group point, other-group point) pairs ->
        [B] bools, in the (G1, G2) order the ctx implies."""
        if params.ctx.name == "G1":
            ordered = [[(s, o) for s, o in row] for row in sig_pairs]
        else:
            ordered = [[(o, s) for s, o in row] for row in sig_pairs]
        return self.pairing_product_is_one(ordered)

    def batch_verify(self, sigs, messages_list, vk, params):
        """[B] PS verifications under one verkey -> [B] bools: an identity
        sigma_1 is False, else e(sigma_1, acc) * e(-sigma_2, g_tilde) == 1."""
        accs = self.verify_accumulators(vk, messages_list, params)
        sig_ops = params.ctx.sig
        rows = [
            [(s.sigma_1, acc), (sig_ops.neg(s.sigma_2), params.g_tilde)]
            for s, acc in zip(sigs, accs)
        ]
        bits = self.batch_verify_pairs(rows, params)
        metrics.count("verify_final_exps", len(rows))
        return [bool(b) and s.sigma_1 is not None for b, s in zip(bits, sigs)]

    def _msm_sig_distinct(self, params, points_batch, scalars_batch):
        if params.ctx.name == "G1":
            return self.msm_g1_distinct(points_batch, scalars_batch)
        return self.msm_g2_distinct(points_batch, scalars_batch)

    def batch_verify_combined(self, sigs, messages_list, vk, params, rs=None, epoch=None):
        """ONE bool for the batch by the random linear combination
        prod_i e(r_i sigma_1_i, acc_i) * e(sum_i r_i (-sigma_2_i), g_tilde)
        == 1, one shared final exponentiation; `rs=None` derives the r_i
        from the batch transcript (batchverify.py)."""
        metrics.count("verify_batched_checks")
        B = len(sigs)
        if B == 0:
            return True
        if any(s.sigma_1 is None or s.sigma_2 is None for s in sigs):
            return False
        if rs is None:
            from .batchverify import derive_combiners, verify_transcript

            rs = derive_combiners(
                verify_transcript(sigs, messages_list, vk, params, epoch=epoch), B
            )
        elif len(rs) != B:
            raise ValueError(
                "combiner count mismatch: %d exponents, %d lanes" % (len(rs), B)
            )
        accs = self.verify_accumulators(vk, messages_list, params)
        sig_ops = params.ctx.sig
        s1r = self._msm_sig_distinct(params, [[s.sigma_1] for s in sigs], [[r] for r in rs])
        (z,) = self._msm_sig_distinct(
            params, [[sig_ops.neg(s.sigma_2) for s in sigs]], [list(rs)]
        )
        row = list(zip(s1r, accs)) + [(z, params.g_tilde)]
        ok = self.batch_verify_pairs([row], params)[0]
        metrics.count("verify_final_exps", 1)
        return bool(ok)


def _async_pair(backend, dispatch_name, wait_name):
    dispatch = getattr(backend, dispatch_name, None)
    wait = getattr(backend, wait_name, None)
    if dispatch is None or wait is None:
        return None
    return dispatch, wait


def async_shared_many_api(backend, group):
    """(dispatch, wait) of the shared-base multi-MSM program in `group`
    ("g1" / "g2"), or None."""
    return _async_pair(backend, "msm_%s_shared_many_async" % group, "msm_shared_many_wait")


def async_distinct_api(backend, group):
    """(dispatch, wait) of the distinct-base MSM program, or None."""
    return _async_pair(backend, "msm_%s_distinct_async" % group, "msm_distinct_wait")


def async_distinct_plus_offset_api(backend, group):
    """(dispatch, wait) of the distinct MSM with a per-lane affine offset
    (affine(offset_i + MSM_i), the offset one job of a shared-many handle,
    consumed on the device), or None."""
    return _async_pair(
        backend, "msm_%s_distinct_plus_offset_async" % group, "msm_distinct_wait"
    )


_REGISTRY = {}


def register_backend(name, factory):
    """Make `factory()` what get_backend(name) returns."""
    _REGISTRY[name] = factory


def _torch_backend():
    from .gpu.backend import TorchBackend

    return TorchBackend()


def get_backend(name):
    """Instantiate a backend by registry name: "torch" (a TorchBackend on
    `cuda`), "spec" or "python" (SpecBackend), or a registered name."""
    factory = _REGISTRY.get(name)
    if factory is None:
        raise ValueError("unknown backend %r" % (name,))
    return factory()


register_backend("torch", _torch_backend)
register_backend("spec", SpecBackend)
register_backend("python", SpecBackend)
