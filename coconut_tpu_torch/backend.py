"""The host spec backend and the capability probes of the optional
asynchronous MSM contracts — the port's copy of `PythonBackend`'s MSM
surface, `_async_pair`, `async_shared_many_api`, `async_distinct_api` and
`async_distinct_plus_offset_api` (`coconut_tpu/backend.py`). Each dispatch
half is probed together with the wait half that settles its handles, so a
backend that has only one of them is treated as having neither. The
issuance batch functions (`signature.py`) pick their schedule from these.
"""

from .ops.curve import g1, g2


class SpecBackend:
    """The sequential host spec's MSMs, row by row on Python ints (the JAX
    package's PythonBackend): what `backend=ps.SPEC` runs on. It has no
    asynchronous contract and no device hash."""

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
