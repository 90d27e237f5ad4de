"""Sharded batch verification and issuance over a (dp, tp) device mesh — the
port of `coconut_tpu/tpu/shard.py`, with its names, padding rules and
error messages.

  - **dp** (data parallelism): the credential batch is split over the
    mesh's ``dp`` axis, each device verifying its slice.
  - **tp** (the sharded MSM): the shared-base comb MSM of each verification
    is split over the ``tp`` axis by base index; each device computes a
    partial MSM over its bases, the partials are combined with complete
    Jacobian adds (point addition is not a ring sum), then the pairing
    tail runs on the dp slice.

One controller drives every device, as one `jax.jit` of a `shard_map`
does: a program here is a sequence of explicit phases, not an emulated
shard_map.

  1. split the operands by the reference's in_specs;
  2. run each shard's local program on its device (every shard is
     enqueued before any combine, so distinct cards overlap);
  3. copy the partials to the lead device of their dp row (the
     reference's all_gather; a no-op where the shards share a card);
  4. combine them with `curve.jadd` in the reference's order, take(0)
     then take(1..n-1), so the limbs are the reference's;
  5. run the tail once on the lead.

The grouped program's psum of the death flag is an OR over the shards.
Every entry point holds `serial.DEVICE_LOCK` for its whole length, as every
backend call does.

A `Mesh` is a grid of `torch.device`; one card may stand at several places
of it (logical shards, run one after another on that card). The same code
takes distinct cards where they exist.
"""

import contextlib

import numpy as np
import torch

from . import backend as bk
from . import curve as cv
from . import tower as tw
from .serial import serialized


class Mesh:
    """Devices in a grid with one name an axis — the port's
    `jax.sharding.Mesh`. `devices` is a numpy object array of
    `torch.device`; `shape` a dict axis -> extent, read as the callers read
    the reference's (`"dp" in mesh.shape`, `mesh.shape["dp"]`)."""

    def __init__(self, devices, axis_names):
        arr = np.array(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(
                "mesh of %d dimensions with %d axis names" % (arr.ndim, len(axis_names))
            )
        self.devices = np.vectorize(torch.device, otypes=[object])(arr)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))


def require_axes(mesh, *axes):
    """Check that `mesh` names every axis in `axes`, with a clear error up
    front instead of a bare KeyError from mesh.shape['tp'] deep inside the
    first batch's dispatch."""
    missing = [a for a in axes if a not in mesh.shape]
    if missing:
        raise ValueError(
            "mesh is missing axis(es) %s: it has %s; build the mesh with "
            "shard.default_mesh() or Mesh(devices, ('dp', 'tp'))"
            % (
                ", ".join(repr(a) for a in missing),
                tuple(mesh.shape) or "no axes",
            )
        )


# --- the phases -----------------------------------------------------------------


def _grid(mesh, *axes):
    """The mesh's devices with `axes` leading in that order and index 0 on
    every other axis (the reference replicates over those), as nested
    lists."""
    names = list(mesh.axis_names)
    lead = [names.index(a) for a in axes]
    arr = np.transpose(mesh.devices, lead + [i for i in range(len(names)) if i not in lead])
    while arr.ndim > len(axes):
        arr = arr[..., 0]
    return arr.tolist()


def _on(dev):
    """`dev` as the current CUDA device (tensors a program makes without
    naming a device land there); nothing elsewhere."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _to(tree, dev):
    return tw.tree_map(lambda t: t.to(dev), tree)


def _cut(tree, sl, dim=0):
    return tw.tree_map(lambda t: t[(slice(None),) * dim + (sl,)], tree)


def _splits(n, parts, axis):
    """`parts` equal slices of n; an indivisible n raises."""
    if n % parts:
        raise ValueError("size %d not divisible by %s=%d" % (n, axis, parts))
    step = n // parts
    return [slice(i * step, (i + 1) * step) for i in range(parts)]


def _combine(fl, parts, lead):
    """The partials, gathered on `lead` and summed in the reference's
    order: take(0), then jadd of take(1), ..., take(n-1)."""
    parts = [_to(p, lead) for p in parts]
    acc = parts[0]
    with _on(lead):
        for p in parts[1:]:
            acc = cv.jadd(fl, acc, p)
    return acc


def _gather(outs, lead):
    """Per-shard outputs (tensors, or trees of them) concatenated on `lead`
    along the batch axis."""
    return tw.tree_map(lambda *ts: torch.cat([t.to(lead) for t in ts]), *outs)


def make_sharded_verify(mesh, sig_is_g1, batch_axis="dp", msm_axis="tp"):
    """The sharded fused-verify program for `mesh`: operands as
    `TorchBackend.encode_verify_batch` produces them, the base axis padded
    to a multiple of the tp extent and the batch divisible by the dp
    extent. Returns bits [B] on the first device."""
    grid = _grid(mesh, batch_axis, msm_axis)
    acc_fl = bk._fields(sig_is_g1)[1]

    def program(wtables, mag, sgn, s1, s2n, gtx, gty, inf1, inf2):
        B, k = mag.shape[:2]
        rows = _splits(B, len(grid), batch_axis)
        cols = _splits(k, len(grid[0]), msm_axis)
        parts = []
        for lanes, devs in zip(rows, grid):
            row = []
            for bases, dev in zip(cols, devs):
                with _on(dev):
                    row.append(cv.msm_shared_comb(
                        acc_fl, _to(_cut(wtables, bases), dev),
                        mag[lanes, bases].to(dev), sgn[lanes, bases].to(dev),
                    ))
            parts.append(row)
        bits = []
        for lanes, devs, row in zip(rows, grid, parts):
            lead = devs[0]
            acc = _combine(acc_fl, row, lead)
            ops = _to(_cut((s1, s2n, inf1, inf2), lanes), lead)
            with _on(lead):
                bits.append(bk.verify_tail(
                    sig_is_g1, acc, ops[0], ops[1], _to(gtx, lead), _to(gty, lead),
                    ops[2], ops[3],
                ))
        return _gather(bits, grid[0][0])

    return program


def make_sharded_grouped_verify(mesh, sig_is_g1, batch_axis="dp"):
    """The attribute-grouped one-bool verify with the credential batch split
    over the dp axis: each device runs the q+2 shared-point MSMs on its
    slice (backend.grouped_accumulators), the projective accumulators are
    combined on the lead, and the q+2-pair tail runs once with the death
    flag OR-ed over the shards, so any shard's identity lane fails the
    batch. Returns a bool [] on the lead."""
    devs = _grid(mesh, batch_axis)
    sig_fl = bk._fields(sig_is_g1)[0]

    def program(s1, s2n, inf1, inf2, cmag, csgn, rmag, rsgn, ox, oy, gtx, gty):
        parts, dead = [], []
        for lanes, dev in zip(_splits(inf1.shape[0], len(devs), batch_axis), devs):
            p1, p2, i1, i2 = _to(_cut((s1, s2n, inf1, inf2), lanes), dev)
            digits = _to(_cut((cmag, csgn, rmag, rsgn), lanes, dim=1), dev)
            with _on(dev):
                parts.append(bk.grouped_accumulators(sig_fl, p1, p2, i1, i2, *digits))
                dead.append((i1 | i2).any())
        lead = devs[0]
        allacc = _combine(sig_fl, parts, lead)
        any_dead = torch.stack([d.to(lead) for d in dead]).any()
        with _on(lead):
            return bk.grouped_tail(sig_is_g1, allacc, *_to((ox, oy, gtx, gty), lead), any_dead)

    return program


@serialized
def batch_verify_grouped_sharded(
    backend, sigs, messages_list, vk, params, mesh, batch_axis="dp",
    pad_batch_to=None,
):
    """dp-sharded attribute-grouped batch verify on a mesh: ONE bool for
    the whole batch, same semantics (and 2^-128 soundness) as
    `TorchBackend.batch_verify_grouped`. The batch is padded to a power of
    two divisible by the dp extent (pad_batch_to, default 2x the dp
    extent); per-device slices stay powers of two (the fold requires it)."""
    return batch_verify_grouped_sharded_async(
        backend, sigs, messages_list, vk, params, mesh, batch_axis, pad_batch_to
    )()


@serialized
def batch_verify_grouped_sharded_async(
    backend, sigs, messages_list, vk, params, mesh, batch_axis="dp",
    pad_batch_to=None,
):
    """Pipelined variant of `batch_verify_grouped_sharded`: enqueues the
    sharded grouped program and returns a zero-arg finalizer, so
    `stream.verify_stream` can overlap batch i+1's host encode with batch
    i's device work."""
    require_axes(mesh, batch_axis)
    ndp = mesh.shape[batch_axis]
    if ndp & (ndp - 1):
        raise ValueError("dp extent %d must be a power of two" % ndp)
    if len(sigs) == 0:
        return lambda: True
    if any(s.sigma_1 is None or s.sigma_2 is None for s in sigs):
        return lambda: False
    operands = backend.encode_grouped_batch(
        sigs, messages_list, vk, params,
        pad_batch_to=2 * ndp if pad_batch_to is None else pad_batch_to,
    )
    fn = make_sharded_grouped_verify(mesh, params.ctx.name == "G1", batch_axis)
    ok = fn(*operands)
    return serialized(lambda: bool(ok))


# show verify: which operands of fused_show_verify every device holds whole
# (the comb tables and g_tilde); the rest lead with the batch axis
_SHOW_REPLICATED = frozenset((0, 10, 15, 16))


def make_sharded_show_verify(mesh, sig_is_g1, batch_axis="dp"):
    """dp-sharded batched show verify (config 3 on a mesh): each device runs
    backend.fused_show_verify on its slice of proofs; the bits are per
    proof, so nothing is combined — they gather on the first device."""
    devs = _grid(mesh, batch_axis)

    def program(*ops):
        bits = []
        for lanes, dev in zip(_splits(ops[4].shape[0], len(devs), batch_axis), devs):
            local = [
                _to(op if n in _SHOW_REPLICATED else _cut(op, lanes), dev)
                for n, op in enumerate(ops)
            ]
            with _on(dev):
                bits.append(bk.fused_show_verify(sig_is_g1, *local))
        return _gather(bits, devs[0])

    return program


@serialized
def batch_show_verify_sharded(
    backend, proofs, vk, params, revealed_msgs_list, challenges, mesh,
    batch_axis="dp",
):
    """dp-sharded batched PoKOfSignatureProof.verify on a mesh: [B] bools,
    bit-identical to `TorchBackend.batch_show_verify`. The proof batch must
    divide the dp extent."""
    require_axes(mesh, batch_axis)
    ndp = mesh.shape[batch_axis]
    if len(proofs) % ndp:
        raise ValueError(
            "batch size %d not divisible by %s=%d"
            % (len(proofs), batch_axis, ndp)
        )
    operands = backend.encode_show_verify_batch(
        proofs, vk, params, revealed_msgs_list, challenges
    )
    fn = make_sharded_show_verify(mesh, params.ctx.name == "G1", batch_axis)
    return [bool(b) for b in fn(*operands).cpu().tolist()]


def pad_to_multiple(k, n):
    return ((k + n - 1) // n) * n


class _IdentityLane:
    """Identity-signature pad lane (`sigma_1 is None`): verifies False and
    encodes as the point at infinity, so a pad lane can never flip a real
    lane's verdict — the convention of serve/batcher.PAD_CREDENTIAL and
    `encode_verify_batch(pad_bases_to=...)`."""

    __slots__ = ()
    sigma_1 = None
    sigma_2 = None


PAD_LANE = _IdentityLane()


@serialized
def batch_verify_sharded_async(
    backend, sigs, messages_list, vk, params, mesh, batch_axis="dp",
    msm_axis="tp",
):
    """Pipelined variant of `batch_verify_sharded` ([B] bools, the
    per-credential verdicts): enqueues the sharded program and returns a
    zero-arg finalizer, so `stream.verify_stream(mode='per_credential',
    mesh=...)` can keep the devices busy across the readback.

    A batch that does not divide the dp extent (a stream's last) is padded
    with IDENTITY lanes up to the next multiple and the bits are sliced
    back to the true length, so callers never see the padding."""
    require_axes(mesh, batch_axis, msm_axis)
    ndp = mesh.shape[batch_axis]
    ntp = mesh.shape[msm_axis]
    B = len(sigs)
    if B == 0:
        return lambda: []
    pad = (-B) % ndp
    if pad:
        sigs = list(sigs) + [PAD_LANE] * pad
        messages_list = list(messages_list) + [messages_list[-1]] * pad
    k = 1 + len(vk.Y_tilde)
    operands = backend.encode_verify_batch(
        sigs, messages_list, vk, params, pad_bases_to=pad_to_multiple(k, ntp)
    )
    fn = make_sharded_verify(mesh, params.ctx.name == "G1", batch_axis, msm_axis)
    bits = fn(*operands)
    return serialized(lambda: [bool(b) for b in bits.cpu().tolist()[:B]])


# --- sharded issuance (config 4 on a mesh) ----------------------------------------


def make_sharded_distinct(mesh, is_fp2, with_offset, batch_axis="dp"):
    """dp-sharded distinct-base MSM program (the issuance shape: bases per
    credential) on the Horner schedule, as backend's
    msm_distinct_affine_program / msm_distinct_plus_offset_program. Every
    operand leads with the batch axis, the offset (a PackedPoints) too;
    the packed outputs gather on the first device."""
    devs = _grid(mesh, batch_axis)
    fl = cv.FP2 if is_fp2 else cv.FP

    def program(x, y, inf, mag, sgn, offset=None):
        if with_offset != (offset is not None):
            raise ValueError("offset given to a program built with_offset=%s" % with_offset)
        outs = []
        for lanes, dev in zip(_splits(inf.shape[0], len(devs), batch_axis), devs):
            local = _to(_cut((x, y, inf, mag, sgn), lanes), dev)
            with _on(dev):
                if offset is None:
                    outs.append(bk.msm_distinct_affine_program(fl, *local))
                else:
                    off = bk.PackedPoints(_to(_cut(offset, lanes), dev))
                    outs.append(bk.msm_distinct_plus_offset_program(fl, *local, off))
        return bk.PackedPoints(_gather(outs, devs[0]))

    return program


def make_sharded_shared_many(mesh, is_fp2, njobs, batch_axis="dp"):
    """dp-sharded multi-job shared-base comb MSM (the prepare phase's
    program, backend.msm_shared_many_program): the comb tables are whole on
    every device (fixed bases), the digit arrays split over the batch
    axis. Jobs over one table set stay one comb MSM on each device."""
    devs = _grid(mesh, batch_axis)
    fl = cv.FP2 if is_fp2 else cv.FP

    def program(jobs):
        if len(jobs) != njobs:
            raise ValueError("%d jobs given to a %d-job program" % (len(jobs), njobs))
        outs = []
        for lanes, dev in zip(_splits(jobs[0][1].shape[0], len(devs), batch_axis), devs):
            tables = {}
            local = []
            for wt, mag, sgn in jobs:
                if id(wt) not in tables:
                    tables[id(wt)] = _to(wt, dev)
                local.append((tables[id(wt)], mag[lanes].to(dev), sgn[lanes].to(dev)))
            with _on(dev):
                outs.append(bk.msm_shared_many_program(fl, local))
        return [bk.PackedPoints(_gather(job, devs[0])) for job in zip(*outs)]

    return program


class ShardedIssuanceBackend(bk.TorchBackend):
    """TorchBackend with the issuance-shape MSM programs dp-sharded over a
    mesh, so the protocol drivers — `signature.batch_prepare_blind_sign`,
    `signature.batch_blind_sign`, `signature.batch_unblind`,
    `pok_sig.batch_show` — run unchanged with each device computing its
    slice of the credential batch. Encodes run on the mesh's first device;
    the hash to G1 and the verify entry points are the superclass's (one
    device); use the `batch_verify_*_sharded` drivers for those.

    Row counts must divide the dp extent (the prepare driver's are B and
    B*hidden, so B must be a multiple of ndp); a row count that does not
    raises before any device work. `backend_kw` goes to TorchBackend
    (comb_window, raw_wire)."""

    name = "torch_sharded_issuance"

    def __init__(self, mesh, batch_axis="dp", **backend_kw):
        require_axes(mesh, batch_axis)
        super().__init__(device=mesh.devices.flat[0], **backend_kw)
        self.mesh = mesh
        self.batch_axis = batch_axis

    def _check_rows(self, n):
        ndp = self.mesh.shape[self.batch_axis]
        if n % ndp:
            raise ValueError(
                "row count %d not divisible by %s=%d"
                % (n, self.batch_axis, ndp)
            )

    def _msm_distinct_dispatch(self, is_fp2, points_batch, scalars_batch):
        self._check_rows(len(points_batch))
        ops = self._encode_distinct(is_fp2, points_batch, scalars_batch)
        self.msm_horner_dispatches += 1
        return make_sharded_distinct(self.mesh, is_fp2, False, self.batch_axis)(*ops)

    def _msm_distinct_plus_offset(self, is_fp2, points_batch, scalars_batch, offset_handle):
        self._check_rows(len(points_batch))
        ops = self._encode_distinct(is_fp2, points_batch, scalars_batch)
        self.msm_horner_dispatches += 1
        self.msm_offset_dispatches += 1
        fn = make_sharded_distinct(self.mesh, is_fp2, True, self.batch_axis)
        return fn(*ops, offset_handle)

    def _msm_shared_many_dispatch(self, is_fp2, jobs):
        for _, scalars_batch in jobs:
            self._check_rows(len(scalars_batch))
        operands = [
            (self._comb_tables(is_fp2, bases),) + self._comb_digits(scalars_batch)
            for bases, scalars_batch in jobs
        ]
        fn = make_sharded_shared_many(self.mesh, is_fp2, len(jobs), self.batch_axis)
        return fn(operands)


@serialized
def batch_verify_sharded(
    backend, sigs, messages_list, vk, params, mesh, batch_axis="dp", msm_axis="tp"
):
    """Data+tensor-parallel batch verify on a mesh: [B] bools, bit-identical
    to `TorchBackend.batch_verify` and the spec."""
    return batch_verify_sharded_async(
        backend, sigs, messages_list, vk, params, mesh, batch_axis, msm_axis
    )()


def default_mesh(ndp=None, ntp=1, devices=None):
    """A (dp, tp) mesh over `devices` (dp fills what tp leaves). The
    default is every CUDA card; to lay logical shards on one card, pass it
    more than once (`devices=[torch.device("cuda")] * 4`)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError(
                "no CUDA device is available; pass devices= to lay the mesh "
                "on other devices"
            )
    devices = list(devices)
    n = len(devices)
    if ndp is None:
        ndp = n // ntp
    if ndp * ntp != n:
        raise ValueError("mesh %dx%d != %d devices" % (ndp, ntp, n))
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(ndp, ntp), ("dp", "tp"))
