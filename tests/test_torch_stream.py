"""The port's `verify_stream` (`coconut_tpu_torch.stream`, with its
checkpoint, retry, fault and dead-letter layers) against the JAX
package's.

Each scenario drives both packages' `verify_stream` over the same stub
backends and the same credential source, and requires equal per-batch
results, tallies, counters of each package's own metrics registry,
dead-letter records (trace and span ids masked) and checkpoint files byte
for byte (a checkpoint holds no time). The stubs decide verdicts from a
flag on each credential, so no pairing runs; the last test streams real
credentials through `TorchBackend(device="cpu")`. JaxBackend is never
built. Tolerance: exact.
"""

import json
from types import SimpleNamespace

import pytest

from test_torch_serve import _counters, _credentials, _lane_bit, _pkg, _run_both

BATCH = 4
BAD = {(1, 2), (3, 0)}  # (batch, lane) of the forged credentials


class StubSync:
    def batch_verify(self, sigs, msgs, vk, params):
        return [_lane_bit(s) for s in sigs]


class StubAsync:
    """The *_async seam: the finalizer computes, as a device readback
    would settle."""

    def batch_verify_async(self, sigs, msgs, vk, params):
        return lambda: [_lane_bit(s) for s in sigs]


class StubGrouped:
    def batch_verify_grouped(self, sigs, msgs, vk, params):
        return all(_lane_bit(s) for s in sigs)

    def batch_verify(self, sigs, msgs, vk, params):
        return [_lane_bit(s) for s in sigs]


class Stop(Exception):
    """A simulated kill between batches."""


def _source(stop_at=None, bad=BAD):
    def source(i):
        if i == stop_at:
            raise Stop("stopped before batch %d" % i)
        sigs = [
            SimpleNamespace(sigma_1=1, sigma_2=1, ok=(i, j) not in bad)
            for j in range(BATCH)
        ]
        return sigs, [[i, j] for j in range(BATCH)]

    return source


def _tallies(state):
    return (state.next_batch, state.verified, state.failed, state.batches_ok, state.batches_failed)


# --- scenarios ---------------------------------------------------------------


def _plain(backend, pipeline, depth):
    def scenario(pkg, d):
        path = d / "state.json"
        seen = []
        state = pkg.stream.verify_stream(
            _source(), 5, None, None, backend(), state_path=str(path),
            on_batch=lambda i, r: seen.append((i, r)), pipeline=pipeline,
            pipeline_depth=depth,
        )
        return {
            "seen": seen, "tallies": _tallies(state), "checkpoint": path.read_bytes(),
            "counters": _counters(pkg),
        }

    return scenario


def resume_after_stop(pkg, d):
    path = str(d / "state.json")
    with pytest.raises(Stop):
        pkg.stream.verify_stream(_source(stop_at=2), 4, None, None, StubSync(), state_path=path)
    mid = open(path, "rb").read()
    seen = []
    state = pkg.stream.verify_stream(
        _source(), 4, None, None, StubSync(), state_path=path,
        on_batch=lambda i, r: seen.append((i, r)),
    )
    return {
        "mid": mid, "seen": seen, "tallies": _tallies(state),
        "checkpoint": open(path, "rb").read(), "counters": _counters(pkg),
    }


def corrupt_quarantined(pkg, d):
    path = d / "state.json"
    path.write_bytes(b'{"schema": 2, "crc32": 7, "payl')
    state = pkg.stream.verify_stream(_source(), 2, None, None, StubSync(), state_path=str(path))
    return {
        "quarantined": state.quarantined is not None
        and state.quarantined.endswith("state.json.corrupt"),
        "moved": (d / "state.json.corrupt").read_bytes(),
        "tallies": _tallies(state),
        "checkpoint": path.read_bytes(),
        "counters": _counters(pkg),
    }


def mode_change_refused(pkg, d):
    path = str(d / "state.json")
    pkg.stream.verify_stream(_source(), 1, None, None, StubSync(), state_path=path)
    with pytest.raises(pkg.errors.CheckpointMismatchError) as ei:
        pkg.stream.verify_stream(
            _source(), 2, None, None, StubGrouped(), state_path=path, mode="grouped"
        )
    return {"error": (type(ei.value).__name__, str(ei.value)), "checkpoint": open(path, "rb").read()}


def grouped_bisected(pkg, d):
    path, dl = d / "state.json", d / "dead.jsonl"
    seen = []
    state = pkg.stream.verify_stream(
        _source(), 4, None, None, StubGrouped(), state_path=str(path), mode="grouped",
        dead_letter_path=str(dl), on_batch=lambda i, r: seen.append((i, r)),
    )
    recs = [dict(r, trace_id=None, span_id=None) for r in pkg.faults.DeadLetterLog.read(str(dl))]
    return {
        "seen": seen, "tallies": _tallies(state), "dead_letters": recs,
        "checkpoint": path.read_bytes(), "counters": _counters(pkg),
    }


def retry_then_fallback(pkg, d):
    """raise_every=2 under a 2-attempt policy: batches whose retry also
    lands on a faulted dispatch go to the fallback."""
    path = d / "state.json"
    sleeps = []
    policy = pkg.retry.RetryPolicy(max_attempts=2, base_delay=0.01, sleep=sleeps.append)
    be = pkg.faults.FaultyBackend(StubSync(), raise_every=2)
    state = pkg.stream.verify_stream(
        _source(), 5, None, None, be, state_path=str(path), retry_policy=policy,
        fallback_backend=StubSync(),
    )
    return {
        "tallies": _tallies(state), "sleeps": sleeps, "dispatches": be.dispatches,
        "checkpoint": path.read_bytes(), "counters": _counters(pkg),
    }


SCENARIOS = {
    "sync": _plain(StubSync, True, 3),
    "pipelined_depth_1": _plain(StubAsync, True, 1),
    "pipelined_depth_3": _plain(StubAsync, True, 3),
    "async_unpipelined": _plain(StubAsync, False, 3),
    "resume_after_stop": resume_after_stop,
    "corrupt_quarantined": corrupt_quarantined,
    "mode_change_refused": mode_change_refused,
    "grouped_bisected": grouped_bisected,
    "retry_then_fallback": retry_then_fallback,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_stream_matches_the_reference(name, tmp_path):
    ref, port = _run_both(SCENARIOS[name], tmp_path)
    assert port == ref


def test_sync_and_pipelined_agree_and_tallies_are_exact(tmp_path):
    pkg = _pkg("coconut_tpu_torch")
    outs = []
    for k, (backend, pipeline, depth) in enumerate(
        [(StubSync, True, 3), (StubAsync, True, 1), (StubAsync, True, 3), (StubAsync, False, 2)]
    ):
        (tmp_path / str(k)).mkdir()
        pkg.metrics.reset()
        outs.append(_plain(backend, pipeline, depth)(pkg, tmp_path / str(k)))
    pkg.metrics.reset()
    assert all(o["seen"] == outs[0]["seen"] for o in outs)
    assert all(o["checkpoint"] == outs[0]["checkpoint"] for o in outs)
    assert outs[0]["tallies"] == (5, 18, 2, 0, 0)
    assert outs[1]["counters"]["prefetched_batches"] == 5


def test_checkpoint_schema_and_resume_pinned(tmp_path):
    pkg = _pkg("coconut_tpu_torch")
    got = resume_after_stop(pkg, tmp_path)
    pkg.metrics.reset()
    doc = json.loads(got["mid"])
    assert doc["schema"] == 2 and doc["payload"]["next_batch"] == 2
    assert got["seen"] == [(2, [True] * 4), (3, [False, True, True, True])]
    assert got["tallies"] == (4, 14, 2, 0, 0)
    (tmp_path / "g").mkdir()
    got = grouped_bisected(pkg, tmp_path / "g")
    pkg.metrics.reset()
    assert got["tallies"] == (4, 14, 2, 2, 2)
    assert [(r["batch"], r["credential"]) for r in got["dead_letters"]] == [(1, 2), (3, 0)]


def test_stream_refuses_a_mesh_and_defaults_to_cuda():
    import torch

    from coconut_tpu_torch.stream import verify_stream

    with pytest.raises(ValueError, match="not ported"):
        verify_stream(_source(), 1, None, None, StubSync(), mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            verify_stream(_source(), 1, None, None, None)


def test_stream_over_torch_cpu_matches_the_spec(tmp_path):
    """verify_stream(TorchBackend(device="cpu")) over one batch of real
    credentials, one forged: bits and tallies equal the JAX package's
    PythonBackend on the same credentials, and the checkpoint records the
    batch."""
    from coconut_tpu.backend import PythonBackend
    from coconut_tpu_torch import convert
    from coconut_tpu_torch.gpu.backend import TorchBackend
    from coconut_tpu_torch.stream import verify_stream

    params, vk, sigs, msgs = _credentials(3, forged={2}, seed=0x57E4)
    want = PythonBackend().batch_verify(sigs, msgs, vk, params)
    assert want == [True, True, False]
    pparams, pvk = convert.params_from(params), convert.verkey_from(vk)
    psigs = [convert.signature_from(s) for s in sigs]
    path = tmp_path / "s.json"
    seen = []
    state = verify_stream(
        lambda i: (psigs, msgs), 1, pvk, pparams,
        TorchBackend(device="cpu", comb_window=4), state_path=str(path),
        on_batch=lambda i, r: seen.append(r),
    )
    assert seen == [want]
    assert _tallies(state) == (1, 2, 1, 0, 0)
    assert json.loads(path.read_bytes())["payload"]["next_batch"] == 1
