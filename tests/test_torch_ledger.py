"""The port's ledger verify (`coconut_tpu_torch.stream.verify_ledger`)
against the plain reference of a ledger's semantics
(`portbench/reference/ledger.py`: every record judged under its own
issuer's signing key, in ledger order; it imports nothing of the program).

A tiny ledger over four issuers of 2, 5, 5 and 8 attributes (two of them
sharing a count) under one params, made by the benchmark's own
construction (`portbench/harness/ledger.py`) from a seed, runs through a
CPU `TorchBackend` in issuer batches of 8: one full batch and four padded
tails, forged lanes among them. The verdicts in ledger order equal the
reference's, padded lanes never reach `on_segment`, a resume from a
mid-ledger checkpoint gives the same verdicts, and a one-issuer ledger
gives `verify_stream`'s bits. Stub backends check the routing, the
padding classes, the grouped mode and the checkpoint's fingerprint
without a pairing. Tolerance: exact.
"""

import os
import shutil
from types import SimpleNamespace

import pytest
import torch

from coconut_tpu_torch import metrics
from coconut_tpu_torch.errors import CheckpointMismatchError
from coconut_tpu_torch.gpu.backend import TorchBackend
from coconut_tpu_torch.serve.batcher import PAD_CREDENTIAL
from coconut_tpu_torch.stream import (
    StreamState, ledger_fingerprint, verify_ledger, verify_stream,
)
from portbench.harness import convert
from portbench.harness import ledger as pools
from portbench.harness.traffic import forge as _forge
from portbench.reference import ledger as reference

SEED = 2**31 + 2101
SCHEMAS = {"a": 2, "b": 5, "c": 5, "d": 8}
BATCH = 8
#: the ledger: segments of (issuer, pool index, forged attribute or None);
#: "a" fills one batch in segment 2 and leaves a tail of one, the others
#: leave tails of 2-3
LEDGER = [
    [("a", 0, None), ("a", 1, 1), ("b", 0, None), ("c", 0, 4), ("d", 0, None), ("a", 2, None), ("a", 3, None)],
    [("a", 4, 0), ("b", 1, None), ("a", 5, None), ("d", 1, 7), ("a", 0, None), ("c", 1, None)],
    [("a", 1, None), ("d", 2, None), ("b", 2, 2), ("a", 2, None)],
]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers on one machine,
    and these small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def deployment():
    """The issuers' plain pools (ints, discrete logs) and the program's
    objects made from them, and one CPU backend for every run."""
    ids = sorted(SCHEMAS)
    plain = pools._pools(SEED, 6, [SCHEMAS[i] for i in ids])
    issuers = dict(zip(ids, plain["issuers"]))
    sigs = {i: [convert.signature(s1, s2) for s1, s2, _ in iss["creds"]] for i, iss in issuers.items()}
    return SimpleNamespace(
        plain=plain, issuers=issuers, sigs=sigs,
        params=convert.params(plain),
        verkeys={i: convert.verkey(iss) for i, iss in issuers.items()},
        backend=TorchBackend(device="cpu", comb_window=4),
    )


def _source(dep, ledger=LEDGER):
    def source(i):
        return [
            (dep.sigs[iid][p], _forge(dep.issuers[iid]["creds"][p][2], attr), iid)
            for iid, p, attr in ledger[i]
        ]

    return source


def _expected(dep, ledger=LEDGER):
    """The reference's verdicts, segment by segment, in ledger order."""
    keys = {i: iss["sk"] for i, iss in dep.issuers.items()}
    return [
        reference.verdicts_exp(
            [(iid, dep.issuers[iid]["logs"][p], _forge(dep.issuers[iid]["creds"][p][2], attr))
             for iid, p, attr in seg],
            keys,
        )
        for seg in ledger
    ]


class Spy:
    """Records each dispatch's issuer, width and padding, then runs the
    wrapped backend's."""

    def __init__(self, inner, verkeys):
        self.inner, self.calls = inner, []
        self.names = {id(vk): i for i, vk in verkeys.items()}

    def batch_verify_async(self, sigs, msgs, vk, params, pad_bases_to=None):
        self.calls.append((self.names[id(vk)], len(sigs), sum(s is PAD_CREDENTIAL for s in sigs), pad_bases_to))
        return self.inner.batch_verify_async(sigs, msgs, vk, params, pad_bases_to=pad_bases_to)


@pytest.fixture(scope="module")
def full_run(deployment, tmp_path_factory):
    """The whole ledger once, with a copy of the checkpoint taken as
    segment 0 is delivered (the resume test starts from it)."""
    tmp = tmp_path_factory.mktemp("ledger")
    state_path, mid = str(tmp / "state.json"), str(tmp / "mid.json")
    spy = Spy(deployment.backend, deployment.verkeys)
    delivered = []

    def on_segment(i, verdicts):
        if i == 1:
            shutil.copy(state_path, mid)
        delivered.append((i, verdicts))

    before = metrics.counters_with_prefix("ledger_")
    state = verify_ledger(
        _source(deployment), len(LEDGER), deployment.verkeys, deployment.params, spy,
        batch=BATCH, state_path=state_path, on_segment=on_segment,
    )
    after = metrics.counters_with_prefix("ledger_")
    counts = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    return SimpleNamespace(state=state, delivered=delivered, calls=spy.calls, counts=counts, mid=mid, tmp=tmp)


def test_verdicts_in_ledger_order_equal_the_reference(deployment, full_run):
    want = _expected(deployment)
    assert [i for i, _ in full_run.delivered] == [0, 1, 2]
    assert [v for _, v in full_run.delivered] == want
    assert any(not v for seg in want for v in seg) and any(v for seg in want for v in seg)
    ok = sum(v for seg in want for v in seg)
    state = full_run.state
    assert (state.next_batch, state.verified, state.failed) == (3, ok, 17 - ok)


def test_padded_lanes_never_reach_on_segment(full_run):
    """Every batch is 8 wide; the tails' identity lanes are counted and
    dispatched, and no segment reports more verdicts than it has records."""
    assert [len(v) for _, v in full_run.delivered] == [len(seg) for seg in LEDGER]
    assert all(width == BATCH for _, width, _, _ in full_run.calls)
    pads = sum(pad for _, _, pad, _ in full_run.calls)
    assert pads == len(full_run.calls) * BATCH - 17
    assert full_run.counts == {
        "ledger_dispatches": len(full_run.calls), "ledger_lanes": len(full_run.calls) * BATCH,
        "ledger_pad_lanes": pads,
    }


def test_issuers_are_batched_and_padded_by_class(full_run):
    """"a" fills a batch in segment 2, before any tail; the tails follow in
    issuer order. The default classes are 9 bases (the largest) and 5:
    "a" (3 bases) pads to 5, the others to 9."""
    assert full_run.calls == [
        ("a", 8, 0, 5), ("a", 8, 7, 5), ("b", 8, 5, 9), ("c", 8, 6, 9), ("d", 8, 5, 9),
    ]


def test_resume_from_a_mid_ledger_checkpoint_gives_the_same_verdicts(deployment, full_run):
    state_path = str(full_run.tmp / "resume.json")
    shutil.copy(full_run.mid, state_path)
    assert StreamState(state_path).next_batch == 1
    delivered = []
    state = verify_ledger(
        _source(deployment), len(LEDGER), deployment.verkeys, deployment.params,
        deployment.backend, batch=BATCH, state_path=state_path,
        on_segment=lambda i, v: delivered.append((i, v)),
    )
    assert delivered == full_run.delivered[1:]
    assert (state.next_batch, state.verified, state.failed) == (
        3, full_run.state.verified, full_run.state.failed,
    )


def test_one_issuer_ledger_equals_verify_streams_bits(deployment):
    """A ledger of one issuer and one batch, whose verkey's largest class
    is its own base count, gives what verify_stream gives: the same
    bits."""
    seg = [("d", p, attr) for p, attr in ((0, None), (1, 3), (2, None), (3, None), (4, 0), (5, None), (0, 5), (1, None))]
    source = _source(deployment, [seg])
    records = source(0)
    vk = {"d": deployment.verkeys["d"]}
    got = []
    verify_ledger(source, 1, vk, deployment.params, deployment.backend, batch=BATCH,
                  on_segment=lambda i, v: got.append(v))
    bits = []
    verify_stream(lambda i: ([r[0] for r in records], [r[1] for r in records]), 1, vk["d"],
                  deployment.params, deployment.backend, on_batch=lambda i, b: bits.append(b))
    assert got == bits == _expected(deployment, [seg])


# --- routing, padding and the checkpoint, on stub backends -------------------


class Stub:
    """Verdicts from a flag on each credential, as a readback would settle;
    records what each dispatch got."""

    def __init__(self):
        self.calls = []

    def batch_verify_async(self, sigs, msgs, vk, params, pad_bases_to=None):
        self.calls.append((vk.name, len(sigs), pad_bases_to))
        return lambda: [getattr(s, "ok", False) for s in sigs]

    def batch_verify_grouped(self, sigs, msgs, vk, params):
        self.calls.append((vk.name, len(sigs), "grouped"))
        return all(getattr(s, "ok", False) for s in sigs)


def _vk(name, attrs):
    return SimpleNamespace(name=name, X_tilde=name, Y_tilde=[name] * attrs)


VERKEYS = {"x": _vk("x", 2), "y": _vk("y", 4), "z": _vk("z", 8)}


def _stub_ledger(n_segments=6, per=5, seed=3):
    """Segments of `per` records over VERKEYS, the issuer and the verdict
    of each drawn from `seed`."""
    import random

    rng = random.Random(seed)
    return [
        [(SimpleNamespace(sigma_1=1, sigma_2=1, ok=rng.random() > 0.25), [0] * len(VERKEYS[k].Y_tilde), k)
         for k in rng.choices(sorted(VERKEYS), k=per)]
        for _ in range(n_segments)
    ]


def test_stub_ledger_is_delivered_in_order_with_each_records_verdict():
    segs = _stub_ledger()
    out = []
    be = Stub()
    state = verify_ledger(lambda i: segs[i], len(segs), VERKEYS, None, be, batch=4,
                          on_segment=lambda i, v: out.append((i, v)))
    assert out == [(i, [r[0].ok for r in seg]) for i, seg in enumerate(segs)]
    assert state.verified + state.failed == sum(len(s) for s in segs)
    assert all(width == 4 for _, width, _ in be.calls)
    assert {(name, pad) for name, _, pad in be.calls} <= {("x", 5), ("y", 5), ("z", 9)}


@pytest.mark.parametrize("pipeline_depth, prefetch_depth", [(3, 2), (3, 0), (1, 0)])
def test_stub_ledger_is_the_same_at_any_depth(pipeline_depth, prefetch_depth):
    segs = _stub_ledger(seed=7)
    out = []
    verify_ledger(lambda i: segs[i], len(segs), VERKEYS, None, Stub(), batch=3,
                  on_segment=lambda i, v: out.append(v), pipeline_depth=pipeline_depth,
                  prefetch_depth=prefetch_depth)
    assert out == [[r[0].ok for r in seg] for seg in segs]


def test_transient_failures_are_retried_and_then_fall_back():
    """The ledger's batches ride verify_stream's retry policy and fallback:
    a dispatch that fails every other time is retried, one that always
    fails settles on the fallback backend, and the verdicts stay exact."""
    from coconut_tpu_torch.errors import TransientBackendError
    from coconut_tpu_torch.retry import RetryPolicy

    class Flaky(Stub):
        def batch_verify_async(self, sigs, msgs, vk, params, pad_bases_to=None):
            self.calls.append(pad_bases_to)
            if len(self.calls) % self.every == 0:
                raise TransientBackendError("flaky")
            return lambda: [getattr(s, "ok", False) for s in sigs]

    class Spec:
        def batch_verify(self, sigs, msgs, vk, params):
            return [getattr(s, "ok", False) for s in sigs]

    segs = _stub_ledger(seed=17)
    want = [[r[0].ok for r in seg] for seg in segs]
    retries = metrics.get_count("retries")
    be, out = Flaky(), []
    be.every = 2
    verify_ledger(lambda i: segs[i], len(segs), VERKEYS, None, be, batch=4,
                  on_segment=lambda i, v: out.append(v),
                  retry_policy=RetryPolicy(max_attempts=3, base_delay=0.0))
    assert out == want and metrics.get_count("retries") > retries
    be, out = Flaky(), []
    be.every = 1
    verify_ledger(lambda i: segs[i], len(segs), VERKEYS, None, be, batch=4,
                  on_segment=lambda i, v: out.append(v), fallback_backend=Spec())
    assert out == want


def test_a_synchronous_backend_settles_the_ledger_in_order():
    """A backend with no batch_verify_async verifies each issuer batch
    where it is dispatched (batch_verify, no pipelining), padded tails
    included; the verdicts are the same."""

    class Sync:
        def __init__(self):
            self.widths = []

        def batch_verify(self, sigs, msgs, vk, params):
            self.widths.append(len(sigs))
            return [getattr(s, "ok", False) for s in sigs]

    segs = _stub_ledger(seed=5)
    be, out = Sync(), []
    verify_ledger(lambda i: segs[i], len(segs), VERKEYS, None, be, batch=4,
                  on_segment=lambda i, v: out.append(v))
    assert out == [[r[0].ok for r in seg] for seg in segs]
    assert be.widths and all(w == 4 for w in be.widths)


def test_grouped_mode_gives_each_record_its_batchs_verdict_unpadded():
    segs = _stub_ledger(seed=11)
    be = Stub()
    out = []
    verify_ledger(lambda i: segs[i], len(segs), VERKEYS, None, be, batch=4, mode="grouped",
                  on_segment=lambda i, v: out.extend(v))
    records = [r for seg in segs for r in seg]
    assert len(out) == len(records)
    assert all(kind == "grouped" and width <= 4 for _, width, kind in be.calls)
    assert sum(width for _, width, _ in be.calls) == len(records)
    assert any(v != r[0].ok for v, r in zip(out, records))  # a failed batch fails its honest records


def test_empty_segments_and_an_unknown_issuer():
    segs = [[], _stub_ledger(1, 3)[0], []]
    out = []
    verify_ledger(lambda i: segs[i], 3, VERKEYS, None, Stub(), batch=4,
                  on_segment=lambda i, v: out.append((i, len(v))))
    assert out == [(0, 0), (1, 3), (2, 0)]
    bad = [[(SimpleNamespace(sigma_1=1, sigma_2=1, ok=True), [0, 0], "w")]]
    with pytest.raises(ValueError, match="issuer 'w'"):
        verify_ledger(lambda i: bad[i], 1, VERKEYS, None, Stub(), batch=4)
    with pytest.raises(ValueError):
        verify_ledger(lambda i: [], 1, {}, None, Stub())
    with pytest.raises(ValueError):
        verify_ledger(lambda i: [], 1, VERKEYS, None, Stub(), batch=0)


def test_a_checkpoint_under_another_issuer_set_is_refused(tmp_path):
    """A crash inside on_segment leaves the checkpoint of the segments
    before it; a resume under the same issuers re-runs from there, one
    under another issuer set, or another verkey for one issuer, raises."""
    segs = _stub_ledger(seed=13)
    path = str(tmp_path / "state.json")

    class Crash(Exception):
        pass

    def crash_at_3(i, v):
        if i == 3:
            raise Crash

    with pytest.raises(Crash):
        verify_ledger(lambda i: segs[i], len(segs), VERKEYS, None, Stub(), batch=4,
                      state_path=path, on_segment=crash_at_3)
    assert StreamState(path).next_batch == 3
    for other in (
        {k: v for k, v in VERKEYS.items() if k != "z"},
        dict(VERKEYS, z=_vk("z2", 8)),
        dict(VERKEYS, w=_vk("w", 3)),
    ):
        with pytest.raises(CheckpointMismatchError):
            verify_ledger(lambda i: segs[i], len(segs), other, None, Stub(), batch=4, state_path=path)
    with pytest.raises(CheckpointMismatchError):
        verify_ledger(lambda i: segs[i], len(segs), VERKEYS, None, Stub(), batch=4,
                      state_path=path, mode="grouped")
    out = []
    verify_ledger(lambda i: segs[i], len(segs), VERKEYS, None, Stub(), batch=4, state_path=path,
                  on_segment=lambda i, v: out.append(i))
    assert out == [3, 4, 5]
    assert os.path.exists(path) and StreamState(path).next_batch == len(segs)


def test_fingerprint_digests_every_issuer_and_verkey():
    fp = ledger_fingerprint("per_credential", VERKEYS)
    assert fp == ledger_fingerprint("per_credential", dict(reversed(list(VERKEYS.items()))))
    assert fp != ledger_fingerprint("grouped", VERKEYS)
    assert fp != ledger_fingerprint("per_credential", dict(VERKEYS, y=_vk("y", 5)))
    assert fp != ledger_fingerprint("per_credential", {"x2": VERKEYS["x"], "y": VERKEYS["y"], "z": VERKEYS["z"]})
