"""The per-credential verify issued as CUDA graphs (gpu/backend.py
`VerifyGraph`, `_GraphPolicy`).

On the CPU: the capture policy's decisions per shape key (eager, capture,
replay), keys that differ by B, base count or signature assignment kept
apart, the least recently used graph evicted at the cap and counted,
eight issuers of 2-8 attributes made one key by padding the base axis
(two in the ledger's two padding classes), a CPU backend
that never captures, with a stub in place of the capture, the malloc
settings a process's first capture makes, and the one-off work a capture
is marked as: gpu/serial's clock of it, the watchdog's deadlines that it
moves back, and the engine's watchdog reading it.

Marked `gpu`, skipped without a card: replayed bits against the eager
path's and the expected verdicts (G1 and G2, B = 8 and 64, forged and
identity sigma_1 lanes), two batches enqueued back to back before either
is read, the counts of calls 1, 2 and 3 of a key, the launches a replay
credits, a new shape's own graph under the cap, and a mixed ledger
(`stream.verify_ledger`) that captures once a padded key and replays
the rest, its verdicts those of a CPU backend and the plain reference. On a machine with a
card: `python -m pytest tests/test_torch_graph.py -q`. Tolerance: exact.
"""

from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from coconut_tpu_torch import entry, metrics, stream
from coconut_tpu_torch.gpu import backend as bk
from coconut_tpu_torch.gpu import cuda_fp, serial
from coconut_tpu_torch.gpu.backend import TorchBackend
from coconut_tpu_torch.serve import CredentialService
from coconut_tpu_torch.serve.health import Watchdog


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers on one machine,
    and these small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# --- the policy, on the CPU ---------------------------------------------------


def test_policy_runs_eager_then_captures_then_replays():
    policy = bk._GraphPolicy(4)
    assert policy.lookup("k") == ("eager", None)
    assert policy.lookup("k") == ("capture", None)
    graph = object()
    policy.store("k", graph)
    assert policy.lookup("k") == ("replay", graph)
    assert policy.lookup("k") == ("replay", graph)
    assert policy.lookup("other") == ("eager", None)


def test_policy_evicts_the_least_recently_used_graph_at_its_cap():
    policy = bk._GraphPolicy(2)
    graphs = {}
    for key in ("a", "b"):
        policy.lookup(key)
        policy.lookup(key)
        graphs[key] = object()
        policy.store(key, graphs[key])
    assert policy.lookup("a") == ("replay", graphs["a"])  # b is now the oldest
    policy.lookup("c")
    assert policy.lookup("c") == ("capture", None)
    policy.store("c", object())
    assert list(policy.graphs._d) == ["a", "c"]
    assert policy.lookup("b") == ("capture", None)  # seen before: no eager call again
    assert policy.lookup("a") == ("replay", graphs["a"])


def test_keys_part_by_batch_base_count_and_assignment():
    """The key of a batch as the backend encodes it: equal for two batches
    of one shape, apart for another B, another base count and the G2
    assignment."""
    be = TorchBackend(device="cpu", comb_window=4)

    def key(params, vk, sigs, msgs):
        tables, batch = be._verify_parts(sigs, msgs, vk, params)
        return bk._graph_key(None, params.ctx.name == "G1", bk._verify_operands(tables, batch))

    params, _, vk, sigs, msgs = entry.fixture(3)
    same = key(params, vk, sigs[:2], msgs[:2])
    assert key(params, vk, sigs[1:], msgs[1:]) == same
    p2, _, vk2, sigs2, msgs2 = entry.fixture(2, ctx="G2")
    p3, _, vk3, sigs3, msgs3 = entry.fixture(2, msg_count=2)
    keys = [same, key(params, vk, sigs, msgs), key(p2, vk2, sigs2, msgs2), key(p3, vk3, sigs3, msgs3)]
    assert len(set(keys)) == 4


def test_padded_issuers_share_keys_and_the_lru_counts_its_drops(monkeypatch):
    """Eight issuers of 2, 3, 4, 5, 6, 6, 7 and 8 attributes: unpadded their
    batches make seven shape keys, and three rounds of them through a
    policy of four graphs make eleven evictions, each counted in
    `evictions` and in verify_graph_evictions; padded to 9 bases they make
    one key, in the ledger's two classes (5 and 9) two, which the policy
    keeps without an eviction. The comb tables are stubs of the real
    leading shape (a key reads shapes alone)."""
    params, _, vk, sigs, msgs = entry.fixture(2, msg_count=8)
    be = TorchBackend(device="cpu", comb_window=4)
    monkeypatch.setattr(be, "_comb_tables", lambda is_fp2, bases: torch.zeros(be.nwin, len(bases), be.entries))
    issuers = [
        SimpleNamespace(X_tilde=vk.X_tilde, Y_tilde=vk.Y_tilde[first:first + k])
        for k, first in ((2, 0), (3, 0), (4, 0), (5, 0), (6, 0), (6, 1), (7, 0), (8, 0))
    ]

    def key(v, pad):
        tables, batch = be._verify_parts(sigs, [m[: len(v.Y_tilde)] for m in msgs], v, params, pad)
        return bk._graph_key(None, True, bk._verify_operands(tables, batch))

    classes = stream._pad_classes(dict(enumerate(issuers)))
    assert [classes(v) for v in issuers] == [5, 5, 5, 9, 9, 9, 9, 9]
    assert len({key(v, None) for v in issuers}) == 7
    assert len({key(v, 9) for v in issuers}) == 1
    assert len({key(v, classes(v)) for v in issuers}) == 2

    def rounds(pad_of):
        policy = bk._GraphPolicy(4)
        before = metrics.get_count("verify_graph_evictions")
        for _ in range(3):
            for v in issuers:
                k = key(v, pad_of(v))
                if policy.lookup(k)[0] == "capture":
                    policy.store(k, object())
        return policy.evictions, metrics.get_count("verify_graph_evictions") - before

    assert rounds(lambda v: None) == (11, 11)
    assert rounds(lambda v: 9) == (0, 0)
    assert rounds(classes) == (0, 0)


def test_cpu_backend_never_captures(monkeypatch):
    """Three calls of one key on a CPU backend all run fused_verify (a stub
    here), never the policy or a capture; both counters stay 0."""

    def no_graph(*args, **kwargs):
        raise AssertionError("a CPU backend consulted the graph path")

    calls = []

    def stub_verify(sig_is_g1, wtables, mag, *rest):
        calls.append(mag.device)
        return torch.ones(mag.shape[0], dtype=torch.bool)

    monkeypatch.setattr(bk, "VerifyGraph", no_graph)
    monkeypatch.setattr(bk._GraphPolicy, "lookup", no_graph)
    monkeypatch.setattr(bk, "fused_verify", stub_verify)
    params, _, vk, sigs, msgs = entry.fixture(2)
    be = TorchBackend(device="cpu", comb_window=4)
    before = metrics.counters_with_prefix("verify_graph_")
    for _ in range(3):
        assert be.batch_verify(sigs, msgs, vk, params) == [True, True]
    assert calls == [torch.device("cpu")] * 3
    assert (be.verify_graph_captures, be.verify_graph_replays) == (0, 0)
    assert metrics.counters_with_prefix("verify_graph_") == before


def test_heap_is_kept_once_a_process(monkeypatch):
    """The first capture of a process sets glibc's trim threshold, top pad
    and mmap threshold; later captures leave them be, and a C library
    without mallopt is skipped."""
    calls = []

    class Libc:
        def mallopt(self, param, value):
            calls.append((param, value))
            return 1

    monkeypatch.setattr(bk, "_HEAP_KEPT", [])
    monkeypatch.setattr(bk.ctypes, "CDLL", lambda name: Libc())
    bk._keep_freed_heap()
    bk._keep_freed_heap()
    assert calls == [(-1, 256 << 20), (-2, 64 << 20), (-3, 32 << 20)]
    monkeypatch.setattr(bk, "_HEAP_KEPT", [])
    monkeypatch.setattr(bk.ctypes, "CDLL", lambda name: object())
    bk._keep_freed_heap()
    assert bk._HEAP_KEPT == [True] and len(calls) == 3


def test_one_off_work_counts_while_under_way_and_after(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(serial, "time", SimpleNamespace(monotonic=lambda: now[0]))
    monkeypatch.setattr(serial, "_ONE_OFF", (0.0, None))
    assert serial.one_off_seconds() == 0.0
    with serial.one_off():
        now[0] += 2.5
        assert serial.one_off_seconds() == 2.5
    now[0] += 10.0
    assert serial.one_off_seconds() == 2.5
    with pytest.raises(ValueError), serial.one_off():
        now[0] += 1.0
        raise ValueError
    assert serial.one_off_seconds() == 3.5


def test_watchdog_moves_deadlines_back_by_the_one_off_work_in_flight():
    """A dispatch's deadline moves back by the one-off work done while it
    was in flight, and only by that: one begun after it keeps its budget."""
    clock, stall = [0.0], [0.0]
    wd = Watchdog(clock=lambda: clock[0], k=2.0, min_timeout_s=1.0,
                  initial_timeout_s=1.0, stall=lambda: stall[0])
    wd.begin("0", 1, ["a"])
    stall[0] = 3.0  # a capture of 3 s while 1 is in flight
    clock[0] = 3.5
    assert wd.expire() == []
    wd.begin("0", 2, ["b"])
    clock[0] = 4.25
    assert [(seq, overdue) for _, seq, _, _, overdue in wd.expire()] == [(1, 0.25)]
    clock[0] = 4.75
    assert [(seq, overdue) for _, seq, _, _, overdue in wd.expire()] == [(2, 0.25)]
    assert Watchdog().stall() == 0.0


def test_the_engines_watchdog_reads_the_one_off_clock():
    svc = CredentialService(TorchBackend(device="cpu"), None, None, watchdog_interval_s=None)
    assert svc._watchdog.stall is serial.one_off_seconds


# --- on the card --------------------------------------------------------------


def _counts(be):
    return be.verify_graph_captures, be.verify_graph_replays


@pytest.mark.gpu
@pytest.mark.parametrize("ctx", ["G1", "G2"])
@pytest.mark.parametrize("batch, every", [(8, 2), (64, 8)])
def test_replayed_bits_equal_eager_and_expected(cuda, ctx, batch, every):
    """Calls 1 (eager), 2 (capture and replay) and 3 (replay) give the
    expected verdicts, forged lanes of every kind (identity sigma_1
    included) among them, and the CPU path agrees at B = 8."""
    params, _, vk, sigs, msgs = entry.fixture(batch, ctx=ctx)
    sigs, msgs, expect = entry.forge(params, sigs, msgs, every=every)
    assert any(s.sigma_1 is None for s in sigs)
    be = TorchBackend()
    got = [be.batch_verify(sigs, msgs, vk, params) for _ in range(3)]
    assert got == [expect] * 3
    assert _counts(be) == (1, 2)
    if batch == 8:
        cpu = TorchBackend(device="cpu", comb_window=4)
        assert cpu.batch_verify(sigs, msgs, vk, params) == expect


@pytest.mark.gpu
def test_batches_enqueued_back_to_back_return_their_own_bits(cuda):
    """After a key's capture, an honest and a forged batch of its shape are
    both enqueued before either is read, and read in reverse order: each
    returns its own bits."""
    params, _, vk, sigs, msgs = entry.fixture(16)
    fsigs, fmsgs, expect = entry.forge(params, sigs, msgs, every=3)
    be = TorchBackend()
    be.batch_verify(sigs, msgs, vk, params)
    be.batch_verify(sigs, msgs, vk, params)
    honest = be.batch_verify_async(sigs, msgs, vk, params)
    forged = be.batch_verify_async(fsigs, fmsgs, vk, params)
    again = be.batch_verify_async(sigs, msgs, vk, params)
    assert forged() == expect
    assert honest() == [True] * 16
    assert again() == [True] * 16
    assert _counts(be) == (1, 4)


@pytest.mark.gpu
def test_calls_count_as_eager_capture_and_replay(cuda):
    """The counters of calls 1, 2 and 3 of a key, and the capture alone
    marked as one-off work."""
    params, _, vk, sigs, msgs = entry.fixture(8)
    be = TorchBackend()
    counters, one_off = [], []
    for _ in range(3):
        before = metrics.counters_with_prefix("verify_graph_")
        stall = serial.one_off_seconds()
        be.batch_verify(sigs, msgs, vk, params)
        one_off.append(serial.one_off_seconds() > stall)
        after = metrics.counters_with_prefix("verify_graph_")
        counters.append(
            tuple(after.get(k, 0) - before.get(k, 0) for k in ("verify_graph_captures", "verify_graph_replays"))
        )
        counters.append(_counts(be))
    assert counters == [(0, 0), (0, 0), (1, 1), (1, 1), (0, 1), (1, 2)]
    assert one_off == [False, True, False]


@pytest.mark.gpu
def test_a_replay_credits_the_launches_an_eager_call_counts(cuda):
    """cuda_fp.LAUNCH_WIDTHS and LAUNCHES grow by the same launches in an
    eager call, in the capturing call (the capture counts them once) and in
    a replay. A call of another shape first builds the verkey's comb
    tables, so the eager call counts the program's launches alone."""
    params, _, vk, sigs, msgs = entry.fixture(8)
    be = TorchBackend()
    be.batch_verify(sigs[:4], msgs[:4], vk, params)
    deltas = []
    for _ in range(3):
        widths, launches = Counter(cuda_fp.LAUNCH_WIDTHS), cuda_fp.LAUNCHES
        be.batch_verify(sigs, msgs, vk, params)
        deltas.append((Counter(cuda_fp.LAUNCH_WIDTHS) - widths, cuda_fp.LAUNCHES - launches))
    assert deltas[0][1] > 1000
    assert deltas[1] == deltas[0] and deltas[2] == deltas[0]
    assert sum(deltas[0][0].values()) == deltas[0][1]


@pytest.mark.gpu
def test_each_shape_gets_its_own_graph_and_the_cap_evicts_the_oldest(cuda):
    params, _, vk, sigs, msgs = entry.fixture(6)
    sigs, msgs, expect = entry.forge(params, sigs, msgs, every=2)
    be = TorchBackend()
    be._verify_graphs = bk._GraphPolicy(2)
    for b in (4, 5, 6):
        for _ in range(2):
            assert be.batch_verify(sigs[:b], msgs[:b], vk, params) == expect[:b]
    graphs = list(be._verify_graphs.graphs._d.values())
    assert len(graphs) == 2 and _counts(be) == (3, 3)
    assert [g.inputs[1].shape[0] for g in graphs] == [5, 6]
    assert be.batch_verify(sigs[:4], msgs[:4], vk, params) == expect[:4]
    assert _counts(be) == (4, 4)  # seen before: captured again at once
    assert be.batch_verify(sigs[:6], msgs[:6], vk, params) == expect[:6]
    assert _counts(be) == (4, 5)
    assert [g.inputs[1].shape[0] for g in be._verify_graphs.graphs._d.values()] == [4, 6]


@pytest.mark.gpu
def test_a_mixed_ledger_captures_once_a_key_and_replays_the_rest(cuda):
    """A ledger of four issuers (2, 3, 5 and 8 attributes, one params) in
    batches of 8: 48 records in four segments, 12 an issuer, so each
    issuer dispatches a full batch and a padded tail. The ledger's two
    padding classes (5 and 9 bases) make two keys, each run eagerly once,
    captured once and replayed twice more; the verdicts equal a CPU
    backend's, eager, and the plain reference's, forged lanes among them."""
    from portbench.harness import convert
    from portbench.harness import ledger as pools
    from portbench.harness.traffic import forge
    from portbench.reference import ledger as reference

    plain = pools._pools(2**31 + 2117, 12, [2, 3, 5, 8])
    issuers = plain["issuers"]
    params = convert.params(plain)
    verkeys = {i: convert.verkey(iss) for i, iss in enumerate(issuers)}
    plan = [[(n % 4, (n // 4) % 12, 1 if n % 5 == 0 else None) for n in range(s * 12, s * 12 + 12)] for s in range(4)]

    def source(s):
        return [
            (convert.signature(*issuers[i]["creds"][p][:2]), forge(issuers[i]["creds"][p][2], attr), i)
            for i, p, attr in plan[s]
        ]

    def run(be):
        out = []
        stream.verify_ledger(source, 4, verkeys, params, be, batch=8, on_segment=lambda s, v: out.append(v))
        return out

    be = TorchBackend()
    got = run(be)
    assert _counts(be) == (2, 6)
    assert got == run(TorchBackend(device="cpu", comb_window=4))
    keys = {i: iss["sk"] for i, iss in enumerate(issuers)}
    want = [
        reference.verdicts_exp([(i, issuers[i]["logs"][p], forge(issuers[i]["creds"][p][2], a)) for i, p, a in seg], keys)
        for seg in plan
    ]
    assert got == want and not all(v for seg in want for v in seg)
