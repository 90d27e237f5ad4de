"""The generator: deterministic by seed, the stated share of forgeries,
the same work for every seed in another order."""

import pytest

from portbench.harness import fixtures, traffic
from portbench.reference import checks
from portbench.reference.fields import R

SEEDS = (1, 2**31 + 977, 2**33 + 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_batch_plans_repeat_and_plant_the_share(seed):
    a = traffic.batch_plan(seed, 3, 4096, 4096, 64, list(range(6)))
    assert a == traffic.batch_plan(seed, 3, 4096, 4096, 64, list(range(6)))
    assert a != traffic.batch_plan(seed, 4, 4096, 4096, 64, list(range(6)))
    assert sorted(p for p, _ in a) == list(range(4096))
    assert sum(1 for _, f in a if f is not None) == 4096 // 64


@pytest.mark.parametrize("seed", SEEDS)
def test_arrivals_are_one_set_of_gaps_in_another_order(seed):
    a = traffic.arrivals(seed, 500.0, 10.0)
    assert a == traffic.arrivals(seed, 500.0, 10.0)
    b = traffic.arrivals(seed + 1, 500.0, 10.0)
    assert a != b and abs(len(a) - len(b)) < 0.05 * len(a)
    assert all(0 <= t < 10.0 for t in a) and a == sorted(a)
    assert 4500 < len(a) < 5500


def test_pool_forgeries_and_request_order():
    f = traffic.pool_forgeries(9, 1024, 64, list(range(6)))
    assert len(f) == 16 and f == traffic.pool_forgeries(9, 1024, 64, list(range(6)))
    order = traffic.request_order(9, 1024, 3000)
    assert len(order) == 3000 and sorted(order[:1024]) == list(range(1024))


def test_sample_draws_half_forged():
    lanes = list(range(100))
    s = traffic.sample(5, lanes, [3, 7, 9], 8)
    assert s == traffic.sample(5, lanes, [3, 7, 9], 8)
    assert {3, 7, 9} <= set(s) and len(s) == 8


def test_pools_repeat_by_seed_and_are_valid():
    a = fixtures.credential_pool(2**31 + 11, 3, 6)
    assert a == fixtures.credential_pool(2**31 + 11, 3, 6)
    assert a["creds"] != fixtures.credential_pool(2**31 + 12, 3, 6)["creds"]
    for (_, _, m), logs in zip(a["creds"], a["logs"]):
        assert checks.ps_verify_exp(logs, m, a["sk"])
        bad = list(m)
        bad[4] = (bad[4] + 1) % R
        assert not checks.ps_verify_exp(logs, bad, a["sk"])
    s = fixtures.show_pool(2**31 + 11, 2, 6, (2, 3, 4, 5))
    assert s == fixtures.show_pool(2**31 + 11, 2, 6, (2, 3, 4, 5))
    for show, logs in zip(s["shows"], s["logs"]):
        assert checks.show_verify_exp(logs, show[4], show[5], show[6], s["sk"], s["hidden"])


def test_kept_pool_loads_and_a_damaged_file_is_made_again(tmp_path, monkeypatch):
    monkeypatch.setattr(fixtures, "CACHE_DIR", tmp_path)
    fresh = fixtures._credential_pool(2**31 + 13, 3, 6)
    assert fixtures.credential_pool(2**31 + 13, 3, 6) == fresh
    (kept,) = tmp_path.glob("cred-*.pickle")
    made = []
    monkeypatch.setattr(fixtures, "_credential_pool", lambda *a: made.append(a) or fresh)
    assert fixtures.credential_pool(2**31 + 13, 3, 6) == fresh and not made
    data = bytearray(kept.read_bytes())
    data[-5] ^= 1
    kept.write_bytes(bytes(data))
    assert fixtures.credential_pool(2**31 + 13, 3, 6) == fresh and len(made) == 1
    assert fixtures.credential_pool(2**31 + 13, 3, 6) == fresh and len(made) == 1


def test_bulk_windows_do_a_fixed_number_of_batches():
    from portbench.harness import bulk, core

    spec = core.load_spec(kept_out=True)
    for cell in spec["workloads"]:
        _, _, t = core.cell_files(spec, cell["name"])
        if "batch" in t:
            n = bulk.batches_for(spec["run_seconds"], t["batch_s"])
            assert n >= 2 and n * t["batch_s"] >= spec["run_seconds"]
    assert bulk.batches_for(30, 1.45) == 21 and bulk.batches_for(1, 1.45) == 2
