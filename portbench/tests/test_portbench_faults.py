"""The output check catches a broken timed path. Each cell runs on the
CPU at a size a test can hold, through the whole harness but its look for
a card (`core.execute`), once sound (correct), once as the control (the
program's one-verdict-per-batch path: not correct), and once with each
fault the cell can have planted under the timed path (not correct):

  altered   an answer altered where it is produced: lane 0 of every
            batch flipped;
  stale     a step that returns its state unchanged: every batch after
            the first answers with the first batch's verdicts;
  half      half of the batch left out: the second half of every batch
            answers with lane 0's verdict.

The exchange between chips does not exist in these one-card cells.
Several minutes on one CPU core."""

import time

import pytest
import torch

from portbench.harness import core

SPEC = core.load_spec(kept_out=True)
SEED = 2**31 + 20
#: tiny traffic for each cell on the CPU: batches of 8 with 4 forged lanes
SIZES = {
    "cfg2_verify.bulk4096": {"batch": 8, "pool": 8, "forge_every": 2, "spec_sample": 4},
    "cfg3_show.bulk2048": {"batch": 8, "pool": 8, "forge_every": 2, "spec_sample": 4},
    "cfg2_verify.served": {"rate": 16, "pool": 8, "forge_every": 2, "max_batch": 4, "spec_sample": 4},
}


def _fault(kind):
    """A finalizer transform planting `kind`."""
    first = []

    def plant(bits):
        bits = list(bits)
        if kind == "altered":
            bits[0] = not bits[0]
        elif kind == "stale":
            if not first:
                first.append(list(bits))
            else:
                bits = list(first[0])
        elif kind == "half":
            half = len(bits) // 2
            bits[half:] = [bits[0]] * (len(bits) - half)
        return bits

    return plant


class Faulty:
    """A backend whose async verify and show-verify answers pass through
    `plant`; everything else is the wrapped backend's."""

    def __init__(self, inner, plant):
        self._inner, self._plant = inner, plant

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def batch_verify_async(self, *args):
        fin = self._inner.batch_verify_async(*args)
        return lambda: self._plant(fin())

    def batch_show_verify_async(self, *args):
        fin = self._inner.batch_show_verify_async(*args)
        return lambda: self._plant(fin())


def _run(cell, **kw):
    torch.set_num_threads(2)
    result, _ = core.execute(
        SPEC, cell, SEED, 1.0, 0, torch.device("cpu"), time.perf_counter(), sizes=SIZES[cell], **kw
    )
    return result


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_control_is_not_correct(cell):
    result = _run(cell, control=True)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("kind", ["altered", "stale", "half"])
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_planted_fault_is_not_correct(cell, kind):
    plant = _fault(kind)
    result = _run(cell, wrap=lambda be: Faulty(be, plant))
    assert not result["correct"], (kind, result["checks"])
