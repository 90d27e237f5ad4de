"""What the bulk runners share: the window's number of batches, the
planted batches, and the output check over every lane.

A bulk window settles a whole number of batches, all the work it starts.
That number comes from `--seconds` and the nominal batch time written in
the traffic file (`batch_s`), never from a timing of this process, so
every run of a cell does the same work; the rate is every lane settled
over the window's whole length, from the first dispatch to the last
settle.
"""

import math

from . import traffic


def batches_for(seconds, batch_s):
    """How many batches of the nominal time `batch_s` fill a window of
    `seconds`; never fewer than two, so the pipeline always overlaps."""
    return max(2, int(math.ceil(seconds / batch_s)))


def plans(seed, n, pool_n, batch, forge_every, attrs, start=0):
    """The lane plans of batches start .. start+n-1."""
    return [traffic.batch_plan(seed, i, pool_n, batch, forge_every, attrs) for i in range(start, start + n)]


def judge(seed, plans_, verdicts, exp_check, spec_check, k):
    """{name: (value, limit)} of a bulk window.

    plans_: the window's lane plans; verdicts: {batch: [bool a lane]} as
    the program settled them; exp_check(pool index, forged attribute) and
    spec_check(...) give the reference's verdict for a lane, by the
    signing key (every lane) and by the spec's pairings (a sample of k
    lanes drawn from the seed, half of them forged)."""
    wrong, unanswered, lanes, forged = 0, 0, [], []
    memo = {}
    for b, plan in enumerate(plans_):
        got = verdicts.get(b)
        if got is None or len(got) != len(plan):
            unanswered += len(plan)
            continue
        for lane, (p, attr) in enumerate(plan):
            want = memo.get((p, attr))
            if want is None:
                want = memo[(p, attr)] = exp_check(p, attr)
            wrong += bool(got[lane]) != want
            lanes.append((b, lane))
            if attr is not None:
                forged.append((b, lane))
    disagree = 0
    for b, lane in traffic.sample(seed, lanes, forged, k):
        p, attr = plans_[b][lane]
        disagree += bool(verdicts[b][lane]) != spec_check(p, attr)
    return {
        "wrong_verdicts": (wrong, 0),
        "spec_disagreements": (disagree, 0),
        "unanswered": (unanswered, 0),
    }
