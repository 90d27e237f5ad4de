"""program.pad_lane_pct.ledger: the share of a ledger's dispatched lanes that
are padding (the identity lanes that fill each issuer's tail to the batch
width), percent: 100 x the window's delta of `ledger_pad_lanes` / its delta of
`ledger_lanes`.

None where `ledger_lanes` did not move: a program without the ledger."""


def read(run):
    lanes = run.counters.get("ledger_lanes")
    if not lanes:
        return None
    return 100.0 * run.counters.get("ledger_pad_lanes", 0) / lanes
