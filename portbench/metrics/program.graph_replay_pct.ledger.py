"""program.graph_replay_pct.ledger: the share of a ledger's issuer batches that
the program issued as a replay of its captured CUDA graphs, percent: 100 x the
window's delta of the `verify_graph_replays` counter / its delta of
`ledger_dispatches`. A batch that captures its shape's graphs replays them too.

None where either counter did not move in the window: a program without the
ledger has no `ledger_dispatches`, and one without graphs no replays."""


def read(run):
    dispatches = run.counters.get("ledger_dispatches")
    replays = run.counters.get("verify_graph_replays")
    if not dispatches or replays is None:
        return None
    return 100.0 * replays / dispatches
