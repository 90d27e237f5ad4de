"""program.graph_replay_pct.verify: the share of the window's settled batches
that the program issued as a replay of its captured CUDA graphs, percent: 100 x
the window's delta of the `verify_graph_replays` counter / the batches settled.
A batch that captures its shape's graphs replays them too, so a window whose
every batch went through the graphs reads 100.

None without batches, and where the counter did not move in the window: a
program that has no such counter (one that launches every operator from the
host) cannot be told apart from one whose window replayed nothing."""


def read(run):
    batches = run.record.get("batches")
    replays = run.counters.get("verify_graph_replays")
    if not batches or replays is None:
        return None
    return 100.0 * replays / batches
