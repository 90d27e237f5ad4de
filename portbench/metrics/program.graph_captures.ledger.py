"""program.graph_captures.ledger: the CUDA-graph captures inside a ledger's
window, the window's delta of the `verify_graph_captures` counter: 0 where the
set-up captured every shape key the window uses.

None where `ledger_dispatches` did not move: a program without the ledger."""


def read(run):
    if not run.counters.get("ledger_dispatches"):
        return None
    return run.counters.get("verify_graph_captures", 0)
