"""stream.route_ms.ledger: the mean of the ledger's route span (one a segment, on the routing thread: its records routed into their issuers' queues) over the window, ms."""

from portbench.harness.readers import span_mean_ms

read = span_mean_ms("route")
