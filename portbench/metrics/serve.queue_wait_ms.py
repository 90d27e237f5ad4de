"""serve.queue_wait_ms: the mean of the service's queue_wait span (admission to the batch) over the window, ms."""

from portbench.harness.readers import span_mean_ms

read = span_mean_ms("queue_wait")
