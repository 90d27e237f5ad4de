"""stream.dispatch_ms.verify: the mean of the stream's own dispatch span (host encode and enqueue of one batch) over the window, ms."""

from portbench.harness.readers import span_mean_ms

read = span_mean_ms("dispatch")
