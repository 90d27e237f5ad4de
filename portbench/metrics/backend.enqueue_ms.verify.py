"""backend.enqueue_ms.verify: the mean of the backend's enqueue span (the host's launch of every operator of fused_verify) over the window, ms."""

from portbench.harness.readers import span_mean_ms

read = span_mean_ms("enqueue")
