"""verify_latency_p95_s: the 95th percentile of every request of the window, timed from when it was due."""

from portbench.harness.readers import latency_p95_s as read  # noqa: F401
