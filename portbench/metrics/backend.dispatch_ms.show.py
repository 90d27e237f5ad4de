"""backend.dispatch_ms.show: the mean of the benchmark's own span around batch_show_verify_async (host encode and enqueue), ms."""

from portbench.harness.readers import own_dispatch_ms as read  # noqa: F401
