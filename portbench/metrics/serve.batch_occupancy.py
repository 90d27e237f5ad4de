"""serve.batch_occupancy: requests a batch of the service over the window."""

from portbench.harness.readers import batch_occupancy as read  # noqa: F401
