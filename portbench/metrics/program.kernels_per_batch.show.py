"""program.kernels_per_batch.show: device kernels a settled batch in the traced window."""

from portbench.harness.readers import kernels_per_batch as read  # noqa: F401
