"""backend.encode_ms.verify: the mean of the backend's encode span (TorchBackend.encode_verify_batch: static operands, comb digits, signature encode and upload) over the window, ms."""

from portbench.harness.readers import span_mean_ms

read = span_mean_ms("encode")
