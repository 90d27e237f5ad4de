"""program.affine_ms.verify: the mean of the program's affine span (the host's enqueue of the accumulator's normalization) over the window, ms."""

from portbench.harness.readers import span_mean_ms

read = span_mean_ms("affine")
