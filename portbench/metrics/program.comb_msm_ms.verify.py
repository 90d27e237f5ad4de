"""program.comb_msm_ms.verify: the mean of the program's comb_msm span (the host's enqueue of the verkey comb MSM) over the window, ms."""

from portbench.harness.readers import span_mean_ms

read = span_mean_ms("comb_msm")
