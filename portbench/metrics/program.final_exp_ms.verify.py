"""program.final_exp_ms.verify: the mean of the program's final_exp span (the host's enqueue of the final exponentiation and the GT = 1 test) over the window, ms."""

from portbench.harness.readers import span_mean_ms

read = span_mean_ms("final_exp")
