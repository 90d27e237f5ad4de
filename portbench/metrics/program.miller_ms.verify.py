"""program.miller_ms.verify: the mean of the program's miller_loop span (the host's enqueue of the pairing's Miller loop) over the window, ms."""

from portbench.harness.readers import span_mean_ms

read = span_mean_ms("miller_loop")
