"""setup_s: process start to the first timed request (CUDA start, library load, fixture, warm-up), seconds."""

from portbench.harness.readers import setup_s as read  # noqa: F401
