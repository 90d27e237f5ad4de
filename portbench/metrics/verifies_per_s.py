"""verifies_per_s: credentials settled in the window over the window's seconds."""

from portbench.harness.readers import rate as read  # noqa: F401
