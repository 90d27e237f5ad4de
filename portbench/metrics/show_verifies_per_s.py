"""show_verifies_per_s: show proofs settled in the window over the window's seconds."""

from portbench.harness.readers import rate as read  # noqa: F401
