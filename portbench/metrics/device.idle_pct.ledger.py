"""device.idle_pct.ledger: the device's idle share of the traced window, percent."""

from portbench.harness.readers import idle_pct as read  # noqa: F401
