"""fp_mul_roofline.ledger: the field kernel's share of its roofline over the window of a ledger, whose padded comb MSMs change its widths, percent."""

from portbench.harness.readers import fp_mul_roofline_pct as read  # noqa: F401
