"""fp_mul_roofline.verify: the field kernel's share of its roofline over the window, percent."""

from portbench.harness.readers import fp_mul_roofline_pct as read  # noqa: F401
