"""The port's error classes: its own copies of the JAX package's
`CoconutError` and `PSError` (`coconut_tpu/errors.py`), with the same names
and the same stable wire codes, so a caller that catches the PS layer's
refusals by class or by `code` treats both packages alike."""


class CoconutError(Exception):
    """Base class of the framework's errors. `code` is the stable
    machine-readable identifier an error envelope carries; subclasses
    override it."""

    code = "error"


class PSError(CoconutError):
    """Error raised by the PS-signature layer: batch-size mismatches, an
    unknown verify mode, revealed messages that do not match a proof."""

    code = "ps_error"
