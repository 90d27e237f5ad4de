"""The port's error classes: its own copies of the JAX package's
`CoconutError`, `UnsupportedNoOfMessages`, `UnequalNoOfBasesExponents`,
`PSError` and `GeneralError` (`coconut_tpu/errors.py`), with the same names, messages and
stable wire codes, so a caller that catches the PS and issuance layers'
refusals by class or by `code` treats both packages alike."""


class CoconutError(Exception):
    """Base class of the framework's errors. `code` is the stable
    machine-readable identifier an error envelope carries; subclasses
    override it."""

    code = "error"


class UnsupportedNoOfMessages(CoconutError):
    """A verkey valid for `expected` messages given `given`."""

    code = "unsupported_messages"

    def __init__(self, expected, given):
        super().__init__(
            "Verkey valid for %d messages but given %d messages" % (expected, given)
        )
        self.expected = expected
        self.given = given


class UnequalNoOfBasesExponents(CoconutError):
    """A Schnorr proof whose bases and exponents differ in number."""

    code = "unequal_bases_exponents"

    def __init__(self, bases, exponents):
        super().__init__(
            "Same no of bases and exponents required. %d bases and %d exponents"
            % (bases, exponents)
        )
        self.bases = bases
        self.exponents = exponents


class PSError(CoconutError):
    """Error raised by the PS-signature layer: batch-size mismatches, an
    unknown verify mode, revealed messages that do not match a proof."""

    code = "ps_error"


class GeneralError(CoconutError):
    """Catch-all with a message: issuance and secret-sharing refusals (a
    bad threshold, a short or duplicated aggregation subset, a key list of
    the wrong length)."""

    code = "general"
