"""The port's error classes: its own copies of the JAX package's
`CoconutError`, `UnsupportedNoOfMessages`, `UnequalNoOfBasesExponents`,
`PSError`, `DeserializationError`, `GeneralError`, the host layers'
`TransientBackendError`, the services' retriable refusals
(`ServiceRetryableError` and its `ServiceOverloadedError`,
`ServiceBrownoutError`, `QuorumUnreachableError`, `ServiceClosedError`),
the key lifecycle's `ShareVerificationError`, `DkgAbortedError`,
`EpochUnknownError` and `EpochRetiredError`, and the stream checkpoint's
`CheckpointCorruptError` / `CheckpointMismatchError`
(`coconut_tpu/errors.py`), with the same names,
messages, stable wire codes and `retry_after_s` contract, so a caller that
catches refusals by class or by `code` treats both packages alike."""

import math


def _finite_retry_after(value):
    """Clamp a retry-after hint to a finite float >= 0 (0.0 = "no
    estimate, retry at will")."""
    if value is None:
        return 0.0
    try:
        value = float(value)
    except (TypeError, ValueError):
        return 0.0
    if not math.isfinite(value) or value < 0.0:
        return 0.0
    return value


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


class DeserializationError(CoconutError):
    """Malformed or non-canonical byte encoding: a truncated proof, trailing
    bytes, a field element not below its modulus, a point off the curve or
    outside the r-torsion subgroup."""

    code = "bad_request"


class GeneralError(CoconutError):
    """Catch-all with a message: issuance and secret-sharing refusals (a
    bad threshold, a short or duplicated aggregation subset, a key list of
    the wrong length)."""

    code = "general"


class TransientBackendError(CoconutError):
    """A backend dispatch or readback failure expected to succeed on
    re-attempt. The supervision layers (stream.verify_stream, the serve
    engine, retry.RetryPolicy) retry these with bounded backoff and then
    fall back to a designated backend; any other exception class is
    permanent and propagates."""

    code = "transient"


class ServiceRetryableError(CoconutError):
    """Base of every loud but retriable refusal an online service emits
    (overload, brownout, closed). Carries `program`, the engine program
    that refused (or None), and `retry_after_s`, the service's hint for
    when capacity should be back: always a finite float >= 0 (0.0 = no
    estimate)."""

    code = "retryable"

    def __init__(self, message, program=None, retry_after_s=None):
        super().__init__(message)
        self.program = program
        self.retry_after_s = _finite_retry_after(retry_after_s)


class ServiceOverloadedError(ServiceRetryableError):
    """The bounded request queue is at capacity: admission control
    rejects the request (serve/queue.py, counter "serve_rejected").
    Carries `depth` and `max_depth`."""

    code = "overloaded"

    def __init__(self, depth, max_depth, program=None, retry_after_s=None):
        super().__init__(
            "serving queue at capacity (%d/%d): request rejected by "
            "admission control — back off and resubmit" % (depth, max_depth),
            program=program,
            retry_after_s=retry_after_s,
        )
        self.depth = depth
        self.max_depth = max_depth


class ServiceBrownoutError(ServiceRetryableError):
    """Graded load-shedding (serve/health.BrownoutPolicy) refuses this
    request's lane: quarantined executors cut the pool's capacity or the
    queue crossed the brownout threshold. Bulk sheds first; carries the
    pressure-scaled `retry_after_s`, `lane`, `depth` and
    `capacity_fraction` (counter "serve_shed_bulk")."""

    code = "brownout"

    def __init__(
        self,
        lane,
        retry_after_s,
        depth=None,
        capacity_fraction=None,
        program=None,
    ):
        detail = []
        if capacity_fraction is not None:
            detail.append("capacity %d%%" % round(capacity_fraction * 100))
        if depth is not None:
            detail.append("depth %d" % depth)
        super().__init__(
            "service brownout (%s): %s lane shed — retry after ~%.3gs"
            % (", ".join(detail) or "degraded", lane, retry_after_s),
            program=program,
            retry_after_s=retry_after_s,
        )
        self.lane = lane
        self.depth = depth
        self.capacity_fraction = capacity_fraction


class QuorumUnreachableError(ServiceRetryableError):
    """The threshold-issuance layer cannot assemble t distinct valid
    partial signatures for a request: too many authorities are crashed,
    hung, quarantined or emitting corrupt partials (issue/). Retriable:
    authorities re-admit through the probation ladder. Carries `needed`
    (the threshold t), `have` (distinct valid partials collected) and
    `live` (authorities that could still contribute when the service gave
    up). Counted under "issue_quorum_unreachable"."""

    code = "quorum_unreachable"

    def __init__(self, needed, have, live=0, program=None, retry_after_s=None):
        super().__init__(
            "issuance quorum unreachable: have %d of %d required partial "
            "signatures with only %d live authorities left able to "
            "contribute — retry once the pool recovers" % (have, needed, live),
            program=program,
            retry_after_s=retry_after_s,
        )
        self.needed = needed
        self.have = have
        self.live = live


class ServiceClosedError(ServiceRetryableError):
    """A request was submitted to (or still queued in) a service that is
    draining or shut down. Futures abandoned by a non-draining shutdown
    resolve with it, so no caller hangs on a dropped future. Retriable:
    another replica can serve the request (`retry_after_s` 0.0)."""

    code = "closed"


class ShareVerificationError(GeneralError):
    """A Pedersen-committed share failed verification against its dealer's
    coefficient commitments (sss.PedersenVSS.check_share), or a DVSS / DKG
    participant refused a structurally invalid share (its own share echoed
    back, a duplicate dealer). Carries `dealer_id`, the authority whose
    sharing is at fault, and `round`, the key-lifecycle round label ("dkg" /
    "refresh" / "reshare" / "dvss", or None offline). Not retriable: the
    dealer must be excluded."""

    code = "share_rejected"

    def __init__(self, message, dealer_id=None, round=None):
        super().__init__(message)
        self.dealer_id = dealer_id
        self.round = round


class DkgAbortedError(ServiceRetryableError):
    """A distributed key-generation (or proactive refresh / reshare) round
    could not complete: after excluding the dealers named by complaints and
    the unreachable ones, fewer than `threshold` qualified dealers remain
    (keylife/dkg.py). Retriable: a later round may succeed. Carries
    `needed` (the threshold t), `qualified` and `excluded` (sorted ids)."""

    code = "dkg_aborted"

    def __init__(
        self, needed, qualified, excluded=(), program=None, retry_after_s=None
    ):
        excluded = tuple(sorted(excluded))
        super().__init__(
            "DKG aborted: only %d of %d required qualified dealers remain "
            "(excluded: %s) — retry once the authority pool recovers"
            % (qualified, needed, list(excluded) or "none"),
            program=program,
            retry_after_s=retry_after_s,
        )
        self.needed = needed
        self.qualified = qualified
        self.excluded = excluded


class EpochUnknownError(CoconutError):
    """A request named a key epoch this service has never activated (or
    not yet). Carries `epoch` and the `live` epoch ids known when refused;
    counted under "keylife_epoch_unknown"."""

    code = "epoch_unknown"

    def __init__(self, epoch, live=()):
        super().__init__(
            "unknown key epoch %d: this service has epochs %s live — "
            "re-resolve the epoch set and resubmit" % (epoch, sorted(live))
        )
        self.epoch = epoch
        self.live = tuple(sorted(live))


class EpochRetiredError(CoconutError):
    """A request named a key epoch retired out of the bounded live window
    (keylife.EpochRegistry): its verkey is no longer served. Not
    retriable: the credential must be re-minted under a live epoch.
    Carries `epoch` and the `live` epoch ids; counted under
    "keylife_epoch_retired"."""

    code = "epoch_retired"

    def __init__(self, epoch, live=()):
        super().__init__(
            "key epoch %d is retired: credentials minted under it must be "
            "re-minted (live epochs: %s)" % (epoch, sorted(live))
        )
        self.epoch = epoch
        self.live = tuple(sorted(live))


class CheckpointCorruptError(CoconutError):
    """A stream checkpoint failed integrity validation (truncated or
    unparseable bytes, an unknown schema, a CRC mismatch).
    stream.StreamState catches it, quarantines the file to
    `<path>.corrupt*` and restarts cleanly."""


class CheckpointMismatchError(CoconutError):
    """A well-formed checkpoint belongs to a different run: its stored
    fingerprint (mode + verkey digest, stream.run_fingerprint) disagrees
    with the resuming run's, so the resume fails loudly."""

    def __init__(self, stored, expected):
        super().__init__(
            "checkpoint fingerprint %s does not match this run's %s: "
            "refusing to resume a different run's state (delete or move "
            "the state file to start over)" % (stored, expected)
        )
        self.stored = stored
        self.expected = expected
