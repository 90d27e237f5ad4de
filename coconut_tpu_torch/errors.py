"""The port's error classes: its own copies of the JAX package's
`CoconutError`, `UnsupportedNoOfMessages`, `UnequalNoOfBasesExponents`,
`PSError`, `DeserializationError`, `GeneralError`, the host layers'
`TransientBackendError`, the services' retriable refusals
(`ServiceRetryableError` and its `ServiceOverloadedError`,
`ServiceBrownoutError`, `QuorumUnreachableError`, `ServiceClosedError`),
the key lifecycle's `ShareVerificationError`, `DkgAbortedError`,
`EpochUnknownError` and `EpochRetiredError`, the gateway's tenant refusals
(`TenantAuthError`, `TenantQuotaError`, `TenantRateLimitError`), the stream
checkpoint's `CheckpointCorruptError` / `CheckpointMismatchError`, and the
nullifier guard's `DoubleSpendError` (`coconut_tpu/errors.py`), with the
same names, messages, stable wire codes and `retry_after_s` contract, so a
caller that catches refusals by class or by `code` treats both packages
alike.

`WIRE_ERROR_CODES` is the 1:1 code <-> class map the error envelope of
`net/wire.py` travels through, and `error_from_wire` rebuilds the typed
exception an envelope names. Where a class's message carries its fields,
`_restore_wire_fields` recovers them from the text alone."""

import math
import re


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

    # class-level defaults: error_from_wire rebuilds non-retryable errors
    # via cls.__new__ + CoconutError.__init__, which never runs this
    # subclass __init__ — attribute reads must still succeed
    expected = None
    given = None

    def __init__(self, expected, given):
        super().__init__(
            "Verkey valid for %d messages but given %d messages" % (expected, given)
        )
        self.expected = expected
        self.given = given

    def _restore_wire_fields(self, message):
        m = re.search(r"valid for (\d+) messages but given (\d+)", message)
        if m is not None:
            self.expected = int(m.group(1))
            self.given = int(m.group(2))


class UnequalNoOfBasesExponents(CoconutError):
    """A Schnorr proof whose bases and exponents differ in number."""

    code = "unequal_bases_exponents"

    bases = None
    exponents = None

    def __init__(self, bases, exponents):
        super().__init__(
            "Same no of bases and exponents required. %d bases and %d exponents"
            % (bases, exponents)
        )
        self.bases = bases
        self.exponents = exponents

    def _restore_wire_fields(self, message):
        m = re.search(r"(\d+) bases and (\d+) exponents", message)
        if m is not None:
            self.bases = int(m.group(1))
            self.exponents = int(m.group(2))


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

    @classmethod
    def from_wire(cls, message, program=None, retry_after_s=0.0):
        """Rebuild a retriable refusal from a decoded error envelope. The
        subclass constructor is bypassed: an envelope carries only the
        shared fields (message, program, retry_after_s), not the
        structural detail such as queue depths."""
        err = cls.__new__(cls)
        ServiceRetryableError.__init__(
            err, message, program=program, retry_after_s=retry_after_s
        )
        return err


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


class TenantAuthError(CoconutError):
    """The gateway (net/) refused a request whose API key maps to no
    provisioned tenant. Not retriable. Counted under
    "gateway_auth_failures"."""

    code = "tenant_auth"


class TenantQuotaError(CoconutError):
    """A tenant's absolute request quota is exhausted (net/tenant.py).
    Not retriable within the quota epoch: there is no refill to wait for.
    Counted under "gateway_tenant_<id>_quota_rejected"."""

    code = "tenant_quota"

    def __init__(self, tenant, used, quota):
        super().__init__(
            "tenant %r quota exhausted (%d/%d requests): raise the quota "
            "or rotate the epoch" % (tenant, used, quota)
        )
        self.tenant = tenant
        self.used = used
        self.quota = quota


class TenantRateLimitError(ServiceRetryableError):
    """A tenant's token bucket is empty (net/tenant.py): the request was
    refused before engine admission. Retriable: `retry_after_s` is the
    bucket's refill horizon for one token. Counted under
    "gateway_tenant_<id>_throttled"."""

    code = "tenant_rate_limited"

    def __init__(self, tenant, retry_after_s, program=None):
        super().__init__(
            "tenant %r rate-limited: token bucket empty — retry after "
            "~%.3gs" % (tenant, _finite_retry_after(retry_after_s)),
            program=program,
            retry_after_s=retry_after_s,
        )
        self.tenant = tenant


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


class DoubleSpendError(CoconutError):
    """A show-verify lane presented a credential whose nullifier is
    already in the replicated nullifier set (state/nullifier.py) — the
    Coconut paper's e-cash/petition double-spend case. NOT retriable
    anywhere in the fleet: the nullifier is a deterministic digest of
    the proof transcript, so replaying the same show against any
    replica that has the fact (locally witnessed, WAL-replayed, or
    anti-entropy-replicated) yields the same rejection. Carries the
    `nullifier` hex digest, the `epoch` it is scoped to, and the
    application `domain` when the show was domain-scoped (petition
    campaign, e-cash — see state/nullifier.py). Counted under
    "nullifier_double_spends"."""

    code = "double_spend"

    # class-level defaults: an error envelope's decoder rebuilds
    # non-retryable errors via cls.__new__ + CoconutError.__init__, which
    # never runs this subclass __init__ — attribute reads must still
    # succeed
    nullifier = None
    epoch = None
    domain = None

    def __init__(self, nullifier=None, epoch=None, domain=None):
        super().__init__(
            "credential already shown: nullifier %s is spent%s%s"
            % (
                nullifier if nullifier is not None else "<unknown>",
                "" if epoch is None else " (epoch %d)" % epoch,
                "" if domain is None else " [domain %s]" % domain,
            )
        )
        self.nullifier = nullifier
        self.epoch = epoch
        self.domain = domain

    def _restore_wire_fields(self, message):
        # the envelope carries only (code, message); the message format
        # above is part of the wire contract, so the structured fields
        # survive the round trip — clients match on err.nullifier, not
        # on message text
        m = re.search(
            r"nullifier ([0-9a-f]{64}) is spent"
            r"(?: \(epoch (\d+)\))?(?: \[domain ([^\]]+)\])?",
            message,
        )
        if m is not None:
            self.nullifier = m.group(1)
            self.epoch = None if m.group(2) is None else int(m.group(2))
            self.domain = m.group(3)


#: the 1:1 code <-> class map the wire error envelope encodes and decodes
#: through (net/wire.py), in the JAX package's order. Retriable codes
#: rebuild via `from_wire` (shared fields only); the rest with their
#: message.
WIRE_ERROR_CODES = {
    cls.code: cls
    for cls in (
        GeneralError,
        DeserializationError,
        UnsupportedNoOfMessages,
        UnequalNoOfBasesExponents,
        PSError,
        TransientBackendError,
        ServiceRetryableError,
        ServiceOverloadedError,
        ServiceBrownoutError,
        QuorumUnreachableError,
        ServiceClosedError,
        TenantAuthError,
        TenantQuotaError,
        TenantRateLimitError,
        ShareVerificationError,
        DkgAbortedError,
        EpochUnknownError,
        EpochRetiredError,
        DoubleSpendError,
    )
}


def error_from_wire(code, message, program=None, retry_after_s=0.0):
    """Rebuild the typed exception a wire error envelope describes.
    Unknown codes degrade to GeneralError (a newer server may emit codes
    this client predates) with the code kept as an instance attribute."""
    cls = WIRE_ERROR_CODES.get(code)
    if cls is None:
        err = GeneralError(message)
        err.code = code
        return err
    if issubclass(cls, ServiceRetryableError):
        return cls.from_wire(
            message, program=program, retry_after_s=retry_after_s
        )
    err = cls.__new__(cls)
    CoconutError.__init__(err, message)
    if program is not None:
        err.program = program
    restore = getattr(err, "_restore_wire_fields", None)
    if restore is not None:
        restore(message)
    return err
