"""wire-contract: errors.py <-> WIRE_ERROR_CODES <-> error_from_wire.

The fleet gateway collapses every server-side exception into a wire
error envelope carrying ``getattr(exc, "code", "general")`` (net/wire.py
encode_error), and the client rebuilds the typed exception with
errors.error_from_wire. That round trip is only lossless when three
things hold, each a rule here:

  missing-code     every CoconutError subclass *raised on an
                   RPC-reachable path* is itself a value in
                   WIRE_ERROR_CODES. A class that only inherits the base
                   ``code = "error"`` (or a parent's code) crosses the
                   wire as a GeneralError / parent-class impostor — the
                   client's isinstance dispatch silently stops matching.
  round-trip       error_from_wire(code, msg) yields an instance of the
                   mapped class, with the same code and message, and
                   attribute reads on the reconstructed instance don't
                   explode (the ``__new__``-based rebuild skips subclass
                   ``__init__``, so structured fields need class-level
                   defaults — the DoubleSpendError pattern).
  retry-after      every ServiceRetryableError reconstruction carries a
                   finite ``retry_after_s`` >= 0 even when the envelope
                   held NaN/inf/negative junk, and duplicate codes never
                   silently collapse two classes into one map slot.

The raised-class scan is AST (no imports of the serving stack); the
round-trip rules import coconut_tpu_torch.errors only, which is stdlib-light.
RPC-reachable scope: everything under coconut_tpu_torch/ except the offline
checkpoint path (stream.py), the client-side scenario runners
(scenarios/), and the loadgen client (serve/loadgen.py) — exceptions
raised there never enter a wire envelope.
"""

import ast
import math

from .core import Finding

CHECKER = "wire-contract"

#: modules whose raises never reach wire.encode_error (client-side or
#: offline paths); relpath prefixes
NON_RPC_PREFIXES = (
    "coconut_tpu_torch/stream.py",
    "coconut_tpu_torch/scenarios/",
    "coconut_tpu_torch/serve/loadgen.py",
)

#: junk retry hints an envelope (or a buggy peer) could carry; every one
#: must normalize to a finite float >= 0
_JUNK_RETRY_HINTS = (float("nan"), float("inf"), float("-inf"), -5.0, None)


def _errors_module():
    from .. import errors

    return errors


def _coconut_classes(errors):
    """name -> class for every CoconutError subclass defined in errors.py."""
    out = {}
    for name in dir(errors):
        obj = getattr(errors, name)
        if (
            isinstance(obj, type)
            and issubclass(obj, errors.CoconutError)
            and obj.__module__ == errors.__name__
        ):
            out[name] = obj
    return out


def _raised_class_names(tree):
    """(name, lineno) for every ``raise Name(...)`` / ``raise Mod.Name(...)``
    statement; re-raises of caught variables (``raise`` / ``raise e``)
    are skipped — they don't introduce a class."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Raise) or node.exc is None:
            continue
        exc = node.exc
        fn = exc.func if isinstance(exc, ast.Call) else exc
        if isinstance(fn, ast.Attribute):
            yield fn.attr, node.lineno
        elif isinstance(fn, ast.Name):
            # bare ``raise name`` is usually a caught-variable re-raise,
            # not a class; only Call forms count for bare Names unless
            # the name is Capitalized like a class
            if isinstance(exc, ast.Call) or fn.id[:1].isupper():
                yield fn.id, node.lineno


def check_raised_classes(ctx, files=None):
    """The missing-code rule: AST scan of RPC-reachable raises."""
    errors = _errors_module()
    classes = _coconut_classes(errors)
    wired = set(errors.WIRE_ERROR_CODES.values())
    if files is None:
        files = ctx.python_files()
    findings = []
    seen = set()
    for rel in files:
        if rel.startswith(NON_RPC_PREFIXES):
            continue
        sf = ctx.file(rel)
        if sf.tree is None:
            continue
        for name, lineno in _raised_class_names(sf.tree):
            cls = classes.get(name)
            if cls is None or cls in wired:
                continue
            if cls is errors.CoconutError:
                continue  # raising the bare base is its own smell, but
                # it at least round-trips as its declared code
            key = (rel, name)
            if key in seen:
                continue
            seen.add(key)
            findings.append(
                Finding(
                    CHECKER,
                    "missing-code",
                    rel,
                    lineno,
                    "%s raised on an RPC-reachable path but absent from "
                    "WIRE_ERROR_CODES: it crosses the wire as code %r and "
                    "decodes as %s, so client isinstance dispatch breaks"
                    % (
                        name,
                        cls.code,
                        errors.WIRE_ERROR_CODES.get(
                            cls.code, errors.GeneralError
                        ).__name__,
                    ),
                    key="missing-code:%s" % name,
                )
            )
    return findings


def check_round_trip(ctx):
    """round-trip + retry-after + duplicate-code rules (executable
    checks against the live errors module)."""
    errors = _errors_module()
    rel = "coconut_tpu_torch/errors.py"
    findings = []

    # duplicate-code: two classes declaring the same code in __dict__
    # would silently collapse into one WIRE_ERROR_CODES slot
    by_code = {}
    for name, cls in _coconut_classes(errors).items():
        code = cls.__dict__.get("code")
        if code is not None:
            by_code.setdefault(code, []).append(name)
    for code, names in sorted(by_code.items()):
        if len(names) > 1:
            findings.append(
                Finding(
                    CHECKER,
                    "duplicate-code",
                    rel,
                    1,
                    "wire code %r is declared by multiple classes: %s"
                    % (code, ", ".join(sorted(names))),
                    key="duplicate-code:%s" % code,
                )
            )

    msg = "analysis round-trip probe"
    for code, cls in sorted(
        errors.WIRE_ERROR_CODES.items(), key=lambda kv: kv[0]
    ):
        try:
            err = errors.error_from_wire(
                code, msg, program="verify", retry_after_s=1.5
            )
        except Exception as exc:  # noqa: BLE001 - the rule IS "never raises"
            findings.append(
                Finding(
                    CHECKER,
                    "round-trip",
                    rel,
                    1,
                    "error_from_wire(%r) raised %s: %s"
                    % (code, type(exc).__name__, exc),
                    key="round-trip-raise:%s" % code,
                )
            )
            continue
        problems = []
        if not isinstance(err, cls):
            problems.append(
                "decoded as %s, expected %s"
                % (type(err).__name__, cls.__name__)
            )
        if getattr(err, "code", None) != code:
            problems.append(
                "instance code %r != envelope code %r"
                % (getattr(err, "code", None), code)
            )
        if str(err) != msg:
            problems.append("message not preserved (%r)" % str(err))
        try:
            repr(err)
        except Exception as exc:  # noqa: BLE001
            problems.append(
                "repr() raised %s (missing class-level attribute "
                "defaults for __new__-based rebuild?)" % type(exc).__name__
            )
        if problems:
            findings.append(
                Finding(
                    CHECKER,
                    "round-trip",
                    rel,
                    1,
                    "code %r: %s" % (code, "; ".join(problems)),
                    key="round-trip:%s" % code,
                )
            )

        if issubclass(cls, errors.ServiceRetryableError):
            for junk in _JUNK_RETRY_HINTS:
                e2 = errors.error_from_wire(
                    code, msg, program=None, retry_after_s=junk
                )
                ra = getattr(e2, "retry_after_s", None)
                ok = (
                    isinstance(ra, float)
                    and math.isfinite(ra)
                    and ra >= 0.0
                )
                if not ok:
                    findings.append(
                        Finding(
                            CHECKER,
                            "retry-after",
                            rel,
                            1,
                            "code %r with retry_after_s=%r reconstructs "
                            "retry_after_s=%r (must be finite float >= 0)"
                            % (code, junk, ra),
                            key="retry-after:%s:%r" % (code, junk),
                        )
                    )
                    break
    return findings


def run(ctx, files=None):
    return check_raised_classes(ctx, files) + check_round_trip(ctx)
