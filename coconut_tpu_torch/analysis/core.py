"""Shared infrastructure for the invariant lint suite.

The repo upholds several load-bearing cross-file contracts purely by
convention — the thread/lock discipline, the errors.py <-> WIRE_ERROR_CODES
wire contract, the CONSTTIME.md no-secret-branches rule, the state/atomic.py
every-durable-write-is-tmp+fsync+replace policy, and the README metrics
glossary. Each contract gets a checker (analysis/<name>.py); this module is
the machinery they share:

  - ``Finding``: one violation, with a STABLE fingerprint (checker + rule +
    file + content key — deliberately NOT the line number, so unrelated
    edits above a finding don't churn the baseline);
  - inline pragmas: ``# lint: allow(<checker>[, reason])`` on the flagged
    line or the line directly above suppresses that checker's findings
    there — the in-tree justification syntax for accepted exceptions
    (e.g. CONSTTIME.md's documented host big-int caveat);
  - the suppression baseline (``coconut_tpu_torch/analysis_baseline.json``,
    the port's own): fingerprints of known findings, each carrying a one-line
    justification. ``--fail-on-new`` (the CI gate) fails on any finding
    that is neither pragma-suppressed nor baselined;
  - ``Context``: parsed-AST + source-line cache over the scanned tree so
    five checkers pay one parse per file.

Checkers are pure functions of the tree: no network, no device, no
imports of the heavyweight jax stack (wire-contract imports errors.py
only). ``python -m coconut_tpu_torch.analysis`` is the runner.
"""

import ast
import hashlib
import json
import os
import re

#: the five registered checker names (import order = report order)
CHECKER_NAMES = (
    "lock-order",
    "wire-contract",
    "const-time",
    "durability",
    "metrics-doc",
)

#: inline suppression: ``# lint: allow(<checker>[, reason])``. The
#: reason may wrap onto following comment lines, so only the opening —
#: ``allow(<checker>`` followed by ``,`` / ``)`` / end-of-line — anchors.
_PRAGMA_RE = re.compile(
    r"#\s*lint:\s*allow\(\s*([a-z][a-z-]*)\s*(?:[,)]|$)"
)

DEFAULT_BASELINE = "coconut_tpu_torch/analysis_baseline.json"


class Finding(object):
    """One checker violation.

    ``key`` is the content the fingerprint hashes (defaults to the
    message): keep it free of line numbers and absolute paths so the
    fingerprint survives unrelated edits and checkouts at other roots.
    """

    def __init__(self, checker, rule, path, line, message, key=None):
        self.checker = checker
        self.rule = rule
        self.path = path  # repo-relative, forward slashes
        self.line = int(line)
        self.message = message
        self.key = key if key is not None else message
        self.suppressed_by = None  # "pragma" | "baseline" | None

    @property
    def fingerprint(self):
        h = hashlib.sha256(
            ("%s|%s|%s|%s" % (self.checker, self.rule, self.path, self.key))
            .encode("utf-8")
        )
        return h.hexdigest()[:16]

    def to_dict(self):
        return {
            "checker": self.checker,
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "fingerprint": self.fingerprint,
            "suppressed_by": self.suppressed_by,
        }

    def __repr__(self):
        return "%s:%d: [%s/%s] %s" % (
            self.path,
            self.line,
            self.checker,
            self.rule,
            self.message,
        )


class SourceFile(object):
    """Parsed view of one scanned file: text, lines, AST (None for
    non-Python or syntax errors), and the pragma map."""

    def __init__(self, root, relpath):
        self.relpath = relpath
        self.abspath = os.path.join(root, relpath)
        with open(self.abspath, "r", encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree = None
        if relpath.endswith(".py"):
            try:
                self.tree = ast.parse(self.text, filename=relpath)
            except SyntaxError:
                self.tree = None
        # line -> {checker names allowed there}
        self.pragmas = {}
        for i, line in enumerate(self.lines, start=1):
            for m in _PRAGMA_RE.finditer(line):
                self.pragmas.setdefault(i, set()).add(m.group(1))

    def pragma_allows(self, checker, line):
        """True if a ``# lint: allow(checker)`` pragma covers ``line``:
        on the line itself, or anywhere in the contiguous block of
        comment-only lines directly above it (pragma reasons wrap)."""
        if checker in self.pragmas.get(line, ()):
            return True
        ln = line - 1
        while ln >= 1 and ln >= line - 6:
            text = self.lines[ln - 1].strip() if ln <= len(self.lines) else ""
            if not text.startswith("#"):
                break
            if checker in self.pragmas.get(ln, ()):
                return True
            ln -= 1
        return False


class Context(object):
    """The scanned tree: repo root + lazily parsed files."""

    #: directories under the package root the scanners walk
    PACKAGE = "coconut_tpu_torch"

    def __init__(self, root):
        self.root = os.path.abspath(root)
        self._files = {}

    def file(self, relpath):
        relpath = relpath.replace(os.sep, "/")
        sf = self._files.get(relpath)
        if sf is None:
            sf = self._files[relpath] = SourceFile(self.root, relpath)
        return sf

    def python_files(self, subdir=None):
        """Sorted repo-relative paths of every ``.py`` file under the
        package (or ``subdir`` within it). The analysis package itself is
        excluded — its fixture strings and checker tables would trip the
        very rules they implement."""
        base = self.PACKAGE if subdir is None else subdir
        top = os.path.join(self.root, base)
        out = []
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = [
                d for d in dirnames if d not in ("__pycache__", ".git")
            ]
            if os.path.basename(dirpath) == "analysis":
                dirnames[:] = []
                continue
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    rel = os.path.relpath(
                        os.path.join(dirpath, fn), self.root
                    )
                    out.append(rel.replace(os.sep, "/"))
        return sorted(out)

    def exists(self, relpath):
        return os.path.exists(os.path.join(self.root, relpath))


# -- baseline ---------------------------------------------------------------


def load_baseline(path):
    """{fingerprint: entry} from a baseline JSON (empty if missing)."""
    if not path or not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    out = {}
    for entry in doc.get("suppressions", []):
        out[entry["fingerprint"]] = entry
    return out


def write_baseline(path, findings):
    """Write every unsuppressed finding's fingerprint as a suppression
    entry (reason left as TODO — the satellite contract is that each
    shipped suppression carries a real one-line justification)."""
    doc = {
        "version": 1,
        "suppressions": [
            {
                "fingerprint": f.fingerprint,
                "checker": f.checker,
                "rule": f.rule,
                "path": f.path,
                "reason": "TODO: justify or fix",
            }
            for f in findings
            if f.suppressed_by is None
        ],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return doc


def apply_suppressions(findings, ctx, baseline):
    """Stamp ``suppressed_by`` on each finding: inline pragma first, then
    baseline fingerprint. Returns the list of NEW (unsuppressed) findings."""
    new = []
    for f in findings:
        try:
            sf = ctx.file(f.path)
        except (OSError, UnicodeDecodeError):
            sf = None
        if sf is not None and sf.pragma_allows(f.checker, f.line):
            f.suppressed_by = "pragma"
        elif f.fingerprint in baseline:
            f.suppressed_by = "baseline"
        else:
            new.append(f)
    return new
