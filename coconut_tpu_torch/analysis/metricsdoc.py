"""metrics-doc: counter/timer/gauge names in code vs the documented glossary.

The metrics glossary lives in two places — the README's per-subsystem
"Metric glossary" paragraphs and the coconut_tpu_torch/metrics.py module
docstring (which the README declares to be the full list). Operators
alert on these names; a counter that exists in code but not in the
glossary is invisible to them, and a glossary row whose counter was
renamed away is a dashboard that silently flatlines. Both directions are
drift, and both are checked:

  undocumented   a name emitted via metrics.count / set_gauge / timer /
                 observe that matches no glossary entry (flagged at the
                 first emission site);
  stale          a glossary entry that matches no emission (flagged at
                 the doc line). Only entries whose leading name segment
                 matches some emitted family (serve_, gateway_, wal_,
                 ...) are considered — prose code-words like
                 ``max_wait_ms`` never become findings.

Dynamic names are first-class: ``"serve_dev%d_load" % i`` and f-strings
become wildcard patterns (``serve_dev*_load``) that match the README's
placeholder spelling (``serve_dev<d>_load``); bare-variable name
arguments are resolved one level through local and ``self.<attr> = ...``
assignments before giving up (unresolvable sites are skipped, not
guessed).
"""

import ast
import re

from .core import Finding

CHECKER = "metrics-doc"

_EMIT_FNS = {
    "count": "counter",
    "set_gauge": "gauge",
    "timer": "timer",
    "observe": "histogram",
}
_METRICS_RECEIVERS = {"metrics", "_metrics"}

#: %-format conversions collapse to a wildcard
_PCT_RE = re.compile(r"%[-#+ 0-9.]*[sdifuxXoer]")

#: a glossary token: lowercase snake_case, optional <placeholder> / *;
#: single-word names (``retries``, ``fallbacks``) are real counters too
_TOKEN_RE = re.compile(
    r"^(?:[a-z*][a-z0-9<>*]*(?:_[a-z0-9<>*]+)+\*?|[a-z]{4,})$"
)

_PARA_KEYWORD_RE = re.compile(
    r"(?i)\b(counters?|gauges?|glossary|metrics?|timers?|histograms?)\b"
)
_BACKTICK_RE = re.compile(r"`([^`]+)`")
_DQUOTE_RE = re.compile(r'"([a-z][a-z0-9_<>*]{3,})"')


class Emission(object):
    def __init__(self, pattern, kind, path, line):
        self.pattern = pattern  # name with * wildcards, or None
        self.kind = kind
        self.path = path
        self.line = line


def _pattern_regex(p):
    return re.compile(
        "^" + ".*".join(re.escape(seg) for seg in p.split("*")) + "$"
    )


def _pattern_sample(p):
    # a representative concrete string: wildcard -> an unlikely literal
    return p.replace("*", "q7")


def patterns_match(a, b):
    """Glob-ish intersection test: serve_dev*_load matches
    serve_dev<d>_load (normalized) and serve_dev3_load, both ways."""
    ra, rb = _pattern_regex(a), _pattern_regex(b)
    return bool(ra.match(_pattern_sample(b)) or rb.match(_pattern_sample(a)))


def _normalize_doc_token(tok):
    return re.sub(r"<[^>]*>", "*", tok.strip())


# -- code-side extraction ---------------------------------------------------


_MAX_CANDIDATES = 8


def _str_patterns(node, local_assigns=None, attr_assigns=None, depth=0):
    """Resolve an expression to the SET of wildcard name patterns it can
    take (empty set = unresolvable). Multi-candidate on purpose: the
    same ``self.busy_timer`` attribute is assigned ``serve_dev%s_busy_s``
    by the verify pool and ``issue_auth%s_busy_s`` by the mint pool."""
    if depth > 3:
        return set()
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
        return {
            _PCT_RE.sub("*", p)
            for p in _str_patterns(
                node.left, local_assigns, attr_assigns, depth + 1
            )
        }
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        l = _str_patterns(node.left, local_assigns, attr_assigns, depth + 1)
        r = _str_patterns(node.right, local_assigns, attr_assigns, depth + 1)
        out = {
            a + b
            for a in (l or {"*"})
            for b in (r or {"*"})
        }
        return set(sorted(out)[:_MAX_CANDIDATES])
    if isinstance(node, ast.IfExp):
        return _str_patterns(
            node.body, local_assigns, attr_assigns, depth + 1
        ) | _str_patterns(node.orelse, local_assigns, attr_assigns, depth + 1)
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append("*")
        return {"".join(parts)}
    if isinstance(node, ast.Name) and local_assigns is not None:
        pats = local_assigns.get(node.id) or set()
        return set(sorted(pats)[:_MAX_CANDIDATES])
    if isinstance(node, ast.Attribute) and attr_assigns is not None:
        pats = attr_assigns.get(node.attr) or set()
        return set(sorted(pats)[:_MAX_CANDIDATES])
    return set()


def _useful(patterns):
    """Drop all-wildcard patterns: an unresolvable concat must not claim
    to match every glossary row."""
    return {p for p in patterns if p.strip("*")}


def collect_emissions(ctx, files=None):
    """(emissions, unresolved) across the package.

    Besides direct ``metrics.<fn>(name, ...)`` calls, two pass-through
    idioms count as emissions: keyword arguments named ``counter=`` /
    ``gauge=`` (the engine/serve failure paths build the outcome counter
    at the call site and a helper does the count), and the string
    DEFAULT of a parameter named ``counter`` (fail_all's
    ``counter="serve_failed_requests"``)."""
    if files is None:
        files = ctx.python_files()
    # pass 1: every ``self.X = <string-ish>`` and module/local
    # ``X = <string-ish>`` feeds the resolver
    attr_assigns = {}
    per_file_locals = {}
    for rel in files:
        sf = ctx.file(rel)
        if sf.tree is None:
            continue
        local = per_file_locals.setdefault(rel, {})
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign):
                pats = _useful(_str_patterns(node.value))
                if not pats:
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute):
                        attr_assigns.setdefault(tgt.attr, set()).update(pats)
                    elif isinstance(tgt, ast.Name):
                        local.setdefault(tgt.id, set()).update(pats)
    emissions, unresolved = [], []

    def emit(arg_node, kind, rel, line, local):
        pats = _useful(_str_patterns(arg_node, local, attr_assigns))
        if not pats:
            unresolved.append(Emission(None, kind, rel, line))
        for pat in sorted(pats):
            emissions.append(Emission(pat, kind, rel, line))

    for rel in files:
        sf = ctx.file(rel)
        if sf.tree is None:
            continue
        local = per_file_locals.get(rel, {})
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # string default of a parameter named counter/gauge
                pos = node.args.args
                pairs = list(
                    zip(pos[len(pos) - len(node.args.defaults):],
                        node.args.defaults)
                ) + list(zip(node.args.kwonlyargs, node.args.kw_defaults))
                for a, d in pairs:
                    if d is not None and a.arg in ("counter", "gauge"):
                        emit(
                            d,
                            "counter" if a.arg == "counter" else "gauge",
                            rel,
                            node.lineno,
                            local,
                        )
                continue
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr in _EMIT_FNS
                and isinstance(fn.value, ast.Name)
                and fn.value.id in _METRICS_RECEIVERS
                and node.args
            ):
                emit(node.args[0], _EMIT_FNS[fn.attr], rel, node.lineno, local)
                continue
            for kw in node.keywords:
                if kw.arg in ("counter", "gauge"):
                    emit(
                        kw.value,
                        "counter" if kw.arg == "counter" else "gauge",
                        rel,
                        node.lineno,
                        local,
                    )
    return emissions, unresolved


# -- doc-side extraction ----------------------------------------------------


def collect_doc_entries(ctx):
    """[(normalized_pattern, raw_token, path, line)] from the README
    glossary paragraphs and the metrics.py module docstring."""
    entries = []
    if ctx.exists("README.md"):
        sf = ctx.file("README.md")
        para_lines = []  # (line_no, text) of current paragraph
        paras = []
        for i, line in enumerate(sf.lines, start=1):
            if line.strip():
                para_lines.append((i, line))
            elif para_lines:
                paras.append(para_lines)
                para_lines = []
        if para_lines:
            paras.append(para_lines)
        for para in paras:
            text = "\n".join(t for _, t in para)
            if not _PARA_KEYWORD_RE.search(text):
                continue
            for line_no, line in para:
                if line.lstrip().startswith("|"):
                    continue  # markdown table rows name programs/knobs,
                    # not glossary entries
                for m in _BACKTICK_RE.finditer(line):
                    tok = m.group(1).strip()
                    if "(" in tok or "." in tok or " " in tok:
                        continue
                    norm = _normalize_doc_token(tok)
                    if _TOKEN_RE.match(norm):
                        entries.append((norm, tok, "README.md", line_no))
    rel = "coconut_tpu_torch/metrics.py"
    if ctx.exists(rel):
        sf = ctx.file(rel)
        if (
            sf.tree is not None
            and sf.tree.body
            and isinstance(sf.tree.body[0], ast.Expr)
            and isinstance(sf.tree.body[0].value, ast.Constant)
        ):
            end_line = sf.tree.body[0].end_lineno
            for i, line in enumerate(sf.lines[:end_line], start=1):
                for m in _DQUOTE_RE.finditer(line):
                    norm = _normalize_doc_token(m.group(1))
                    if _TOKEN_RE.match(norm):
                        entries.append((norm, m.group(1), rel, i))
    return entries


# -- the checker ------------------------------------------------------------


def run(ctx, files=None):
    emissions, unresolved = collect_emissions(ctx, files)
    entries = collect_doc_entries(ctx)
    findings = []

    doc_patterns = [e[0] for e in entries]
    # undocumented: first emission site per distinct pattern
    seen = set()
    for em in emissions:
        if em.pattern in seen:
            continue
        seen.add(em.pattern)
        if not any(patterns_match(em.pattern, d) for d in doc_patterns):
            findings.append(
                Finding(
                    CHECKER,
                    "undocumented",
                    em.path,
                    em.line,
                    "%s %r is emitted but appears in neither the README "
                    "metric glossary nor the metrics.py docstring"
                    % (em.kind, em.pattern),
                    key="undocumented:%s:%s" % (em.kind, em.pattern),
                )
            )

    # stale: glossary rows naming a family we emit, matching nothing
    families = {
        em.pattern.split("_", 1)[0]
        for em in emissions
        if not em.pattern.startswith("*")
    }
    flagged = set()
    for norm, raw, path, line in entries:
        fam = norm.split("_", 1)[0]
        if fam not in families or norm in flagged:
            continue
        # a doc token that is a literal PREFIX of an emitted name is a
        # counters_with_prefix() family reference, not a stale row
        if any(em.pattern.startswith(norm) for em in emissions):
            continue
        if not any(patterns_match(norm, em.pattern) for em in emissions):
            flagged.add(norm)
            findings.append(
                Finding(
                    CHECKER,
                    "stale",
                    path,
                    line,
                    "glossary entry %r matches no metric emitted anywhere "
                    "in coconut_tpu_torch (renamed or removed?)" % raw,
                    key="stale:%s" % norm,
                )
            )
    return findings
