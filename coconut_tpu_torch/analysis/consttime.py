"""const-time: CONSTTIME.md's no-secret-branches rule, machine-checked.

Coconut's threat model (Sonnino et al. §5; reference enforces it with
multi_scalar_mul_const_time) forbids secret-dependent timing on the
issuance path. CONSTTIME.md states the repo's discipline in prose; this
checker encodes the Python-level half of it as taint rules over the
scope the doc covers: gpu/ + signature.py + sss.py.

Taint SOURCES (curated table, not inference — the secrets are known):
  - key-share / secret-key parameters (batch_blind_sign.sigkey,
    batch_unblind.elgamal_sk, poly_eval.coeffs,
    reconstruct_secret.shares, fr_digits_signed_np.scalars,
    glv.decompose.k);
  - hidden messages entering the blind-sign path
    (batch_prepare_blind_sign.messages_list);
  - fresh randomness: any call of rand_fr / poly_random /
    secrets.randbelow (blinding scalars ARE secrets until the
    commitment is opened).

PROPAGATION is intra-function and syntactic: assignment from a tainted
expression taints the targets, iterating a tainted iterable taints the
loop variable(s), arithmetic/method calls on tainted values stay
tainted. ``len(x)``, ``isinstance``, shape/dtype attribute reads, and
``is None`` tests SANITIZE — sizes and presence are public.

FLAGS (each a rule):
  secret-branch   ``if`` / ``while`` / ``assert`` / ternary whose test
                  reads a tainted value — Python control flow with
                  secret-dependent direction;
  secret-cast     ``int(x)`` / ``bool(x)`` on a tainted value — CPython
                  big-int conversion cost correlates with bit length
                  (CONSTTIME.md §1's documented host caveat: the two
                  accepted sites carry ``# lint: allow(const-time)``
                  pragmas citing it).

Intra-function only, by design: cross-function flows go through jnp
arrays on device where lane-uniform kernels make timing data-independent
— the Python boundary is exactly where the discipline can silently rot.
"""

import ast

from .core import Finding

CHECKER = "const-time"

#: the scope CONSTTIME.md covers
SCOPE_PREFIXES = (
    "coconut_tpu_torch/gpu/",
    "coconut_tpu_torch/signature.py",
    "coconut_tpu_torch/sss.py",
)

#: (relpath, function name) -> parameter names that arrive secret
SECRET_PARAMS = {
    ("coconut_tpu_torch/signature.py", "batch_blind_sign"): ("sigkey",),
    ("coconut_tpu_torch/signature.py", "batch_unblind"): ("elgamal_sk",),
    ("coconut_tpu_torch/signature.py", "batch_prepare_blind_sign"): (
        "messages_list",
    ),
    ("coconut_tpu_torch/sss.py", "poly_eval"): ("coeffs",),
    ("coconut_tpu_torch/sss.py", "reconstruct_secret"): ("shares",),
    ("coconut_tpu_torch/gpu/limbs.py", "fr_digits_signed_np"): ("scalars",),
    ("coconut_tpu_torch/gpu/glv.py", "decompose"): ("k",),
}

#: calls whose RESULT is secret wherever they appear in scope
SECRET_CALLS = {"rand_fr", "poly_random", "randbelow"}

#: attribute reads that are public even on secret values
PUBLIC_ATTRS = {"shape", "dtype", "ndim", "size", "nbytes", "keys"}

#: call targets that launder taint (public summaries of secret data)
SANITIZING_CALLS = {"len", "isinstance", "type", "id", "range", "sorted_ids"}

_CAST_CALLS = {"int", "bool"}


def _dotted(node):
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Taint(object):
    """Per-function taint state + finding emission."""

    def __init__(self, rel, fn_name, seeds):
        self.rel = rel
        self.fn = fn_name
        self.tainted = set(seeds)

    # -- expression taint ---------------------------------------------------

    def expr_tainted(self, node):
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            d = _dotted(node)
            if d is not None and d in self.tainted:
                return True
            if node.attr in PUBLIC_ATTRS:
                return False
            return self.expr_tainted(node.value)
        if isinstance(node, ast.Call):
            fn = node.func
            fn_name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None
            )
            if fn_name in SANITIZING_CALLS:
                return False
            if fn_name in SECRET_CALLS:
                return True
            if isinstance(fn, ast.Attribute) and self.expr_tainted(fn.value):
                return True  # method on a tainted value
            return any(
                self.expr_tainted(a) for a in node.args
            ) or any(self.expr_tainted(kw.value) for kw in node.keywords)
        if isinstance(node, ast.Compare):
            # `x is None` / `x is not None`: presence is public
            if all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
            ) and all(
                isinstance(c, ast.Constant) and c.value is None
                for c in node.comparators
            ):
                return False
            return self.expr_tainted(node.left) or any(
                self.expr_tainted(c) for c in node.comparators
            )
        # generic: any tainted child taints the expression
        return any(
            self.expr_tainted(child)
            for child in ast.iter_child_nodes(node)
            if isinstance(child, ast.expr)
        )

    # -- assignment targets -------------------------------------------------

    def taint_target(self, tgt):
        if isinstance(tgt, ast.Name):
            self.tainted.add(tgt.id)
        elif isinstance(tgt, ast.Attribute):
            d = _dotted(tgt)
            if d is not None:
                self.tainted.add(d)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self.taint_target(elt)
        elif isinstance(tgt, ast.Starred):
            self.taint_target(tgt.value)


def _first_arg_tainted(call, taint):
    return bool(call.args) and taint.expr_tainted(call.args[0])


def _scan_function(rel, fn_node, seeds, findings):
    taint = _Taint(rel, fn_node.name, seeds)
    body = fn_node.body

    def propagate(stmts):
        for node in stmts:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign):
                    if taint.expr_tainted(sub.value):
                        for t in sub.targets:
                            taint.taint_target(t)
                elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                    if sub.value is not None and taint.expr_tainted(sub.value):
                        taint.taint_target(sub.target)
                elif isinstance(sub, (ast.For, ast.AsyncFor)):
                    if taint.expr_tainted(sub.iter):
                        taint.taint_target(sub.target)
                elif isinstance(sub, (ast.ListComp, ast.SetComp,
                                      ast.DictComp, ast.GeneratorExp)):
                    for gen in sub.generators:
                        if taint.expr_tainted(gen.iter):
                            taint.taint_target(gen.target)
                elif isinstance(sub, ast.NamedExpr):
                    if taint.expr_tainted(sub.value):
                        taint.taint_target(sub.target)

    # two propagation passes: loops can carry taint backward in source
    # order (x tainted at loop bottom, read at loop top)
    propagate(body)
    propagate(body)

    def flag(rule, node, what):
        findings.append(
            Finding(
                CHECKER,
                rule,
                rel,
                node.lineno,
                "%s in %s(): %s — secret-dependent Python-level timing "
                "(CONSTTIME.md)" % (rule, fn_node.name, what),
                key="%s:%s:%s" % (rule, fn_node.name, what),
            )
        )

    for node in ast.walk(fn_node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node is not fn_node:
                continue  # nested defs get their own scan
        if isinstance(node, (ast.If, ast.While)) and taint.expr_tainted(
            node.test
        ):
            src = _dotted(node.test) or ast.dump(node.test)[:60]
            flag("secret-branch", node, "branch on tainted %r" % src)
        elif isinstance(node, ast.IfExp) and taint.expr_tainted(node.test):
            flag("secret-branch", node, "ternary on tainted test")
        elif isinstance(node, ast.Assert) and taint.expr_tainted(node.test):
            flag("secret-branch", node, "assert on tainted value")
        elif isinstance(node, ast.Call):
            fn = node.func
            if (
                isinstance(fn, ast.Name)
                and fn.id in _CAST_CALLS
                and _first_arg_tainted(node, taint)
            ):
                arg = _dotted(node.args[0]) or "<expr>"
                flag(
                    "secret-cast",
                    node,
                    "%s() on tainted %r" % (fn.id, arg),
                )


def run(ctx, files=None):
    if files is None:
        files = ctx.python_files()
    findings = []
    for rel in files:
        if not rel.startswith(SCOPE_PREFIXES):
            continue
        sf = ctx.file(rel)
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            seeds = SECRET_PARAMS.get((rel, node.name), ())
            declared = {
                a.arg
                for a in (
                    node.args.posonlyargs
                    + node.args.args
                    + node.args.kwonlyargs
                )
            }
            _scan_function(
                rel, node, [s for s in seeds if s in declared], findings
            )
    # dedupe by fingerprint (ast.walk visits nested ifs once per parent fn
    # plus once per nested fn scan)
    seen = set()
    out = []
    for f in findings:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            out.append(f)
    return out
