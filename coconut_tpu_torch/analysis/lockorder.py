"""lock-order: static lock-acquisition-order graph from ``with`` nesting.

The fleet runs a dozen cooperating thread families (engine placer,
per-device executors, watchdog, authority workers, gossip, replicators,
WAL group-commit) whose only deadlock defense is a conventional
acquisition order. This checker makes that order explicit:

  pass 1  collect lock *definitions*: every ``threading.Lock() /
          RLock() / Condition()`` allocation bound to ``self.<attr>``
          (keyed by enclosing class) or to a module-level name;
  pass 2  walk every function's ``with`` statements and record an edge
          A -> B whenever lock B is acquired syntactically inside a
          ``with A:`` body (intra-function nesting only — deliberately
          conservative: cross-function edges need the runtime tracker,
          see analysis/lockcheck.py);
  pass 3  fail on any directed cycle among distinct locks (self-edges
          are ignored: re-entering the same RLock is legal here).

Lock identity resolution for ``with <expr>:``, in order: ``self.X``
resolves against the enclosing class's definitions; a bare module-level
name resolves within the module; otherwise ``obj.X`` resolves only when
exactly one class in the tree defines lock attribute ``X`` (ambiguous
attrs are skipped rather than guessed — false cycles are worse than
missed edges, and the runtime tracker covers real interleavings).
"""

import ast

from .core import Finding

CHECKER = "lock-order"

_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}


def _is_lock_ctor(node):
    """True for ``threading.Lock()`` / ``Lock()`` / ``RLock()`` /
    ``Condition()`` call expressions (with or without args — Condition
    takes an optional lock)."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr in _LOCK_FACTORIES
    if isinstance(fn, ast.Name):
        return fn.id in _LOCK_FACTORIES
    return False


def _collect_defs(ctx, files):
    """Two maps:
    attr_owners: attr name -> set of "module.Class" that allocate a lock
                 into self.<attr>
    module_locks: (relpath, name) for module-level ``NAME = Lock()``"""
    attr_owners = {}
    module_locks = set()
    for rel in files:
        sf = ctx.file(rel)
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                cls_id = "%s.%s" % (rel, node.name)
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Assign) and _is_lock_ctor(sub.value):
                        for tgt in sub.targets:
                            if (
                                isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"
                            ):
                                attr_owners.setdefault(tgt.attr, set()).add(
                                    cls_id
                                )
        for node in sf.tree.body:
            if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        module_locks.add((rel, tgt.id))
    return attr_owners, module_locks


def _resolve(expr, rel, cls_name, attr_owners, module_locks):
    """Map a ``with`` context expression to a stable lock node id, or
    None when it isn't (resolvably) one of the tree's locks."""
    if isinstance(expr, ast.Name):
        if (rel, expr.id) in module_locks:
            return "%s::%s" % (rel, expr.id)
        return None
    if isinstance(expr, ast.Attribute):
        attr = expr.attr
        owners = attr_owners.get(attr)
        if not owners:
            return None
        if (
            isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and cls_name is not None
        ):
            cls_id = "%s.%s" % (rel, cls_name)
            if cls_id in owners:
                return "%s.%s" % (cls_id, attr)
            # self.<attr> in a class that doesn't define it (mixin /
            # injected): fall through to the unique-owner rule.
        if len(owners) == 1:
            return "%s.%s" % (next(iter(owners)), attr)
        return None  # ambiguous attr name — skip, don't guess
    return None


class _WithWalker(ast.NodeVisitor):
    """Per-function walk recording held-lock nesting edges."""

    def __init__(self, rel, attr_owners, module_locks, edges):
        self.rel = rel
        self.attr_owners = attr_owners
        self.module_locks = module_locks
        self.edges = edges  # (a, b) -> first evidence dict
        self.cls_stack = []
        self.fn_stack = []
        self.held = []

    def visit_ClassDef(self, node):
        self.cls_stack.append(node.name)
        self.generic_visit(node)
        self.cls_stack.pop()

    def _visit_fn(self, node):
        self.fn_stack.append(node.name)
        saved, self.held = self.held, []  # nesting doesn't cross def
        self.generic_visit(node)
        self.held = saved
        self.fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_With(self, node):
        cls = self.cls_stack[-1] if self.cls_stack else None
        acquired = []
        for item in node.items:
            lock = _resolve(
                item.context_expr,
                self.rel,
                cls,
                self.attr_owners,
                self.module_locks,
            )
            if lock is not None:
                for h in self.held:
                    if h != lock:
                        self.edges.setdefault(
                            (h, lock),
                            {
                                "path": self.rel,
                                "line": node.lineno,
                                "fn": ".".join(
                                    filter(None, [cls] + self.fn_stack[-1:])
                                ),
                            },
                        )
                acquired.append(lock)
                self.held.append(lock)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    visit_AsyncWith = visit_With


def build_graph(ctx, files=None):
    """(edges, attr_owners, module_locks) — exposed for tests and for
    the README's "what does the static pass actually see" story."""
    if files is None:
        files = ctx.python_files()
    attr_owners, module_locks = _collect_defs(ctx, files)
    edges = {}
    for rel in files:
        sf = ctx.file(rel)
        if sf.tree is None:
            continue
        _WithWalker(rel, attr_owners, module_locks, edges).visit(sf.tree)
    return edges, attr_owners, module_locks


def _find_cycles(edges):
    """Tarjan SCC over the lock graph; every SCC with >1 node is an
    ordering cycle. Returns a list of node lists."""
    graph = {}
    for (a, b) in edges:
        graph.setdefault(a, []).append(b)
        graph.setdefault(b, [])
    index = {}
    low = {}
    on_stack = set()
    stack = []
    counter = [0]
    sccs = []

    def strongconnect(v):
        # iterative Tarjan: (node, iterator) frames
        work = [(v, iter(graph[v]))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(graph[w])))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    sccs.append(sorted(scc))

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return sccs


def run(ctx, files=None):
    edges, _owners, _mods = build_graph(ctx, files)
    findings = []
    for scc in _find_cycles(edges):
        members = set(scc)
        evidence = sorted(
            "%s -> %s at %s:%d in %s"
            % (a, b, ev["path"], ev["line"], ev["fn"])
            for (a, b), ev in edges.items()
            if a in members and b in members
        )
        anchor = min(
            (
                (ev["path"], ev["line"])
                for (a, b), ev in edges.items()
                if a in members and b in members
            ),
            default=("coconut_tpu_torch", 1),
        )
        findings.append(
            Finding(
                CHECKER,
                "cycle",
                anchor[0],
                anchor[1],
                "lock acquisition-order cycle among {%s}: %s"
                % ("; ".join(scc), "; ".join(evidence)),
                key="cycle:" + "|".join(scc),
            )
        )
    return findings
