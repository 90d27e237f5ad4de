"""durability: every durable write goes through atomic.replace_* or the WAL.

state/atomic.py is the single blessed crash-atomic write path
(tmp + fsync + os.replace + directory fsync) and state/wal.py owns its
own append handles with CRC framing + torn-tail recovery. Any OTHER
``open(..., "w"/"a"/"x"/"+")`` or ``Path.write_text/write_bytes`` in the
package is a potential torn file: a crash mid-write leaves a partial
manifest/checkpoint/journal that a reader later chokes on.

Rules:
  bare-write    write-mode ``open()`` / ``write_text`` / ``write_bytes``
                outside the blessed modules. Sites that are genuinely
                fine (best-effort observability artifacts, append-only
                JSONL whose reader tolerates a torn tail) carry a
                ``# lint: allow(durability, <why>)`` pragma — the
                justification lives next to the write.

Read-mode opens and opens of non-file objects (sockets, BytesIO) are
not flagged; mode strings that can't be resolved statically (variables)
are flagged conservatively — a pragma or refactor to a literal mode
settles them.
"""

import ast

from .core import Finding

CHECKER = "durability"

#: modules that ARE the blessed durable-write implementations
ALLOWED_MODULES = (
    "coconut_tpu_torch/state/atomic.py",
    "coconut_tpu_torch/state/wal.py",
)

_WRITE_MODE_CHARS = set("wax+")


def _mode_writes(call):
    """True / False / None(=unresolvable) for whether this open() call's
    mode writes."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return False  # default "r"
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return bool(_WRITE_MODE_CHARS & set(mode.value))
    return None


def run(ctx, files=None):
    if files is None:
        files = ctx.python_files()
    findings = []
    for rel in files:
        if rel in ALLOWED_MODULES:
            continue
        sf = ctx.file(rel)
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id == "open":
                writes = _mode_writes(node)
                if writes is False:
                    continue
                mode_desc = (
                    "unresolvable mode" if writes is None else "write mode"
                )
                # describe the target expression for a stable key
                tgt = (
                    ast.unparse(node.args[0]) if node.args else "<unknown>"
                )
                findings.append(
                    Finding(
                        CHECKER,
                        "bare-write",
                        rel,
                        node.lineno,
                        "bare open(%s, %s) bypasses state/atomic.py "
                        "replace_* and the WAL: a crash mid-write leaves "
                        "a torn file" % (tgt, mode_desc),
                        key="bare-write:open:%s" % tgt,
                    )
                )
            elif isinstance(fn, ast.Attribute) and fn.attr in (
                "write_text",
                "write_bytes",
            ):
                tgt = ast.unparse(fn.value)
                findings.append(
                    Finding(
                        CHECKER,
                        "bare-write",
                        rel,
                        node.lineno,
                        "bare %s.%s() bypasses state/atomic.py replace_* "
                        "and the WAL: a crash mid-write leaves a torn "
                        "file" % (tgt, fn.attr),
                        key="bare-write:%s:%s" % (fn.attr, tgt),
                    )
                )
    return findings
