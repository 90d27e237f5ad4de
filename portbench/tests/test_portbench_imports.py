"""Nothing a run imports has `jax` or `coconut_tpu` as its top-level name,
compared whole, and the plain reference imports nothing of the program."""

import ast
import subprocess
import sys

from portbench.harness import core

BENCH = core.BENCH


def test_forbidden_names_are_compared_whole(monkeypatch):
    fake = dict(sys.modules)
    for name in ("jax", "jax.numpy", "jaxlib", "flax", "coconut_tpu", "coconut_tpu.ps"):
        fake.pop(name, None)
    fake["coconut_tpu_torch"] = object()
    fake["coconut_tpu_torch.gpu"] = object()
    fake["jaxtyping"] = object()
    monkeypatch.setattr(sys, "modules", fake)
    assert core.forbidden_modules() == []
    fake["coconut_tpu.ps"] = object()
    fake["jax.numpy"] = object()
    assert core.forbidden_modules() == ["coconut_tpu", "jax"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.partition(".")[0] not in core.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            assert not name.startswith("coconut_tpu"), (path, name)


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.harness import core\n"
        "from portbench.harness.runners import stream_verify, show_loop, service_verify\n"
        "import coconut_tpu_torch.stream, coconut_tpu_torch.serve, coconut_tpu_torch.gpu.backend\n"
        "from coconut_tpu_torch.serve import CredentialService\n"
        "from coconut_tpu_torch.obs import trace\n"
        "for f in (core.BENCH / 'metrics').glob('*.py'): core.reader(f.stem)\n"
        "print(core.forbidden_modules())\n" % str(core.ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
