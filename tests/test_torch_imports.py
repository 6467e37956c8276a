"""The port stands alone: no module of `src/repro_torch` imports JAX or the
reference package, and importing the package and its serve CLI leaves JAX
out of `sys.modules`."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py"))


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_has_modules():
    names = {p.relative_to(PORT).as_posix() for p in _port_files()}
    for twin in ("kernels/getnorm.py", "kernels/spamm_mm.py", "kernels/ops.py",
                 "core/plan.py", "core/tau_search.py", "core/spamm.py",
                 "plans/frozen.py", "serving/engine.py", "launch/serve.py"):
        assert twin in names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(PORT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_fresh_import_keeps_jax_out():
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.serving.engine\n"
        "import repro_torch.plans.precompute, repro_torch.kernels.ops\n"
        "import repro_torch.core.spamm, repro_torch.core.tau_search\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
