"""Nothing the benchmark runs loads JAX, and the reference imports nothing
of the program. Module names are compared by their whole top-level name:
the program's package name begins with the JAX package's."""

import ast
import json
import os
import subprocess
import sys

from wmbench.tests.tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "hunyuanworld_mirror_tpu"}
PROGRAM = "hunyuanworld_mirror_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "wmbench" / "reference").glob("*.py"):
        names = set(_imports(path))
        assert PROGRAM not in names and not names & FORBIDDEN, path


def test_harness_sources_name_no_jax():
    for path in (REPO / "wmbench").rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_no_jax_after_a_run():
    """A tiny cell rehearsed on the CPU in a fresh process leaves no JAX
    module behind."""
    code = (
        "import json, sys\n"
        "from wmbench import run\n"
        "from wmbench.tests import tiny\n"
        "res = run.run_cell(tiny.parts(), 7, 0.5, False, 'cpu', log=lambda *_: None)\n"
        "print(json.dumps(run.forbidden_loaded()))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                         capture_output=True, text=True, timeout=600).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


def test_forbidden_compares_whole_names(monkeypatch):
    from wmbench import run
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    monkeypatch.setitem(sys.modules, "hunyuanworld_mirror_tpu_torchx", sys)
    assert "jaxfoo" not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert "flax.core" in run.forbidden_loaded()
