"""No run loads JAX or the JAX package, and the reference loads nothing of
the port: each cell's run, in a fresh interpreter, then its modules by
whole top-level name."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from benchmark.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "passiveradar_tpu"}

RUN = """
import json, sys
sys.path[:0] = [{copy!r}, {repo!r}]
from benchmark.core import harness
harness.run({cell!r}, 3, 0.2, False, device="cpu", root={bench!r})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_run_loads_no_jax(copy, cell):
    code = RUN.format(copy=os.path.dirname(copy), repo=tiny.REPO, cell=cell,
                      bench=copy)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=tiny.REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN
    assert "passiveradar_torch" in loaded


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    tiny.BENCH, "reference", "*.py"))), ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert "passiveradar_torch" not in tops and not tops & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.pipelines, benchmark.reference.detect;"
            " print(sorted({m.split('.')[0] for m in sys.modules}))"
            % tiny.REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "passiveradar_torch" not in out.stdout
    assert not any(f"'{m}'" in out.stdout for m in FORBIDDEN)
