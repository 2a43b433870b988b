"""What the benchmark imports: never JAX or the JAX package, and the
reference nothing of the program."""
import ast
import glob
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = ("jax", "jaxlib", "flax", "instantvnr_tpu")

PROBE = r"""
import glob, os, sys
sys.path.insert(0, {root!r})
from benchmark import harness, trace, peaks
from benchmark.reference import compare, fields, frame, training, volume
for sub in ("traffic", "metrics", "counts"):
    for path in glob.glob(os.path.join({root!r}, "benchmark", sub, "*.py")):
        harness.load_module({root!r}, sub, os.path.basename(path)[:-3])
# what a run imports of the program
from instantvnr_torch import api
from instantvnr_torch.render import compaction, renderer, brickcache
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print("FORBIDDEN", bad)
"""


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=ROOT, forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout


def imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(ROOT, "benchmark", "reference", "*.py"))
    assert files
    for path in files:
        roots = set(imported_roots(path))
        assert "instantvnr_torch" not in roots, path
        assert not roots & set(FORBIDDEN), path


def test_nothing_under_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"),
                          recursive=True):
        assert not set(imported_roots(path)) & set(FORBIDDEN), path


def test_the_harness_refuses_a_run_that_loaded_jax(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "jaxlib", object())
    monkeypatch.setitem(sys.modules, "instantvnr_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "instantvnr_torch_extra", object())
    assert harness.forbidden_loaded() == ["instantvnr_tpu.ops", "jaxlib"]
