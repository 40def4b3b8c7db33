"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference's modules load nothing of the program either (top-level module
names, compared whole)."""

import ast
import glob
import os
import subprocess
import sys

from benchmark import harness

REFERENCE_SIDE = ["benchmark.reference", "benchmark.check", "benchmark.roofline",
                  "benchmark.scene", "benchmark.control"]


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_side_loads_no_program():
    loaded = _loaded_after("\n".join(f"import {m}" for m in REFERENCE_SIDE))
    assert not loaded & {"jax", "jaxlib", "flax", "tpu_renderer", "tpu_renderer_torch"}


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'benchmark/tests')\n"
            "from conftest import tiny\n"
            "from benchmark import harness\n"
            "harness.run_cell('grid64.seq', 3, 0.0, False, device='cpu', adjust=tiny)\n"
            "assert not harness.forbidden_modules()")
    loaded = _loaded_after(code)
    assert "tpu_renderer_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "tpu_renderer"}


def test_no_source_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(harness.HERE, "**", "*.py"), recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "tpu_renderer"), \
                    (path, n)
