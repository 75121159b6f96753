"""No module that a cell loads, and no file of the benchmark, is of JAX,
jaxlib, flax or the JAX package (`open3d_tpu`); the reference imports
nothing of the program (`open3d_tpu_torch`). Names are compared by their
whole top-level part: `open3d_tpu_torch` begins with `open3d_tpu` and is
not it."""

import ast
import json
import subprocess
import sys

from benchmark.tests.conftest import ROOT, TINY

FORBIDDEN = {"jax", "jaxlib", "flax", "open3d_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not set(_imports(f)) & FORBIDDEN, f


def test_reference_and_counts_import_nothing_of_the_program():
    for sub in ("reference", "counts"):
        for f in sorted((ROOT / "benchmark" / sub).rglob("*.py")):
            assert "open3d_tpu_torch" not in set(_imports(f)), f


def test_modules_loaded_by_a_run():
    code = (
        "import json, sys\n"
        "from benchmark import run\n"
        f"ov = json.loads({json.dumps(json.dumps(TINY))})\n"
        "for cell in ('slam640.track', 'slam640.known_pose'):\n"
        "    assert run.main(['--workload', cell, '--seed', '2147483931', '--seconds', '0.5',"
        " '--trace', '1'], device='cpu', overrides=ov) == 0\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=240, env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "4"})
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "open3d_tpu_torch" in loaded and "benchmark" in loaded
    assert not loaded & FORBIDDEN
