"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the program."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "gssd_tpu"}


def _loaded_after(code: str):
    """Top-level module names in sys.modules after ``code`` runs in a fresh
    interpreter at the repository's root."""
    script = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_drivers_metrics_and_reference_load_no_jax():
    code = """
import glob, os
import benchmark.run as run, benchmark.control, benchmark.work, benchmark.check
import benchmark.drivers.train, benchmark.drivers.infer, benchmark.program
bench = run.load_json("BENCHMARK.json")
for m in bench["per_layer"]:
    run.reader(m["name"])
from benchmark.program import kernel_counters
kernel_counters()
"""
    loaded = _loaded_after(code)
    assert "gssd_torch" not in FORBIDDEN
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    loaded = _loaded_after("import benchmark.reference.model, benchmark.reference.train, "
                           "benchmark.reference.infer, benchmark.reference.augment, "
                           "benchmark.reference.boxes, benchmark.reference.quant")
    assert "gssd_torch" not in loaded and not loaded & FORBIDDEN
    for path in glob.glob(os.path.join(ROOT, "benchmark", "reference", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top != "gssd_torch" and top not in FORBIDDEN, (path, name)


@pytest.mark.cuda
def test_a_run_on_the_card_loads_no_jax():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "gssdpp-300.train-b32", "--seed", "5", "--seconds", "2"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "correct" in json.loads(out.stdout.strip().splitlines()[-1])
