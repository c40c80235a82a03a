"""No JAX and no JAX package in the benchmark's process, compared by whole
top-level names; the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

from nbody_bench.harness import forbidden_modules

BENCH = os.path.join(ROOT, "nbody_bench")
# What the reference side may import: the standard library, numpy, torch
# and the benchmark's own reference modules.
REFERENCE_FILES = [os.path.join(BENCH, "reference", f)
                   for f in ("__init__.py", "nbody_seq.py")] + [
    os.path.join(BENCH, "check.py")] + [
    os.path.join(BENCH, "inputs", f)
    for f in ("__init__.py", "glibc.py", "uniform.py")]


def test_whole_name_check():
    assert forbidden_modules(["parallel_nbody_tpu_torch",
                              "parallel_nbody_tpu_torch.ops.render",
                              "jax_extras", "jaxlib_like", "numpy"]) == []
    assert forbidden_modules(["parallel_nbody_tpu.ops", "jax",
                              "jaxlib.xla_client", "flax.linen",
                              "torch"]) == ["flax", "jax", "jaxlib",
                                            "parallel_nbody_tpu"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


def test_reference_imports_nothing_of_the_program():
    allowed = {"torch", "numpy", "math", "importlib", "__future__"}
    for path in REFERENCE_FILES:
        for name in _imports(path):
            top = name.lstrip(".").split(".")[0]
            assert (name.startswith(".") and "parallel" not in name) or \
                top in allowed, (path, name)


def test_harness_process_loads_no_jax():
    code = ("import nbody_bench.run, nbody_bench.harness, "
            "nbody_bench.calibrate, sys;"
            "from nbody_bench.harness import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"
