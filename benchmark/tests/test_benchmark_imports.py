"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port; top-level module names are
compared whole (``upcc_tpu_torch`` is the port, ``upcc_tpu`` is not)."""

import ast
import os

from benchmark.core.harness import forbidden_modules
from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _files(top, skip=("tests",)):
    for dirpath, dirnames, files in os.walk(top):
        dirnames[:] = [d for d in dirnames if d not in skip + ("__pycache__",)]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_whole_names_are_compared():
    assert forbidden_modules(["upcc_tpu_torch.codec", "torch"]) == []
    assert forbidden_modules(["upcc_tpu.codec.codec"]) == ["upcc_tpu"]
    assert forbidden_modules(["jaxlib.xla_client", "jaxtyping"]) == ["jaxlib"]
    assert forbidden_modules(["flax.core", "jax"]) == ["flax", "jax"]


def test_no_file_of_the_benchmark_imports_jax():
    for path in _files(BENCH, skip=()):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "upcc_tpu"}, \
            path


def test_the_reference_imports_nothing_of_the_port():
    for path in _files(os.path.join(BENCH, "reference")):
        names = _imports(path)
        assert not names & {"upcc_tpu_torch", "upcc_tpu", "jax", "benchmark"}, \
            (path, names)
