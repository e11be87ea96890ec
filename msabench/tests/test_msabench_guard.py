"""The import guard, and what the benchmark's own files import."""

import ast
import os

import pytest

from msabench import guard
from msabench.tests.conftest import ROOT

HERE = os.path.join(ROOT, "msabench")


@pytest.mark.parametrize("modules, found", [
    (["kalign_tpu_torch", "kalign_tpu_torch.gpu.engine", "torch"], []),
    (["kalign_tpu", "kalign_tpu_torch"], ["kalign_tpu"]),
    (["kalign_tpu.tpu.engine"], ["kalign_tpu"]),
    (["jax._src.core", "jaxlib", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["benchmarks.runner", "bench"], ["bench", "benchmarks"]),
    (["jaxtyping", "benchmarks_x", "kalign_tpu_x"], []),
])
def test_names_are_compared_whole_at_the_top_level(modules, found):
    assert guard.forbidden_loaded(modules) == found


def imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_of_the_benchmark_imports_jax_or_the_old_packages():
    for path in sources():
        bad = set(imports(path)) & guard.FORBIDDEN
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        mods = set(imports(path))
        assert mods <= {"numpy", "torch", "msabench"}, (path, mods)
    with open(os.path.join(HERE, "families.py")) as fh:
        assert set(imports(os.path.join(HERE, "families.py"))) <= {"numpy"}


def test_the_run_checks_its_imports():
    with open(os.path.join(HERE, "run.py")) as fh:
        assert "guard.forbidden_loaded()" in fh.read()
