"""No run loads JAX or the JAX package: the check every run makes, and
what the benchmark's own sources import."""
import ast
import pathlib

import pytest

from chipbench.harness import forbidden_modules

HERE = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("names, bad", [
    (["repro_torch", "repro_torch.serve.engine", "torch", "numpy"], []),
    (["repro_torch", "repro"], ["repro"]),
    (["repro.models.transformer"], ["repro"]),
    (["jax", "jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen", "reproduce", "jax_tools"], ["flax"]),
])
def test_forbidden_modules_compares_top_level_names_whole(names, bad):
    assert forbidden_modules(names) == bad


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p for p in HERE.rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: p.relative_to(HERE).as_posix())
def test_benchmark_sources_import_no_jax(path):
    assert forbidden_modules(list(_imports(path))) == []


@pytest.mark.parametrize("path", sorted((HERE / "references").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert {n.split(".")[0] for n in _imports(path)} <= \
        {"__future__", "math", "torch"}
