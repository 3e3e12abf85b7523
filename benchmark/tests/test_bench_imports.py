"""The JAX check by whole top-level names, and what the reference may
import."""

import ast

import pytest

from benchmark import harness
from benchmark.imports import forbidden_modules


@pytest.mark.parametrize("name,bad", [
    ("comapreduce_tpu_torch", False), ("comapreduce_tpu_torch.x", False),
    ("comapreduce_tpu", True), ("comapreduce_tpu.x", True),
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("jaxtyping", False), ("torch", False)])
def test_top_level_names_compared_whole(name, bad):
    assert bool(forbidden_modules({name: None})) is bad


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (harness.BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top in ("torch", "math", "__future__", "benchmark"), mod
        assert not mod.startswith("benchmark.") or \
            mod.startswith("benchmark.reference"), mod


@pytest.mark.parametrize("path", sorted(harness.BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_source_imports_jax(path):
    for mod in _imports(path):
        assert not forbidden_modules({mod: None}), mod


def test_run_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a host without")
    import runpy
    import sys
    argv = sys.argv
    sys.argv = ["run.py", "--workload", "ces_obs.full", "--seed", "1",
                "--seconds", "1", "--trace", "0"]
    try:
        with pytest.raises(SystemExit) as exc:
            runpy.run_path(str(harness.BENCH / "run.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv
    assert exc.value.code != 0
    assert capsys.readouterr().out == ""
