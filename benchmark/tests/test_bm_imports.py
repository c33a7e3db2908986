"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level module name; the plain reference imports nothing of the
program either."""

import ast

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "aswstereomatch_tpu"}
MODULES = sorted(p for p in harness.BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


def test_the_check_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import aswstereomatch_torch.ops\nfrom jax import numpy\nimport jaxtyping\n")
    assert top_level_imports(p) == {"aswstereomatch_torch", "jax", "jaxtyping"}


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(harness.REPO)))
def test_no_jax(path):
    found = top_level_imports(path)
    assert not found & FORBIDDEN
    if "reference" in path.parts:
        assert "aswstereomatch_torch" not in found and "benchmark" not in found


def test_the_run_checks_loaded_modules(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]
