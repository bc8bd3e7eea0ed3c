"""Nothing under portbench imports JAX, jaxlib, Flax or the JAX package,
and the reference imports nothing of the program. Top-level module names
are compared whole: the program's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "dstack_tpu"}


def imported_top_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def sources(root: Path):
    return sorted(p for p in root.rglob("*.py") if ".cache" not in p.parts)


@pytest.mark.parametrize("path", sources(PKG), ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_side_import(path):
    assert not set(imported_top_names(path)) & JAX_SIDE


@pytest.mark.parametrize("path", sources(PKG / "reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(imported_top_names(path))
    assert "dstack_tpu_torch" not in names and not names & JAX_SIDE


def test_the_comparison_is_by_whole_names():
    src = "import dstack_tpu_torch.workloads\nfrom dstack_tpu_torch import x\n"
    p = PKG / "tests" / "__init__.py"
    tree = ast.parse(src)
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    assert names == {"dstack_tpu_torch"} and not names & JAX_SIDE
    assert p.exists()


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types

    from portbench import run

    assert "dstack_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax"]
