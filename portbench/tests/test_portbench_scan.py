"""Nothing under portbench imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names compared
whole (the port's name begins with the JAX package's)."""

import ast
import sys
import types

import pytest

from portbench.harness import HERE, forbidden_modules

FORBIDDEN = {"jax", "jaxlib", "flax", "tardis_tpu"}


def imported(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert not imported(path) & (FORBIDDEN | {"tardis_torch"})


def test_process_check_compares_whole_names(monkeypatch):
    assert "tardis_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "tardis_tpu_extra",
                        types.ModuleType("tardis_tpu_extra"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert forbidden_modules() == ["jax"]
