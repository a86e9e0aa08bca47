"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program under test.  Module names are
compared by their top-level part, whole: ``psk_soft_tpu_torch`` is the
port, ``psk_soft_tpu`` the JAX package."""

import ast
import sys
import types

import pytest

from portbench import manifest, run

JAX = {"jax", "jaxlib", "flax", "psk_soft_tpu"}
PROGRAM = "psk_soft_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            yield node.args[0].value.split(".")[0]


FILES = sorted(manifest.HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(manifest.HERE))
                              for p in FILES])
def test_no_jax(path):
    assert not set(_imports(path)) & JAX
    if "reference" in path.relative_to(manifest.HERE).parts:
        assert PROGRAM not in set(_imports(path))


def test_forbidden_modules_seen(monkeypatch):
    for name in ("jax", "psk_soft_tpu"):
        sys.modules.pop(name, None)
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "psk_soft_tpu",
                        types.ModuleType("psk_soft_tpu"))
    bad = run.forbidden_modules()
    assert "flax" in bad and "psk_soft_tpu" in bad
    assert "psk_soft_tpu_torch" not in bad
