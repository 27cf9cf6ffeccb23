"""Nothing under benchmark/ imports JAX, the JAX package or the JAX-side
scripts, and the plain references import nothing of the program: each
import's top-level name (the part before the first dot) is compared whole,
since the port's name begins with the JAX package's."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "posecnn_tpu", "__graft_entry__", "bench", "chip_smoke", "tests"}


def modules():
    for d, _, files in os.walk(BENCH):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", list(modules()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    bad = set(top_names(path)) & FORBIDDEN
    assert not bad, f"{os.path.relpath(path, BENCH)} imports {sorted(bad)}"


@pytest.mark.parametrize("path", [p for p in modules() if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_names(path))
    assert "posecnn_torch" not in names
    assert names <= {"__future__", "math", "os", "typing", "numpy", "torch", "benchmark"}


def test_the_whole_name_is_compared():
    # the port's name begins with the JAX package's: a prefix test would refuse it
    assert "posecnn_torch".split(".")[0] not in FORBIDDEN
    assert "posecnn_tpu.ops".split(".")[0] in FORBIDDEN
