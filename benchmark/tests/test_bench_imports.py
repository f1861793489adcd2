"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program: every import's top-level name,
the part before the first dot, compared whole."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "difffacto_tpu"}


def modules():
    for root, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d not in ("out", "__pycache__")]  # run outputs
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), BENCH)


def top_names(path):
    tree = ast.parse(open(os.path.join(BENCH, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", list(modules()))
def test_no_forbidden_import(path):
    names = set(top_names(path))
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"
    if path.startswith("reference" + os.sep):
        assert "difffacto_torch" not in names, f"{path} imports the program"


def test_names_compared_whole():
    # the port's name begins with the JAX package's; whole names tell them apart
    assert "difffacto_torch" not in FORBIDDEN
    assert "difffacto_torch".split(".")[0] != "difffacto_tpu"
