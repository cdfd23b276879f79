"""Nothing under hvdbench/ imports JAX or the JAX package, and the reference
imports nothing of the program: top-level module names compared whole."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "horovod_tpu"}


def _sources(root):
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    """The top-level names of every module ``path`` imports (relative
    imports excluded: they stay inside the package)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", list(_sources(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", list(_sources(os.path.join(BENCH, "reference"))),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert "horovod_tpu_torch" not in top_level_imports(path)


def test_whole_names_are_compared(tmp_path):
    src = tmp_path / "x.py"
    src.write_text("import horovod_tpu_torch.ops\nfrom jaxtyping import A\n"
                   "import flax.linen as nn\n")
    got = top_level_imports(str(src))
    assert got & FORBIDDEN == {"flax"}
    assert "horovod_tpu_torch" in got
