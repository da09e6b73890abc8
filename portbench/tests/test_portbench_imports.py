"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program: each import's top-level name
(before the first dot) is compared whole, as the port's name begins with
the JAX package's."""

import ast
import os

import pytest

import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "latentaugment_tpu"}


def _files(sub=""):
    base = os.path.join(tiny.PB, sub)
    for d, _, names in os.walk(base):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def _top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(_files()), ids=lambda p: os.path.relpath(p, tiny.PB))
def test_no_jax(path):
    assert not set(_top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_files("reference")),
                         ids=lambda p: os.path.relpath(p, tiny.PB))
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"math", "io", "pickle", "random", "zipfile", "numpy", "torch"}
    assert set(_top_names(path)) <= allowed


def test_names_compare_whole():
    assert "latentaugment_tpu_torch".split(".")[0] not in FORBIDDEN
