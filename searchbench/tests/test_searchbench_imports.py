"""No module of the benchmark imports JAX, the JAX package or `bench.py`,
by whole top-level names; the reference and the generators import nothing
of the program."""

import ast
import os

import pytest
from conftest import ROOT

BENCH = os.path.join(ROOT, "searchbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "tantivy_tpu", "bench"}
#: the yardstick's modules, which may not import the program either
PLAIN = ("reference.py", "corpus.py", "traffic.py", "control.py")


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_forbidden_import(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("name", PLAIN)
def test_the_yardstick_imports_nothing_of_the_program(name):
    names = set(top_level_imports(os.path.join(BENCH, name)))
    assert "tantivy_tpu_torch" not in names
    assert "torch" not in names


def test_whole_names_are_compared():
    assert "tantivy_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "tantivy_tpu.query".split(".")[0] in FORBIDDEN
