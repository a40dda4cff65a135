"""Nothing under bench_port imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared
whole."""

import ast
import os

import pytest

from bench_port import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "interdiff_tpu"}


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(harness.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_reference_imports_nothing_of_the_port(path):
    assert "interdiff_torch" not in set(top_level_imports(path))


def test_names_are_compared_whole():
    assert "interdiff_torch" not in FORBIDDEN
    assert harness.forbidden_loaded() == []
