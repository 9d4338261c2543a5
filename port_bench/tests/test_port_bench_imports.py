"""Nothing under port_bench/ imports JAX or the JAX package, and the plain
references import nothing of the port either. Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import ast
import os

import pytest

from port_bench import cells

JAX = {"jax", "jaxlib", "flax", "ntire2022_esr_tpu"}
PORT = {"ntire2022_esr_tpu_torch", "port_bench"}


def _sources():
    for dirpath, _, files in os.walk(cells.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, cells.HERE))
def test_no_jax_imports(path):
    tops = set(_tops(path))
    assert not tops & JAX, tops & JAX
    if os.path.relpath(path, cells.HERE).startswith("reference" + os.sep):
        assert not tops & PORT, tops & PORT


def test_whole_names_compared():
    from port_bench import run

    assert "ntire2022_esr_tpu_torch".split(".")[0] not in run.FORBIDDEN
    assert "ntire2022_esr_tpu" in run.FORBIDDEN
