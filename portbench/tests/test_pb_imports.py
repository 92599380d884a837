"""No module of the benchmark imports JAX, the JAX package or its
benchmarks (top-level names compared whole: the port's name begins with
the JAX package's), and the references import nothing of the program."""

import ast

import pytest

from pbench import spec
from run import FORBIDDEN
SOURCES = sorted(spec.HERE.rglob("*.py"))


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "numpy"}


def test_names_are_compared_whole(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import rabia_tpu_torch.kernel\nfrom rabia_tpu_torch import x\n")
    assert top_level_imports(p) == {"rabia_tpu_torch"}
    assert not top_level_imports(p) & FORBIDDEN
