"""What the benchmark imports: never JAX or the JAX package (top-level
names compared whole, so `upgpt_torch` is not `upgpt_tpu`), and the
reference nothing of the program."""

import ast
import os

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "upgpt_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _modules(sub=""):
    base = os.path.join(spec.HERE, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    found = {(p, n) for p in _modules() for n in _imports(p)
             if n in FORBIDDEN}
    assert not found


def test_reference_imports_nothing_of_the_program():
    found = {(p, n) for p in _modules("reference") for n in _imports(p)
             if n == "upgpt_torch" or n in FORBIDDEN}
    assert not found


def test_the_whole_name_is_compared():
    from portbench.run import FORBIDDEN as RUN_FORBIDDEN

    assert "upgpt_torch".split(".")[0] not in RUN_FORBIDDEN
    assert set(RUN_FORBIDDEN) == FORBIDDEN
