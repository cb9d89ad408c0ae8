"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the port; names are compared as whole
top-level names (the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import os

from harness import core, registry

FORBIDDEN = {"jax", "jaxlib", "flax", "cosyvoice2_eu_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    base = os.path.join(registry.BENCH_DIR, sub)
    for d, _, files in os.walk(base):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax_or_the_jax_package():
    bad = {(p, m) for p in _sources() for m in _imports(p) if m in FORBIDDEN}
    assert not bad


def test_the_reference_imports_nothing_of_the_port():
    bad = {(p, m) for p in _sources("reference") for m in _imports(p)
           if m.startswith("cosyvoice2_eu")}
    assert not bad


def test_loaded_modules_are_compared_by_whole_top_level_name():
    assert core.forbidden_modules(["cosyvoice2_eu_torch", "cosyvoice2_eu_torch.models.llm",
                                   "jaxtyping", "flaxen", "numpy"]) == []
    assert core.forbidden_modules(["jax.numpy", "cosyvoice2_eu_tpu.ops"]) == [
        "cosyvoice2_eu_tpu", "jax"]
    assert core.forbidden_modules(["flax.linen", "jaxlib"]) == ["flax", "jaxlib"]
