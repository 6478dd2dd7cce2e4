"""Nothing that the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the measured program: the imports of every
module, followed through the program's own modules, compared by their
top-level names whole (``marl_dmfb_tpu_torch`` is not ``marl_dmfb_tpu``)."""

import ast
from pathlib import Path

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = harness.HERE
PORT = "marl_dmfb_tpu_torch"


def imports(path: Path) -> set:
    """Dotted names a file imports, at any depth of its body."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


def source_of(name: str):
    """The repository file of module ``name``, if it is one."""
    base = ROOT.joinpath(*name.split("."))
    for p in (base.with_suffix(".py"), base / "__init__.py"):
        if p.is_file():
            return p
    return None


def closure(files) -> dict:
    """Every repository module reached from ``files`` -> its imports."""
    seen, todo = {}, list(files)
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen[f] = imports(f)
        for name in seen[f]:
            parts = name.split(".")
            for i in range(1, len(parts) + 1):
                p = source_of(".".join(parts[:i]))
                if p is not None and p not in seen:
                    todo.append(p)
    return seen


def runnable():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


@pytest.mark.parametrize("path", runnable(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_reached(path):
    for f, names in closure([path]).items():
        bad = {n.split(".")[0] for n in names} & set(harness.FORBIDDEN)
        assert not bad, f"{f} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    ref = list((BENCH / "reference").glob("*.py"))
    for f, names in closure(ref).items():
        # the package's own __init__ runs first, and imports nothing
        assert (f.is_relative_to(BENCH / "reference")
                or f == BENCH / "__init__.py"), f
        assert not any(n.split(".")[0] in (PORT, *harness.FORBIDDEN)
                       for n in names), (f, names)


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(["marl_dmfb_tpu_torch.trainer",
                                      "torch", "jaxtyping"]) == []
    assert harness.forbidden_modules(["marl_dmfb_tpu.envs", "jax.numpy",
                                      "flax"]) == ["flax", "jax",
                                                   "marl_dmfb_tpu"]
