"""What the benchmark imports: nothing of JAX or the JAX package anywhere
under benchmark/, and nothing of the program in the plain references.
Top-level module names are compared whole: `tritd_tpu_torch` is the port,
`tritd_tpu` the JAX package."""

import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent))

from benchmark import run  # noqa: E402

JAX_NAMES = {"jax", "jaxlib", "flax", "tritd_tpu"}


def imported(path: Path, package: tuple | None = None) -> set[str]:
    """Every absolute import's module name in the file, and each relative
    import's resolved against the file's package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    if package is None:
        package = path.relative_to(BENCH.parent).with_suffix("").parts[:-1]
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[: len(package) - node.level + 1]
                names.add(".".join((*base, *([node.module] if node.module else []))))
            else:
                names.add(node.module.split(".")[0])
    return names


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = {name.split(".")[0] for name in imported(path)} & JAX_NAMES
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program_or_the_harness(path):
    names = imported(path)
    assert "tritd_tpu_torch" not in {n.split(".")[0] for n in names}, f"{path} imports the program"
    inside = {n for n in names if n.startswith("benchmark")}
    assert all(n.startswith("benchmark.reference") for n in inside), f"{path} imports {inside}"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in JAX_NAMES:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "tritd_tpu_torch.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tritd_tpu.ops", sys)
    assert "tritd_tpu" in run.forbidden_modules()


def test_the_scan_sees_each_kind_of_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom tritd_tpu.ops import x\nimport tritd_tpu_torch\n"
                     "from ..methods import compare\n")
    names = imported(probe, package=("benchmark", "reference"))
    assert {n.split(".")[0] for n in names} & JAX_NAMES == {"jax", "tritd_tpu"}
    assert "tritd_tpu_torch" in names and "benchmark.methods" in names
