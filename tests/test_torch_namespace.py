"""PyTorch port: the namespaces and the packaging.

`tritd_tpu_torch` and `tritd_tpu_torch.ops` export what `tritd_tpu` and
`tritd_tpu.ops` export, name for name, the nine Tensor Toolbox classes
included: nothing is left to port; importing the port pulls in no JAX; the
package data ships every source the runtime builds from."""

import importlib
import pathlib
import subprocess
import sys
import tomllib
import types

import pytest

torch = pytest.importorskip("torch")

import tritd_tpu  # noqa: E402
import tritd_tpu.ops  # noqa: E402
import tritd_tpu_torch  # noqa: E402
import tritd_tpu_torch.ops  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent

#: the names of the reference's namespaces allowed to be missing: none
NOT_PORTED_YET: set = set()


def test_ops_namespace_has_every_ported_name():
    ref, port = tritd_tpu.ops, tritd_tpu_torch.ops
    missing = set(ref.__all__) - set(port.__all__)
    assert missing == NOT_PORTED_YET == set()  # every name is ported, the nine classes too
    for name in ("Tensor", "SpTensor", "KTensor", "TTensor", "SymTensor", "SymKTensor", "SumTensor",
                 "TenMat", "SpTenMat"):
        assert getattr(port, name).__module__ == "tritd_tpu_torch.ops.classes", name
    assert set(port.__all__) <= set(ref.__all__)
    assert len(port.__all__) == len(set(port.__all__))
    for name in port.__all__:
        got, want = getattr(port, name), getattr(ref, name)
        if callable(want):
            assert callable(got), name
        else:
            assert type(got) is type(want), name
    assert port.hosvd is port.tucker_hosvd and port.tucker_als is port.tucker_hooi
    assert port.VARIANTS == ref.VARIANTS and port.SOLVE_METHODS == ref.SOLVE_METHODS
    assert sorted(port.GCP_LOSSES) == sorted(ref.GCP_LOSSES)


def test_the_68_toolbox_names_resolve():
    """The functional Tensor Toolbox names of the reference's flat namespace
    (everything it takes from kruskal, decomp, cp_variants, sparse, symmetric
    and tenutils, with the two aliases)."""
    port = tritd_tpu_torch.ops
    names = [
        n for n in tritd_tpu.ops.__all__
        if n in ("hosvd", "tucker_als")
        or getattr(getattr(tritd_tpu.ops, n), "__module__", "").rsplit(".", 1)[-1]
        in ("kruskal", "decomp", "cp_variants", "sparse", "symmetric", "tenutils")
        or n == "GCP_LOSSES"
    ]
    assert len(names) == 68
    for name in names:
        obj = getattr(port, name)
        assert obj is not None
        if name != "GCP_LOSSES":
            assert callable(obj) and obj.__module__.startswith("tritd_tpu_torch.ops."), name


def test_fold_and_svt_serve_as_function_and_as_module():
    from tritd_tpu_torch.ops import fold, svt, unfold

    assert isinstance(fold, types.ModuleType) and isinstance(svt, types.ModuleType)
    x = torch.arange(24.0).reshape(2, 3, 4)
    for mode in (1, 2, 3):
        assert torch.equal(fold(unfold(x, mode), mode, (2, 3, 4)), x)
        assert torch.equal(fold.fold(fold.unfold(x, mode), mode, (2, 3, 4)), x)
    m = torch.diag(torch.tensor([3.0, 1.0, 0.2]))
    assert torch.allclose(svt(m, 0.5), torch.diag(torch.tensor([2.5, 0.5, 0.0])), atol=1e-6)
    assert torch.equal(svt(m, 0.5), svt.svt(m, 0.5))
    assert callable(svt.auto_method) and callable(svt.svt_ref_compat)
    assert importlib.import_module("tritd_tpu_torch.ops.svt") is svt


def test_package_namespace_matches_the_reference():
    assert set(tritd_tpu.__all__) <= set(tritd_tpu_torch.__all__)
    for name in tritd_tpu.__all__:
        assert getattr(tritd_tpu_torch, name) is not None, name
    assert tritd_tpu_torch.ops is tritd_tpu_torch.ops and isinstance(tritd_tpu_torch.solvers, types.ModuleType)
    from tritd_tpu_torch import OutlierConfig, tritd_admm_outlier, tritd_als, tritd_mals  # noqa: F401
    from tritd_tpu_torch.ops import elementwise_block, rhs_mode, svt, unfold  # noqa: F401


def test_importing_the_port_needs_no_jax_and_builds_nothing():
    """In a fresh interpreter where `jax`, `optax` and `triton` cannot be
    imported, the port's namespaces import, no kernel is built, and nothing
    of the JAX package is loaded."""
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "optax", "triton", "tritd_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import tritd_tpu_torch, tritd_tpu_torch.ops, tritd_tpu_torch.oracle, tritd_tpu_torch.interop
import tritd_tpu_torch.tools.toolbox_audit, tritd_tpu_torch.tools.emulator_parity, tritd_tpu_torch.examples.demo_toolbox
from tritd_tpu_torch.runtime import build
assert not any(m.split(".")[0] in ("jax", "optax", "triton", "tritd_tpu") for m in sys.modules)
assert len(tritd_tpu_torch.ops.__all__) >= 100
print("built:", sorted(p.name for p in build.BUILD_DIR.glob("*.so")) if build.BUILD_DIR.exists() else [])
"""
    before = set((REPO / "tritd_tpu_torch" / "_build").glob("*"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert set((REPO / "tritd_tpu_torch" / "_build").glob("*")) == before


def test_no_module_of_the_port_names_jax_in_an_import():
    import re

    # ml_dtypes too: the machine with the card does not have it
    pat = re.compile(r"^\s*(import|from)\s+(jax|optax|ml_dtypes|tritd_tpu|tools|examples)(\.|\s|$)", re.M)
    files = list((REPO / "tritd_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 50
    names = {p.relative_to(REPO).as_posix() for p in files}
    for part in ("tritd_tpu_torch/examples/demo_toolbox.py", "tritd_tpu_torch/tools/toolbox_audit.py",
                 "tritd_tpu_torch/tools/emulator_parity.py", "tritd_tpu_torch/ops/classes.py",
                 "tritd_tpu_torch/ops/narrow.py", "tritd_tpu_torch/tools/scaling_model.py"):
        assert part in names, part
    for path in files:
        assert not pat.search(path.read_text()), path


def test_package_data_ships_every_source_the_runtime_builds():
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    patterns = cfg["tool"]["setuptools"]["package-data"]["tritd_tpu_torch"]
    pkg = REPO / "tritd_tpu_torch"
    shipped = {p.relative_to(pkg).as_posix() for pat in patterns for p in pkg.glob(pat)}
    assert "csrc/proximal.cpp" in shipped
    assert "csrc/elementwise_block.cu" in shipped
    # every file of csrc/ is one the package data names
    assert shipped == {p.relative_to(pkg).as_posix() for p in (pkg / "csrc").iterdir() if p.is_file()}
    scripts = cfg["project"]["scripts"]
    for name in ("tritd-torch-completion", "tritd-torch-video"):
        module, func = scripts[name].split(":")
        assert callable(getattr(importlib.import_module(module), func))
    # the reference's own scripts are still there
    assert scripts["tritd-completion"] == "tritd_tpu.cli.run_completion:main"
