"""Tensor-ops layer: folds, TriTD designs, Kronecker-free normal equations,
shrinkage/proximal operators, SVT, the fused elementwise block (the Hopper
kernel on a CUDA tensor), and the functional Tensor Toolbox surface
(Kruskal/Tucker/sparse/symmetric tensors, the CP and Tucker algorithms).

The flat namespace of `tritd_tpu/ops/__init__.py`, name for name, the nine
Tensor Toolbox classes included. Importing it builds nothing and needs no
GPU, `nvcc` or `triton`.

Two names, `fold` and `svt`, are a function of this namespace and a
submodule of this package at once. Here the attribute stays the submodule,
made callable: `ops.fold(mat, mode, shape)` and `ops.svt(m, tau)` call the
functions, `ops.fold.unfold` and `ops.svt.auto_method` still resolve, and
`from tritd_tpu_torch.ops import fold, svt` gives objects that serve both
uses.
"""

import types as _types

from . import fold, svt
from .fold import (
    unfold,
    core_a_mat,
    core_a_from_mat,
    core_b_mat,
    core_b_from_mat,
    core_c_mat,
    core_c_from_mat,
)
from .designs import (
    VARIANTS,
    build_f,
    build_g,
    build_h,
    triple_product,
    triple_product_naive,
    kron_f,
    kron_g,
    kron_h,
)
from .normal_eq import (
    gram_a,
    gram_b,
    gram_c,
    gram_mode,
    combine_grams,
    rhs_mode,
    gram_and_rhs,
    ridge_solve,
    SOLVE_METHODS,
)
from .shrinkage import (
    soft_threshold,
    weighted_soft_threshold,
    lp_reweight,
    prox_l1,
    huber_clip,
    biweight,
)
from .svt import auto_method, svt_ref_compat
from .prox import capped_simplex_projection, flsa
# the reference's signature and six outputs; the solver's seven-output
# wrapper stays `hopper_kernels.elementwise_block`
from .hopper_kernels import flat_elementwise_block as elementwise_block
from .kruskal import khatrirao, ktensor_full, tenmat, tenrand, cp_normalize, create_problem
from .decomp import cp_als, mttkrp, tucker_hosvd, tucker_hooi, tucker_ttm
# toolbox-name aliases: `hosvd.m` and `tucker_als.m` (higher-order
# orthogonal iteration) are tucker_hosvd / tucker_hooi here
hosvd = tucker_hosvd
tucker_als = tucker_hooi
from .cp_variants import cp_apr, cp_nmu, cp_arls, cp_opt, cp_wopt, gcp_opt, GCP_LOSSES
from .sparse import (
    sp_full,
    sp_sub2ind,
    sp_ind2sub,
    sptenrand,
    sptendiag,
    sp_norm,
    sp_innerprod,
    sp_ttv,
    sp_mttkrp,
    sptenmat,
    sp_elemwise,
    cp_als_sparse,
)
from .symmetric import (
    symmetrize,
    is_symmetric,
    symktensor_full,
    ttsv,
    eig_sshopm,
    eig_sshopmc,
    eig_geap,
    cp_sym,
    tucker_sym,
)
from .tenutils import (
    ttm,
    ttv,
    ttt,
    nvecs,
    collapse,
    contract,
    scale,
    tenzeros,
    tenones,
    tendiag,
    teneye,
    tenrandblk,
    matrandnorm,
    matrandorth,
    matrandcong,
    ktensor_norm,
    ktensor_innerprod,
    ktensor_arrange,
    ktensor_fixsigns,
    ktensor_score,
    ttensor_full,
    ttensor_norm,
    sumtensor_full,
    create_guess,
    create_problem_binary,
    export_data,
    import_data,
)
from .classes import (
    Tensor,
    SpTensor,
    KTensor,
    TTensor,
    SymTensor,
    SymKTensor,
    SumTensor,
    TenMat,
    SpTenMat,
)


def _make_callable(module, name):
    """Let `module(...)` call `module.<name>(...)`: the module object keeps
    its attributes and gains `__call__` through its class."""

    def call(self, *args, **kwargs):
        return getattr(self, name)(*args, **kwargs)

    module.__class__ = type(
        "_CallableModule", (_types.ModuleType,), {"__call__": call, "__doc__": module.__doc__}
    )
    return module


_make_callable(fold, "fold")
_make_callable(svt, "svt")

__all__ = [
    "unfold",
    "ttm",
    "ttv",
    "ttt",
    "nvecs",
    "collapse",
    "contract",
    "scale",
    "fold",
    "core_a_mat",
    "core_a_from_mat",
    "core_b_mat",
    "core_b_from_mat",
    "core_c_mat",
    "core_c_from_mat",
    "VARIANTS",
    "build_f",
    "build_g",
    "build_h",
    "triple_product",
    "triple_product_naive",
    "kron_f",
    "kron_g",
    "kron_h",
    "gram_a",
    "gram_b",
    "gram_c",
    "gram_mode",
    "combine_grams",
    "rhs_mode",
    "gram_and_rhs",
    "ridge_solve",
    "SOLVE_METHODS",
    "soft_threshold",
    "weighted_soft_threshold",
    "lp_reweight",
    "prox_l1",
    "huber_clip",
    "biweight",
    "auto_method",
    "svt",
    "svt_ref_compat",
    "capped_simplex_projection",
    "flsa",
    "elementwise_block",
    "khatrirao",
    "ktensor_full",
    "tenmat",
    "tenrand",
    "cp_normalize",
    "create_problem",
    "cp_als",
    "mttkrp",
    "tucker_hosvd",
    "tucker_hooi",
    "hosvd",
    "tucker_als",
    "tucker_ttm",
    "cp_apr",
    "cp_nmu",
    "cp_arls",
    "cp_opt",
    "cp_wopt",
    "gcp_opt",
    "GCP_LOSSES",
    "sp_full",
    "sp_sub2ind",
    "sp_ind2sub",
    "sptenrand",
    "sptendiag",
    "sp_norm",
    "sp_innerprod",
    "sp_ttv",
    "sp_mttkrp",
    "sptenmat",
    "sp_elemwise",
    "cp_als_sparse",
    "symmetrize",
    "is_symmetric",
    "symktensor_full",
    "ttsv",
    "eig_sshopm",
    "eig_sshopmc",
    "eig_geap",
    "cp_sym",
    "tucker_sym",
    "tenzeros",
    "tenones",
    "tendiag",
    "teneye",
    "tenrandblk",
    "matrandnorm",
    "matrandorth",
    "matrandcong",
    "ktensor_norm",
    "ktensor_innerprod",
    "ktensor_arrange",
    "ktensor_fixsigns",
    "ktensor_score",
    "ttensor_full",
    "ttensor_norm",
    "sumtensor_full",
    "create_guess",
    "create_problem_binary",
    "export_data",
    "import_data",
    "Tensor",
    "SpTensor",
    "KTensor",
    "TTensor",
    "SymTensor",
    "SymKTensor",
    "SumTensor",
    "TenMat",
    "SpTenMat",
]
