"""The port's entry points that follow the device rule of
`ops.kruskal.on_input_device` (the metrics, the functional `ops` surface,
`baselines.prox_tnn`, the flat `ops.elementwise_block`, `interop`'s six
`*_from_numpy` and `baselines.sofia_stream`), each on a small numpy
problem, for the tests of where an entry point puts its input
(tests/test_torch_numpy_input.py on the CPU, `chip_smoke.py` phase 20 on the
card). Not a test; imports no JAX.

`ENTRIES[name](wrap, **kw)` calls the entry point on the problem's arrays,
each passed through `wrap` (the identity for numpy, `torch.from_numpy` for
CPU tensors, a copy to the card), and returns its outputs. `kw` is
`device=...` or nothing. Every iterative call is cut to a few iterations
and draws from a fresh seeded CPU generator, so two calls draw alike.

`NO_DATA_TENSOR` names the public functions of those modules that take no
data tensor, and so no `device` rule of an input: constructors that take a
`device` of their own, helpers of plain numbers, and host-side I/O and
checks."""

import itertools

import numpy as np
import torch

from tritd_tpu_torch import interop, metrics, ops
from tritd_tpu_torch.baselines import prox_tnn, sofia_stream
from tritd_tpu_torch.metrics import image
from tritd_tpu_torch.ops import cp_variants, decomp, kruskal, shrinkage, sparse, symmetric, tenutils
from tritd_tpu_torch.ops import fold as fold_mod
from tritd_tpu_torch.ops import svt as svt_mod
from tritd_tpu_torch.ops.hopper_kernels import flat_elementwise_block

_rng = np.random.default_rng(11)
X = _rng.standard_normal((4, 5, 6))
X2 = X + 0.1 * _rng.standard_normal((4, 5, 6))
MASK = _rng.random((4, 5, 6)) > 0.3
MAT = _rng.standard_normal((6, 5))
BASIS = np.linalg.qr(_rng.standard_normal((5, 5)))[0]
U = _rng.standard_normal((3, 5))
FAC = [_rng.standard_normal((n, 2)) for n in (4, 5, 6)]
FAC2 = [u + 0.05 * _rng.standard_normal(u.shape) for u in FAC]
W = np.abs(_rng.standard_normal(2)) + 0.5
CORE = _rng.standard_normal((2, 3, 2))
TFAC = [_rng.standard_normal((n, r)) for n, r in ((4, 2), (5, 3), (6, 2))]
CUBE = _rng.standard_normal((4, 5, 4))
A3, B3, C3 = _rng.standard_normal((4, 2, 2)), _rng.standard_normal((2, 5, 2)), _rng.standard_normal((2, 2, 6))
V4, V5, V6 = (_rng.standard_normal(n) for n in (4, 5, 6))
IDX = np.array([0, 7, 19, 33, 64, 101, 119])
COORDS = np.stack(np.unravel_index(IDX, X.shape), axis=1).astype(np.int64)
VALS = _rng.standard_normal(len(IDX))
SAMPLES = [_rng.integers(0, n, 8) for n in (5, 6)]
FRAMES, FRAMES2 = (np.clip(128 + 40 * _rng.standard_normal((3, 16, 18)), 0, 255) for _ in range(2))
BLOCK = [_rng.standard_normal((3, 4, 5)).astype(np.float32) for _ in range(5)]
STREAM = np.abs(_rng.standard_normal((4, 5, 8))) + 1.0
STREAM_MASK = _rng.random((4, 5, 8)) > 0.1


def _symmetric(order: int, n: int, seed: int) -> np.ndarray:
    """A symmetric tensor: a random one averaged over its index orders."""
    a = np.random.default_rng(seed).standard_normal((n,) * order)
    orders = list(itertools.permutations(range(order)))
    return sum(a.transpose(p) for p in orders) / len(orders)


SYM3 = _symmetric(3, 4, 12)
SYM4 = _symmetric(4, 3, 13)
EYE4 = tenutils.teneye(4, 3, dtype=torch.float64, device="cpu").numpy()
X0_4, X0_3 = V4 / np.linalg.norm(V4), np.ones(3) / np.sqrt(3.0)
STATE = {"a": A3, "b": B3, "c": C3, **{f: X for f in ("o", "e", "y_l", "y_o", "t")},
         "mu_l": np.float32(1e-3), "mu_o": np.float32(1e-3), "k": 3,
         "err_hist": np.full(5, np.nan), "rre_hist": np.full(5, np.nan), "done": False}


def _gen():
    return torch.Generator().manual_seed(0)


def _ws(wrap, arrays):
    return [wrap(a) for a in arrays]


ENTRIES = {
    # metrics
    "metrics.evaluate": lambda w, **kw: metrics.evaluate(w(X2), w(X), w(MASK), **kw),
    "metrics.rre": lambda w, **kw: metrics.rre(w(X2), w(X), **kw),
    "metrics.relative_change": lambda w, **kw: metrics.relative_change(w(X2), w(X), **kw),
    "metrics.psnr": lambda w, **kw: metrics.psnr(w(FRAMES), w(FRAMES2), **kw),
    "metrics.ssim_frames": lambda w, **kw: image.ssim_frames(w(FRAMES), w(FRAMES2), **kw),
    "metrics.ssim_frame": lambda w, **kw: metrics.ssim_frame(w(FRAMES[0]), w(FRAMES2[0]), **kw),
    "metrics.quality": lambda w, **kw: metrics.quality(w(FRAMES.transpose(1, 2, 0)),
                                                       w(FRAMES2.transpose(1, 2, 0)), **kw),
    "metrics.msam": lambda w, **kw: metrics.msam(w(FRAMES.transpose(1, 2, 0)), w(FRAMES2.transpose(1, 2, 0)),
                                                 **kw),
    "metrics.msiqa": lambda w, **kw: metrics.msiqa(w(FRAMES.transpose(1, 2, 0)), w(FRAMES2.transpose(1, 2, 0)),
                                                   **kw),
    # baselines
    "baselines.prox_tnn": lambda w, **kw: prox_tnn(w(X), 0.5, **kw),
    "baselines.sofia_stream": lambda w, **kw: sofia_stream(w(STREAM), w(STREAM_MASK), r=2, m=2, cycles=2,
                                                           max_epoch=2, generator=_gen(), **kw),
    # ops: folds
    "ops.unfold": lambda w, **kw: fold_mod.unfold(w(X), 2, **kw),
    "ops.fold": lambda w, **kw: fold_mod.fold(w(MAT.reshape(5, 6)), 2, (1, 5, 6), **kw),
    "ops.core_a_mat": lambda w, **kw: fold_mod.core_a_mat(w(A3), **kw),
    "ops.core_a_from_mat": lambda w, **kw: fold_mod.core_a_from_mat(w(A3.reshape(4, 4)), 2, **kw),
    "ops.core_b_mat": lambda w, **kw: fold_mod.core_b_mat(w(B3), **kw),
    "ops.core_b_from_mat": lambda w, **kw: fold_mod.core_b_from_mat(w(B3.reshape(5, 4)), 2, **kw),
    "ops.core_c_mat": lambda w, **kw: fold_mod.core_c_mat(w(C3), **kw),
    "ops.core_c_from_mat": lambda w, **kw: fold_mod.core_c_from_mat(w(C3.reshape(6, 4)), 2, **kw),
    # ops: shrinkage, SVT, prox
    "ops.soft_threshold": lambda w, **kw: shrinkage.soft_threshold(w(X), 0.5, **kw),
    "ops.weighted_soft_threshold": lambda w, **kw: shrinkage.weighted_soft_threshold(w(X), 0.5, w(np.abs(X2)),
                                                                                      **kw),
    "ops.lp_reweight": lambda w, **kw: shrinkage.lp_reweight(w(X), 0.1, 0.5, 1.0, **kw),
    "ops.prox_l1": lambda w, **kw: shrinkage.prox_l1(w(X), 0.5, **kw),
    "ops.huber_clip": lambda w, **kw: shrinkage.huber_clip(w(X), **kw),
    "ops.biweight": lambda w, **kw: shrinkage.biweight(w(X), **kw),
    "ops.svt": lambda w, **kw: svt_mod.svt(w(MAT), 0.5, **kw),
    "ops.svt_ref_compat": lambda w, **kw: svt_mod.svt_ref_compat(w(MAT), 0.5, **kw),
    "ops.svt_warm": lambda w, **kw: svt_mod.svt_warm(w(MAT), 0.5, w(BASIS), False, **kw),
    "ops.svt_ref_compat_warm": lambda w, **kw: svt_mod.svt_ref_compat_warm(w(MAT), 0.5, w(BASIS), False, **kw),
    "ops.capped_simplex_projection": lambda w, **kw: ops.capped_simplex_projection(w(V6), 2.0, **kw),
    "ops.flsa": lambda w, **kw: ops.flsa(w(V6), 0.1, 0.2, iters=20, **kw),
    # ops: Kruskal and decompositions
    "ops.khatrirao": lambda w, **kw: kruskal.khatrirao(w(FAC[0]), w(FAC[1]), **kw),
    "ops.ktensor_full": lambda w, **kw: kruskal.ktensor_full(_ws(w, FAC), w(W), **kw),
    "ops.tenmat": lambda w, **kw: kruskal.tenmat(w(X), (1,), **kw),
    "ops.cp_normalize": lambda w, **kw: kruskal.cp_normalize(_ws(w, FAC), w(W), **kw),
    "ops.mttkrp": lambda w, **kw: decomp.mttkrp(w(X), _ws(w, FAC), 1, **kw),
    "ops.cp_als": lambda w, **kw: decomp.cp_als(w(X), 2, max_iters=3, generator=_gen(), **kw),
    "ops.tucker_hosvd": lambda w, **kw: decomp.tucker_hosvd(w(X), (2, 3, 2), **kw),
    "ops.tucker_ttm": lambda w, **kw: decomp.tucker_ttm(w(CORE), _ws(w, TFAC), **kw),
    "ops.tucker_hooi": lambda w, **kw: decomp.tucker_hooi(w(X), (2, 3, 2), max_iters=3, **kw),
    # ops: tensor utilities
    "ops.ttm": lambda w, **kw: tenutils.ttm(w(X), w(U), 1, **kw),
    "ops.ttv": lambda w, **kw: tenutils.ttv(w(X), _ws(w, (V4, V5)), **kw),
    "ops.ttt": lambda w, **kw: tenutils.ttt(w(X), w(X2), [0, 1], [0, 1], **kw),
    "ops.nvecs": lambda w, **kw: tenutils.nvecs(w(X), 1, 2, **kw),
    "ops.collapse": lambda w, **kw: tenutils.collapse(w(X), [0, 2], **kw),
    "ops.contract": lambda w, **kw: tenutils.contract(w(CUBE), 0, 2, **kw),
    "ops.scale": lambda w, **kw: tenutils.scale(w(X), w(V5), 1, **kw),
    "ops.tendiag": lambda w, **kw: tenutils.tendiag(w(V4), **kw),
    "ops.matrandnorm": lambda w, **kw: tenutils.matrandnorm(w(MAT), **kw),
    "ops.ktensor_norm": lambda w, **kw: tenutils.ktensor_norm(w(W), _ws(w, FAC), **kw),
    "ops.ktensor_innerprod": lambda w, **kw: tenutils.ktensor_innerprod(w(W), _ws(w, FAC),
                                                                        (w(W), _ws(w, FAC2)), **kw),
    "ops.ktensor_innerprod_dense": lambda w, **kw: tenutils.ktensor_innerprod(w(W), _ws(w, FAC), w(X), **kw),
    "ops.ktensor_arrange": lambda w, **kw: tenutils.ktensor_arrange(w(W), _ws(w, FAC), **kw),
    "ops.ktensor_fixsigns": lambda w, **kw: tenutils.ktensor_fixsigns(w(W), _ws(w, FAC), **kw),
    "ops.ktensor_score": lambda w, **kw: tenutils.ktensor_score(w(W), _ws(w, FAC), w(W + 0.1), _ws(w, FAC2),
                                                                **kw),
    "ops.ttensor_full": lambda w, **kw: tenutils.ttensor_full(w(CORE), _ws(w, TFAC), **kw),
    "ops.ttensor_norm": lambda w, **kw: tenutils.ttensor_norm(w(CORE), _ws(w, TFAC), **kw),
    "ops.sumtensor_full": lambda w, **kw: tenutils.sumtensor_full(_ws(w, (X, X2)), **kw),
    # ops: sparse
    "ops.sp_full": lambda w, **kw: sparse.sp_full(w(VALS), w(COORDS), X.shape, **kw),
    "ops.sp_sub2ind": lambda w, **kw: sparse.sp_sub2ind(w(COORDS), X.shape, **kw),
    "ops.sp_ind2sub": lambda w, **kw: sparse.sp_ind2sub(w(IDX), X.shape, **kw),
    "ops.sptendiag": lambda w, **kw: sparse.sptendiag(w(V4), **kw),
    "ops.sp_norm": lambda w, **kw: sparse.sp_norm(w(VALS), w(COORDS), X.shape, **kw),
    "ops.sp_innerprod": lambda w, **kw: sparse.sp_innerprod(w(VALS), w(COORDS), X.shape, w(X), **kw),
    "ops.sp_ttv": lambda w, **kw: sparse.sp_ttv(w(VALS), w(COORDS), X.shape, [w(V5)], [1], **kw),
    "ops.sp_mttkrp": lambda w, **kw: sparse.sp_mttkrp(w(VALS), w(COORDS), X.shape, _ws(w, FAC), 1, **kw),
    "ops.sptenmat": lambda w, **kw: sparse.sptenmat(w(VALS), w(COORDS), X.shape, (1,), **kw),
    "ops.sp_elemwise": lambda w, **kw: sparse.sp_elemwise(w(VALS), w(COORDS), X.shape, lambda v: v * v, **kw),
    "ops.cp_als_sparse": lambda w, **kw: sparse.cp_als_sparse(w(VALS), w(COORDS), X.shape, 2, max_iters=3,
                                                              generator=_gen(), **kw),
    # ops: symmetric
    "ops.symmetrize": lambda w, **kw: symmetric.symmetrize(w(CUBE[:, :4, :]), **kw),
    "ops.is_symmetric": lambda w, **kw: symmetric.is_symmetric(w(SYM3), **kw),
    "ops.symktensor_full": lambda w, **kw: symmetric.symktensor_full(w(W), w(FAC[0]), 3, **kw),
    "ops.ttsv": lambda w, **kw: symmetric.ttsv(w(SYM3), w(X0_4), **kw),
    "ops.eig_sshopm": lambda w, **kw: symmetric.eig_sshopm(w(SYM3), max_iters=20, x0=w(X0_4), **kw),
    "ops.eig_sshopmc": lambda w, **kw: symmetric.eig_sshopmc(w(SYM3), shift=6.0, max_iters=20, x0=w(X0_4), **kw),
    "ops.eig_geap": lambda w, **kw: symmetric.eig_geap(w(SYM4), w(EYE4), shift=3.0, max_iters=20, x0=w(X0_3),
                                                       **kw),
    "ops.cp_sym": lambda w, **kw: symmetric.cp_sym(w(SYM3), 2, max_iters=5, generator=_gen(), **kw),
    "ops.tucker_sym": lambda w, **kw: symmetric.tucker_sym(w(SYM3), 2, max_iters=3, **kw),
    # ops: CP variants
    "ops.cp_nmu": lambda w, **kw: cp_variants.cp_nmu(w(np.abs(X)), 2, max_iters=3, generator=_gen(), **kw),
    "ops.cp_apr": lambda w, **kw: cp_variants.cp_apr(w(np.round(np.abs(X) * 3)), 2, max_outer=2, max_inner=2,
                                                     generator=_gen(), **kw),
    "ops.arls_mode_solve": lambda w, **kw: cp_variants.arls_mode_solve(w(X), _ws(w, FAC), 0, _ws(w, SAMPLES),
                                                                       **kw),
    "ops.cp_arls": lambda w, **kw: cp_variants.cp_arls(w(X), 2, n_samples=30, max_iters=3, generator=_gen(),
                                                       **kw),
    "ops.cp_objective": lambda w, **kw: cp_variants.cp_objective(_ws(w, FAC), w(X), 2.0, **kw),
    "ops.cp_opt": lambda w, **kw: cp_variants.cp_opt(w(X), 2, max_iters=3, generator=_gen(), **kw),
    "ops.cp_wopt": lambda w, **kw: cp_variants.cp_wopt(w(X * MASK), w(MASK.astype(np.float64)), 2, max_iters=3,
                                                       generator=_gen(), **kw),
    "ops.gcp_opt": lambda w, **kw: cp_variants.gcp_opt(w(X), 2, max_iters=3, generator=_gen(), **kw),
    # the flat elementwise block
    "ops.elementwise_block": lambda w, **kw: flat_elementwise_block(*_ws(w, BLOCK), 0.5, 0.7, 1.8, **kw),
    # interop
    "interop.factors_from_numpy": lambda w, **kw: interop.factors_from_numpy(w(A3), w(B3), w(C3), **kw),
    "interop.tensor_from_numpy": lambda w, **kw: interop.tensor_from_numpy(w(X), **kw),
    "interop.state_from_numpy": lambda w, **kw: interop.state_from_numpy(
        {k: w(v) if isinstance(v, np.ndarray) else v for k, v in STATE.items()}, **kw),
    "interop.ktensor_from_numpy": lambda w, **kw: interop.ktensor_from_numpy(w(W), _ws(w, FAC), **kw),
    "interop.ttensor_from_numpy": lambda w, **kw: interop.ttensor_from_numpy(w(CORE), _ws(w, TFAC), **kw),
    "interop.sptensor_from_numpy": lambda w, **kw: interop.sptensor_from_numpy(w(VALS), w(COORDS), X.shape, **kw),
}

# Public functions of the repaired modules that take no data tensor.
NO_DATA_TENSOR = {
    "ops.svt.auto_method": "plans from two sizes",
    "ops.svt.captures": "plans from a route name and sizes",
    "ops.svt.lowrank_sketch": "a constructor: takes dtype and device",
    "ops.svt.warm_spec": "parses a route name",
    "ops.svt.run_warm_blocks": "drives a caller's loop body",
    "ops.kruskal.default_device": "the rule itself",
    "ops.kruskal.input_device": "the rule itself",
    "ops.kruskal.solver_input": "the rule itself",
    "ops.kruskal.on_input_device": "the rule itself",
    "ops.kruskal.default_generator": "takes a generator",
    "ops.kruskal.draw": "a constructor: takes dtype and device",
    "ops.kruskal.tenrand": "a constructor: takes dtype and device",
    "ops.kruskal.create_problem": "a constructor: takes dtype and device",
    "ops.tenutils.tenzeros": "a constructor: takes dtype and device",
    "ops.tenutils.tenones": "a constructor: takes dtype and device",
    "ops.tenutils.teneye": "a constructor: takes dtype and device",
    "ops.tenutils.tenrandblk": "a constructor: takes dtype and device",
    "ops.tenutils.matrandorth": "a constructor: takes dtype and device",
    "ops.tenutils.matrandcong": "a constructor: takes dtype and device",
    "ops.tenutils.create_guess": "a constructor: takes dtype and device",
    "ops.tenutils.create_problem_binary": "a constructor: takes a device",
    "ops.tenutils.export_data": "host I/O: writes numpy or a tensor to a file",
    "ops.tenutils.import_data": "host I/O: reads a file into numpy, as the reference",
    "ops.sparse.check_coords": "a host-side check, run before any device",
    "ops.sparse.sptenrand": "a constructor: takes dtype and device",
    "ops.symmetric.adam_descent": "drives a caller's objective over its own parameters",
    "ops.cp_variants.GCP_LOSSES": "a table of loss functions",
    "metrics.foreground.*": "host numpy by design, as the reference's (callers pass arrays)",
}
