"""The port's baseline entry points and the sharded solve over a bare process
group, each on a small numpy problem, for the tests of where an entry point
puts its input (tests/test_torch_baseline_device.py on the CPU,
tests/test_torch_cuda.py on the card). Not a test; imports no JAX.

`ENTRIES[name](wrap, **kw)` calls the entry point on the problem's arrays,
each passed through `wrap` (the identity for numpy, `torch.from_numpy` for
CPU tensors), and returns its outputs. `kw` is `device=...` or nothing.
`tritd_admm_sharded` runs over the default process group, which the caller
starts (one rank)."""

import numpy as np
import torch
import torch.distributed as dist

from tritd_tpu_torch.baselines import (
    rc_fctn,
    rc_fctn_driver_traffic,
    rc_fctn_driver_video,
    rnc_fctn,
    rtrc,
    sofia_als,
    sofia_init,
    sofia_stream_device,
    trpca_snn,
    trpca_tnn,
    tt_trpca,
)
from tritd_tpu_torch.baselines.rc_fctn import _split_mode3
from tritd_tpu_torch.baselines.rnc_fctn import interpolate_init
from tritd_tpu_torch.baselines.rtrc import precompute_freedom_ratio
from tritd_tpu_torch.data.loaders import DatasetSpec, synthetic_traffic
from tritd_tpu_torch.data.synthetic import uniform_missing_mask
from tritd_tpu_torch.parallel import tritd_admm_sharded
from tritd_tpu_torch.solvers import TriTDConfig

SUBDIM = 4
SHARDED_CFG = TriTDConfig(rank=2, max_iter=3, tol=0.0, dtype="float64")


def traffic(shape=(12, 10, 16), seed=7, missing=0.10):
    """Mixed-structure traffic stand-in with missing entries: (truth,
    observed mask, zero-filled data), float64 numpy."""
    spec = DatasetSpec("tiny", "traffic", "T", shape, fctn_subdim=SUBDIM, sofia_period=4)
    x = synthetic_traffic(spec, np.random.default_rng(seed)).astype(np.float64)
    mask = uniform_missing_mask(np.random.default_rng(seed + 1), shape, missing)
    return x, mask, np.where(mask, x, 0.0)


def four_way(seed=5):
    """A 7x6x5x4 FCTN-rank-2 tensor scaled to [0, 1], 20% missing, 5% spikes:
    (truth, observed mask, zero-filled data, the four initial factors)."""
    rng = np.random.default_rng(seed)
    nway = (7, 6, 5, 4)
    rank = np.triu(np.full((4, 4), 2), 1)
    dims = [tuple(int(v) for v in d) for d in np.diag(nway) + rank + rank.T]
    truth = np.einsum("aqrs,qbtu,rtcv,suvd->abcd", *[rng.random(d) for d in dims])
    truth = truth / np.abs(truth).max()
    omega = rng.random(nway) > 0.2
    spikes = np.where(rng.random(nway) < 0.05, 0.8, 0.0)
    return truth, omega, np.where(omega, truth + spikes, 0.0), [rng.random(d) for d in dims]


def seasonal(shape=(9, 8, 24), r=2, m=6, seed=0, missing=0.15):
    """Seasonal CP tensor with noise: (truth, observed mask, the factor
    init), float64 numpy."""
    rng = np.random.default_rng(seed)
    t = np.arange(shape[2])
    u3 = np.stack([np.sin(2 * np.pi * (t + 3 * k) / m) + 0.05 * t + 2.0 for k in range(r)], axis=1)
    x = np.einsum("ir,jr,tr->ijt", rng.random((shape[0], r)) + 0.2, rng.random((shape[1], r)) + 0.2, u3)
    x = x + 0.01 * rng.standard_normal(shape)
    return x, rng.random(shape) > missing, tuple(rng.random((n, r)) for n in shape)


X, MASK, Y = traffic()
F4_TRUTH, F4_OMEGA, F4, F4_INIT = four_way()
S_X, S_OMEGA, S_INIT = seasonal()
STREAM_X, STREAM_OMEGA, _ = seasonal(shape=(8, 9, 36), missing=0.05, seed=5)
# the video driver's 4-way split, for rc_fctn itself
Y4, X4, IND4 = (_split_mode3(torch.from_numpy(a.astype(np.float64)), 4, 4).numpy() for a in (Y, X, MASK))


ENTRIES = {
    "tt_trpca": lambda w, **kw: tt_trpca(w(Y), origin=w(X), max_iter=4, svt_method="gram", **kw),
    "trpca_tnn": lambda w, **kw: trpca_tnn(w(Y), origin=w(X), mu=1e-3, max_iter=4, **kw),
    "trpca_snn": lambda w, **kw: trpca_snn(w(Y), alpha=(1.0, 0.8, 1.2), mu=1e-3, max_iter=4, **kw),
    "rc_fctn": lambda w, **kw: rc_fctn(w(Y4), 1.8, w(IND4), origin=w(X4), f=0.7, max_iter=4, svt_method="gram",
                                       **kw),
    "rc_fctn_driver_traffic": lambda w, **kw: rc_fctn_driver_traffic(w(Y), w(MASK), SUBDIM, origin=w(X),
                                                                     max_iter=4, svt_method="gram", **kw),
    "rc_fctn_driver_video": lambda w, **kw: rc_fctn_driver_video(w(Y), w(MASK), SUBDIM, origin=w(X), max_iter=4,
                                                                 svt_method="gram", **kw),
    "rnc_fctn": lambda w, **kw: rnc_fctn(w(F4), 0.3, w(F4_OMEGA), origin=w(F4_TRUTH), max_iter=12,
                                         init=[w(g) for g in F4_INIT], pad_values=[0.25, 0.5, 0.75, 0.35], **kw),
    "interpolate_init": lambda w, **kw: interpolate_init(w(F4), w(F4_OMEGA), pad=2, **kw),
    "rtrc": lambda w, **kw: rtrc(w(Y), w(MASK), origin=w(X), max_iter=4, svt_method="gram", **kw),
    "precompute_freedom_ratio": lambda w, **kw: precompute_freedom_ratio(w(Y), w(MASK), **kw),
    "sofia_als": lambda w, **kw: sofia_als(w(S_X), w(S_OMEGA), 2, 6, 0.1, 0.001, [w(u) for u in S_INIT],
                                           max_iters=5, **kw),
    "sofia_init": lambda w, **kw: sofia_init(w(S_X), w(S_OMEGA), r=2, m=6, origin=w(S_X), max_epoch=2,
                                             u_init=[w(u) for u in S_INIT], dtype=torch.float64, **kw),
    "sofia_stream_device": lambda w, **kw: sofia_stream_device(
        w(STREAM_X), w(STREAM_OMEGA), r=2, m=6, cycles=2, max_epoch=3, mu=0.2,
        generator=torch.Generator().manual_seed(0), dtype=torch.float64, **kw),
    "tritd_admm_sharded": lambda w, **kw: tritd_admm_sharded(w(Y), SHARDED_CFG, dist.group.WORLD,
                                                             origin=w(X), **kw),
}

#: the entry points that raised on numpy input before they took `device`
RAISED_ON_NUMPY = ("tt_trpca", "trpca_tnn", "trpca_snn", "rc_fctn", "rc_fctn_driver_traffic", "rc_fctn_driver_video",
                   "rnc_fctn")


def flat(out) -> list:
    """The tensors and arrays of an entry point's outputs, in order."""
    if isinstance(out, (tuple, list)):
        return [leaf for item in out for leaf in flat(item)]
    return [out] if isinstance(out, (torch.Tensor, np.ndarray)) else []


def devices(out) -> set:
    """The device types of an entry point's output tensors."""
    return {leaf.device.type for leaf in flat(out) if isinstance(leaf, torch.Tensor)}
