"""PyTorch port: the video protocol's tt_trpca and rtrc on the CLIs'
default `svd` SVT route, whose SVD on the card is the hand-written Jacobi
SVD (`csrc/jacobi_svd.cu`), held on the CPU to the JAX package.

The port runs its device form without graphs (the card's loop, forced on
the CPU) and its host loop, with `device_linalg.svd` replaced by the
kernel's plain version, `jacobi_svd_torch` (the same blocks, tournament,
rotation test and floor); the JAX package runs `jnp.linalg.svd`. Two small
clips under the video presets (nothing missing, ring's mu 1e-3), made from
a numpy seed by the stand-in's generator (`data.synthetic.synthetic_video`):
a moving clip (a low-rank background and a moving block) and a static clip
(the background's first frame in every frame, no foreground), whose
unfoldings are exactly rank-deficient (the frames' unfolding rank one past
the first iteration): the matrices on which the Jacobi SVD's sweeps did
not converge before the floor. At float64, err_hist within rtol RTOL and L
(and the sparse part) within atol RTOL of its norm: the tolerances of
`tests/test_torch_baseline_loops.py` (both sides float64, other SVDs in
other summation orders, carried by an ADMM).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tritd_tpu_torch.data.synthetic import synthetic_video  # noqa: E402
from tritd_tpu_torch.ops import device_linalg, toolbox_loop  # noqa: E402
from tritd_tpu_torch.utils.config import RING_PRESET  # noqa: E402

jttnn, ttnn = (importlib.import_module(f"{p}.baselines.ttnn") for p in ("tritd_tpu", "tritd_tpu_torch"))
jrtrc, rtrc = (importlib.import_module(f"{p}.baselines.rtrc") for p in ("tritd_tpu", "tritd_tpu_torch"))
tsvt = importlib.import_module("tritd_tpu_torch.ops.svt")

RTOL = 1e-7
SHAPE = (12, 10, 16)
ITERS = 8
CLIPS = ("moving", "static")
METHODS = ("tt_trpca", "rtrc")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(kind: str) -> np.ndarray:
    observed, background, _fg = synthetic_video(np.random.default_rng(11), SHAPE, dtype=np.float64)
    if kind == "static":
        return np.ascontiguousarray(np.repeat(background[:, :, :1], SHAPE[2], axis=2))
    return observed


def _torch_call(method: str, clip: np.ndarray, route) -> dict:
    x = torch.from_numpy(clip)
    mask = torch.ones(SHAPE, dtype=torch.bool)
    with toolbox_loop.forced_route(route):
        if method == "tt_trpca":
            z, s, hist, _n = ttnn.tt_trpca(x, origin=x, max_iter=ITERS, svt_method="svd")
            return {"l": z, "s": s, "hist": hist}
        xh, y, hist, _n = rtrc.rtrc(x, mask, mu=RING_PRESET.mu_video, origin=x, max_iter=ITERS, svt_method="svd")
        return {"l": xh, "s": y, "hist": hist}


def _jax_call(method: str, clip: np.ndarray) -> dict:
    with jax.enable_x64(True):
        x = jnp.asarray(clip)
        if method == "tt_trpca":
            z, s, hist, _n = jttnn.tt_trpca(x, origin=x, max_iter=ITERS, svt_method="svd")
            return {"l": np.asarray(z), "s": np.asarray(s), "hist": np.asarray(hist)}
        xh, y, hist, _n = jrtrc.rtrc(x, jnp.ones(SHAPE, dtype=bool), mu=RING_PRESET.mu_video, origin=x,
                                     max_iter=ITERS, svt_method="svd")
        return {"l": np.asarray(xh), "s": np.asarray(y), "hist": np.asarray(hist)}


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("method", METHODS)
def test_video_svd_route_through_the_plain_jacobi_matches_jax(method, clip, monkeypatch):
    """The device form without graphs and the host loop, the SVD the plain
    Jacobi, against the JAX package's call on the same clip in float64;
    the Jacobi SVDs of the loop converge (none stops at the cap)."""
    data = _clip(clip)
    want = _jax_call(method, data)
    calls = []

    def counted(a):
        u, s, vh, sweeps = device_linalg._jacobi_torch(a)
        calls.append(sweeps)
        return u, s, vh

    monkeypatch.setattr(tsvt.device_linalg, "svd", counted)
    for route in (False, None):
        got = _torch_call(method, data, route)
        hist = got["hist"].numpy()
        assert hist.shape == (ITERS,) and np.isfinite(want["hist"]).all() and want["hist"][-1] < want["hist"][0]
        np.testing.assert_allclose(hist, want["hist"], rtol=RTOL)
        for key in ("l", "s"):
            w = want[key]
            np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=RTOL * max(np.linalg.norm(w), 1.0))
    assert len(calls) == 2 * 2 * ITERS and max(calls) < device_linalg.JACOBI_SWEEPS


def test_the_static_clip_unfolding_is_rank_one_past_the_first_iteration(monkeypatch):
    """What makes the static clip the hard case: tt_trpca's (H W, T)
    unfolding has one nonzero singular value from the second iteration
    on (the first SVTs a zero iterate), which the plain Jacobi returns
    with the others 0, in few sweeps."""
    seen = []

    def recorded(a):
        u, s, vh, sweeps = device_linalg._jacobi_torch(a)
        seen.append((tuple(a.shape), s, sweeps))
        return u, s, vh

    monkeypatch.setattr(tsvt.device_linalg, "svd", recorded)
    x = torch.from_numpy(_clip("static"))
    ttnn.tt_trpca(x, origin=x, max_iter=3, svt_method="svd", device="cpu")
    frames = [(s, sweeps) for shape, s, sweeps in seen if shape == (SHAPE[0] * SHAPE[1], SHAPE[2])]
    assert len(frames) == 3
    for s, sweeps in frames[1:]:
        assert float(s[0]) > 0 and torch.count_nonzero(s) == 1 and sweeps <= 5
