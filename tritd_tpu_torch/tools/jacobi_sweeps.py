"""How many sweeps the Jacobi SVD (`ops/device_linalg.py`) needs on spectra
the taxi unfoldings do not have: the readings behind its cap,
`device_linalg.JACOBI_SWEEPS`.

Each case is a matrix made from a seed with numpy (float64, then cast),
one JSON line a case and dtype: its sweeps, whether it converged under the
cap, and its singular values' largest distance to `torch.linalg.svd` of the
same matrix in float64, over s_max. The cases (:func:`cases`):

* graded:     s_i = 10^(-8 i / k);
* clustered:  groups of 8 equal values, from 1 down to 1e-2;
* rank-def:   rank k / 4 (values from 1 to 0.1), the rest eps of the dtype;
  each of these three at the taxi tall forms 50000x100, 10000x500 and
  5000x1000 (TALL_FORMS);
* thin:       a standard normal 5000 x k for k in THIN_SIDES (the largest
  thin sides the kernel takes);
* narrow:     a standard normal 96000 x k for k in NARROW_SIDES (the video
  cut's tall side beside the thin sides where the rotation test's
  tolerance, sqrt(k) eps, is smallest);
* tt_trpca:   the two unfoldings tt_trpca's svd route hands its SVT at the
  taxi stand-in (10% missing) after 90 iterations of its loop (the host
  loop on the CPU, in float32 as the CLI runs it, then cast);
* exact:      exactly rank-deficient matrices (:func:`exact_matrix`: an
  integer outer product, a static clip's unfolding, rank 3 from duplicated
  columns, zero columns among random ones) at the taxi and video tall forms
  (TALL_FORMS, VIDEO_TALL_FORMS), the matrices that stopped at the cap before
  the rotation test's floor (`device_linalg.JACOBI_ROUNDING`).

`--shapes` sets the tall forms of the spectra and the exact families alike,
`--families` which exact families run, `--seed` the seed of the draws (one
generator for all cases in order: `--cases exact --families zero-cols
--shapes 96000x64 --seed 1` is `exact_matrix("zero-cols", 96000, 64,
np.random.default_rng(1))`).

`--device cpu` runs the plain version (`jacobi_svd_torch`, stopped at the
cap as the kernel is); `--device cuda` the kernel
(`jacobi_svd_with_sweeps`, which reads nothing back: its count is read
here), on the same matrices, at most `--cap` sweeps (the module's cap by
default; a higher one reads what a case needs). A case that stops at the
cap is reported as such, not raised. `--rounding` sets the rotation test's
floor (and the negligible bound, twice it) and `--tol-scale` scales its
tolerance (`device_linalg.jacobi_tol`, sqrt(k) eps), to read what each
costs. `--qr` runs the sweeps on R of the tall form's QR in the dtype.

    python -m tritd_tpu_torch.tools.jacobi_sweeps --device cpu [--threads 4] [--dtypes f32,f64]
        [--cases graded,clustered,rank-def,thin,narrow,tt_trpca,exact] [--shapes 50000x100,10000x500,5000x1000]
        [--families outer,static,rank3,zero-cols] [--seed N] [--cap N] [--rounding EPS] [--tol-scale X] [--qr]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

TALL_FORMS = ((50000, 100), (10000, 500), (5000, 1000))
#: The video cut's tall forms (240 x 320 x 300): tt_trpca's and ring's
#: unfoldings 76800 x 300 and 96000 x 240.
VIDEO_TALL_FORMS = ((76800, 300), (96000, 240))
THIN_SIDES = (1000, 1024)
THIN_M = 5000
NARROW_SIDES = (1, 2, 5, 8, 16)
NARROW_M = 96000
CASES = ("graded", "clustered", "rank-def", "thin", "narrow", "tt_trpca", "exact")
EXACT_FAMILIES = ("outer", "static", "rank3", "zero-cols")
#: The exact families at small sizes (the CPU tests and the card's):
#: label -> (family, m, k, transposed).
EXACT_SMALL = {"outer 40x30": ("outer", 40, 30, False), "outer 30x40": ("outer", 40, 30, True),
               "static 60x40": ("static", 60, 40, False), "static 3000x100": ("static", 3000, 100, False),
               "rank3 50x30": ("rank3", 50, 30, False), "zero-cols 40x24": ("zero-cols", 40, 24, False)}
TT_TRPCA_ITERS = 90


def _with_spectrum(m: int, k: int, s: np.ndarray, rng) -> np.ndarray:
    u = np.linalg.qr(rng.standard_normal((m, k)))[0]
    v = np.linalg.qr(rng.standard_normal((k, k)))[0]
    return (u * s) @ v.T


def spectrum(case: str, k: int, eps: float) -> np.ndarray:
    """The singular values of a synthetic case of thin side k."""
    i = np.arange(k)
    if case == "graded":
        return 10.0 ** (-8.0 * i / k)
    if case == "clustered":
        return np.repeat(np.geomspace(1.0, 1e-2, -(-k // 8)), 8)[:k]
    if case == "rank-def":
        r = max(1, k // 4)
        return np.where(i < r, np.linspace(1.0, 0.1, k)[np.minimum(i * k // r, k - 1)], eps)
    raise ValueError(case)


def exact_matrix(family: str, m: int, k: int, rng) -> np.ndarray:
    """An exactly rank-deficient m x k matrix (float64) of `family`:
    "outer" the outer product of 1..m and 1..k (rank one, integers);
    "static" one standard normal column repeated k times, a static clip's
    (pixels x frames) unfolding; "rank3" three standard normal columns,
    column j the (j mod 3)-th; "zero-cols" a standard normal matrix with
    every fifth column zero."""
    if family == "outer":
        return np.outer(np.arange(1.0, m + 1), np.arange(1.0, k + 1))
    if family == "static":
        return np.repeat(rng.standard_normal((m, 1)), k, axis=1)
    if family == "rank3":
        return np.ascontiguousarray(rng.standard_normal((m, 3))[:, np.arange(k) % 3])
    if family == "zero-cols":
        a = rng.standard_normal((m, k))
        a[:, ::5] = 0.0
        return a
    raise ValueError(f"unknown exact family {family!r}; use one of {EXACT_FAMILIES}")


def exact_small(label: str, seed: int = 0) -> np.ndarray:
    """The matrix of EXACT_SMALL[label], from `seed`."""
    family, m, k, transposed = EXACT_SMALL[label]
    a = exact_matrix(family, m, k, np.random.default_rng(seed))
    return np.ascontiguousarray(a.T) if transposed else a


def _tt_trpca_unfoldings(iters: int) -> dict:
    """The matrices tt_trpca's svd route hands its SVT after `iters`
    iterations at the taxi stand-in, on the CPU in float32."""
    import torch

    from ..baselines import ttnn
    from ..data import load_dataset, uniform_missing_mask
    from ..utils.config import README_MISSING_RATIO

    x_np, _spec, _prov = load_dataset("taxi")
    mask = uniform_missing_mask(np.random.default_rng(0), x_np.shape, README_MISSING_RATIO)
    y = torch.from_numpy(np.where(mask, x_np, 0.0).astype(np.float32))
    seen, real = {}, ttnn.svt_ref_compat

    def recorded(mat, tau, **kwargs):
        seen[tuple(mat.shape)] = mat.clone()
        return real(mat, tau, **kwargs)

    ttnn.svt_ref_compat = recorded
    try:
        ttnn.tt_trpca(y, max_iter=iters + 1, svt_method="svd", device="cpu")
    finally:
        ttnn.svt_ref_compat = real
    return {f"tt_trpca {p}x{q}": mat.double().numpy() for (p, q), mat in seen.items()}


def cases(names=CASES, shapes=None, seed: int = 0, families=EXACT_FAMILIES) -> dict:
    """{label: float64 matrix} of the cases `names`, the synthetic spectra
    (in float64: the tail of rank-def is float64's eps here and cast's
    rounding in float32) and the exact `families` at each tall form of
    `shapes`; by default the spectra at TALL_FORMS, the exact families at
    those and VIDEO_TALL_FORMS."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in names:
        if name in ("graded", "clustered", "rank-def"):
            for m, k in shapes or TALL_FORMS:
                out[f"{name} {m}x{k}"] = _with_spectrum(m, k, spectrum(name, k, np.finfo(np.float64).eps), rng)
        elif name == "thin":
            for k in THIN_SIDES:
                out[f"thin {THIN_M}x{k}"] = rng.standard_normal((THIN_M, k))
        elif name == "narrow":
            for k in NARROW_SIDES:
                out[f"narrow {NARROW_M}x{k}"] = rng.standard_normal((NARROW_M, k))
        elif name == "tt_trpca":
            out.update(_tt_trpca_unfoldings(TT_TRPCA_ITERS))
        elif name == "exact":
            for m, k in shapes or TALL_FORMS + VIDEO_TALL_FORMS:
                for family in families:
                    out[f"exact {family} {m}x{k}"] = exact_matrix(family, m, k, rng)
        else:
            raise ValueError(f"unknown case {name!r}; use some of {CASES}")
    return out


def kernels_a_call(call) -> dict:
    """How many times `call()` launched each of the Jacobi SVD's kernels
    (`device_linalg.JACOBI_KERNELS`): the library's own counts of the
    launches that returned no error (`tritd_jacobi_launches`), set to 0
    just before the call and read just after it."""
    import ctypes

    import torch

    from ..ops import device_linalg

    lib = device_linalg._jacobi_library()
    counts = (ctypes.c_int * len(device_linalg.JACOBI_KERNELS))()
    lib.tritd_jacobi_launches(counts)
    call()
    torch.cuda.synchronize()
    lib.tritd_jacobi_launches(counts)
    return dict(zip(device_linalg.JACOBI_KERNELS, counts))


def measure(matrices: dict, dtypes, device: str, qr: bool = False):
    """One record a matrix and dtype: sweeps, converged (under the cap),
    the kernel's or plain version's |ds| / s_max against torch.linalg.svd
    in float64, seconds. With `qr`, the sweeps run on R of
    torch.linalg.qr of the tall form in the dtype (the QR preconditioning
    of ROADMAP queue 5, item 6), and the record also holds R's own values
    (torch.linalg.svd of R in float64) against the reference,
    `qr_ds_over_smax`: what no sweeps on R can improve."""
    import torch

    from ..ops import device_linalg

    for label, a_np in matrices.items():
        a64 = torch.from_numpy(a_np)
        ref = torch.linalg.svd(a64.to(device), full_matrices=False)[1].cpu()
        for dtype in dtypes:
            a = a64.to(dtype).to(device).contiguous()
            extra = {}
            if qr:
                a = torch.linalg.qr(a if a.shape[0] >= a.shape[1] else a.mT)[1].contiguous()
                r_s = torch.linalg.svd(a.double(), full_matrices=False)[1].cpu()
                extra = {"qr_ds_over_smax": float((r_s - ref).abs().max() / ref[0])}
            if device != "cpu":
                device_linalg.jacobi_svd_with_sweeps(a)  # its plan's occupancy queries outside the time
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            if device == "cpu":
                _u, s, _vh, n = device_linalg._jacobi_torch(a)
            else:
                _u, s, _vh, n = device_linalg.jacobi_svd_with_sweeps(a)
                n = int(n)
            seconds = time.perf_counter() - t0
            ds = float((s.double().cpu() - ref).abs().max() / ref[0])
            yield {"case": label, "dtype": str(dtype).removeprefix("torch."), "device": device, "sweeps": n,
                   "converged": n < device_linalg.JACOBI_SWEEPS, "cap": device_linalg.JACOBI_SWEEPS,
                   "ds_over_smax": ds, "seconds": seconds, **extra}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    parser.add_argument("--dtypes", default="f32,f64")
    parser.add_argument("--cases", default=",".join(CASES))
    parser.add_argument("--shapes", help="tall forms of the spectra and the exact families, as 5000x1000,... "
                        "(default: the taxi tall forms, and for exact also the video ones)")
    parser.add_argument("--families", default=",".join(EXACT_FAMILIES), help="the exact families to run")
    parser.add_argument("--seed", type=int, default=0, help="the seed of the matrices' draws")
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--cap", type=int, help="sweeps before a call stops (default JACOBI_SWEEPS)")
    parser.add_argument("--rounding", type=float, help="the rotation test's floor in eps, the negligible bound "
                        "twice it; 0 turns both off (default JACOBI_ROUNDING)")
    parser.add_argument("--qr", action="store_true", help="run the sweeps on R of the tall form's QR in the "
                        "dtype, and read R's own values too")
    parser.add_argument("--tol-scale", type=float, default=1.0, help="the rotation test's tolerance "
                        "(jacobi_tol: sqrt(k) eps of the thin side k) times this")
    args = parser.parse_args(argv)

    import torch

    from ..ops import device_linalg

    if args.cap:
        device_linalg.JACOBI_SWEEPS = args.cap
    if args.rounding is not None:
        device_linalg.JACOBI_ROUNDING, device_linalg.JACOBI_NEGLIGIBLE = args.rounding, 2 * args.rounding
    if args.tol_scale != 1.0:
        tol = device_linalg.jacobi_tol
        device_linalg.jacobi_tol = lambda k, dtype: args.tol_scale * tol(k, dtype)

    torch.set_num_threads(args.threads)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device")
    dtypes = [{"f32": torch.float32, "f64": torch.float64}[d] for d in args.dtypes.split(",")]
    shapes = [tuple(map(int, s.split("x"))) for s in args.shapes.split(",")] if args.shapes else None
    matrices = cases(args.cases.split(","), shapes, args.seed, args.families.split(","))
    for record in measure(matrices, dtypes, args.device, args.qr):
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
