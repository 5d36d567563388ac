"""Analytic roofline models for the benchmarked solvers.

PyTorch counterpart of `tritd_tpu/utils/roofline.py`. Per-iteration FLOP and
device-memory byte counts derived from the algorithm's structure, so a bench
row can report achieved TFLOP/s and GB/s against the card's peaks. The
counts are the algorithm's, whatever implements it, and equal the
reference's number for number (tested); the peaks are this card's. These are
MODELS, not measurements: the byte counts assume perfect fusion of pointwise
chains (one read per operand, one write per result), and the decomposition
FLOP counts use standard dense-LA operation counts.

Peaks (one NVIDIA H100 SXM; NVIDIA's data sheet, at the full 700 W limit):
  * device memory (HBM3) 3.35 TB/s;
  * 67 TFLOP/s float32 outside the tensor cores. The port keeps TF32 off, so
    this, and not a tensor-core rate, is the ceiling of its float32 GEMMs.

The ADMM solvers are bound by bytes: TriTD at r=5 has an arithmetic
intensity of about 4 FLOP/byte against a ridge point of 20, so
`pct_hbm_peak` is the speed-of-light number; `roofline_bound` names the
binding side per row. The models count each pass as going to device memory;
where a small working set stays in the 50 MB L2 cache the achieved rate can
pass 100% of the memory peak, which `annotate` reports as a number and not
as a bound.

SOFIA rows are NOT modeled: its cost is per inner ALS iteration, and the
nested fit-change early stops make the inner-iteration count a run-time
quantity of the data.
"""

from __future__ import annotations

import math

HBM_PEAK_GBPS = 3350.0
FP32_PEAK_TFLOPS = 67.0

#: eigh/SVD FLOP coefficients (standard dense-LA counts; the cubic term is
#: small at these thin sides, so the coefficient hardly moves the totals)
_EIGH_C = 10.0
_SVD_C = 20.0


def _cut_shapes(shape, kind: str):
    """Unfolding shapes per method family: TT sequential cuts (ttnn),
    circular L=ceil(N/2) cuts (ring), balanced bipartitions (fctn)."""
    n = len(shape)
    total = math.prod(shape)
    if kind == "tt":
        dims_l = []
        il = 1
        for m in range(n - 1):
            il *= shape[m]
            dims_l.append(il)
        return [(d, total // d) for d in dims_l]
    if kind == "ring":
        l = -(-n // 2)
        cuts = []
        for shift in range(l):
            order = [(shift + i) % n for i in range(n)]
            d = math.prod(shape[o] for o in order[:l])
            cuts.append((d, total // d))
        return cuts
    if kind == "fctn":
        import itertools

        half = n // 2
        cuts = []
        for combo in itertools.combinations(range(n), half):
            if combo[0] != 0:
                continue
            d = math.prod(shape[o] for o in combo)
            cuts.append((d, total // d))
        return cuts
    raise ValueError(kind)


def _svt_cut_cost(dl: int, dr: int, svt_method: str):
    """(flops, extra_thin3_flops) for one spectral shrinkage of a dl x dr
    matrix. GEMM terms: thin-side Gram (2*wide*thin^2), basis projection and
    reconstruction (2*wide*thin^2 each). Decomposition term: C*thin^3."""
    thin, wide = min(dl, dr), max(dl, dr)
    gemm = 6.0 * wide * thin**2
    if svt_method.startswith("warm"):
        # exact Gram eigh every K-th iteration, basis-reuse GEMMs between
        k = int(svt_method.split(":")[1]) if ":" in svt_method else 8
        decomp = _EIGH_C * thin**3 / k
        gram_amort = 2.0 * wide * thin**2 / k
        gemm = 4.0 * wide * thin**2 + gram_amort
    elif svt_method == "svd":
        decomp = _SVD_C * thin**3
    elif svt_method.startswith(("auto", "lowrank")):
        b = int(svt_method.split(":")[1]) if ":" in svt_method else 1024
        b = min(b, thin)
        # randomized range finder: 2 power-iteration GEMM pairs + small eigh
        gemm = 10.0 * wide * thin * b
        decomp = _EIGH_C * b**3
    else:  # "gram"
        decomp = _EIGH_C * thin**3
    return gemm, decomp


def tritd_model(shape, rank: int, elem_bytes: int = 4) -> dict:
    """TriTD-ADMM per-iteration model (solvers/admm.py structure).

    FLOPs: three Hadamard-route normal equations — each one O(n r^2) RHS
    einsum (2 n r^2) plus O(n_i r^4) Grams and an r^2-sized Cholesky — one
    triple_product reconstruction (2 n r^2), and ~12 n pointwise ops in the
    fused elementwise block (README complexity row: O(3 n^3 r^2 + 3 n^2 r^4
    + 3 r^6) with n^3 = total entries).

    HBM bytes: the carried-T build + elementwise block move 5 reads/5 writes
    of the tensor per iteration; the three RHS contractions re-read T, and
    triple_product writes L (solvers/admm.py). Factor-sized traffic
    (n_i r^2) is negligible and omitted.
    """
    n = math.prod(shape)
    r2 = rank * rank
    flops = 4 * 2.0 * n * r2                      # 3 RHS einsums + recon
    flops += 2.0 * sum(shape) * r2 * r2           # Gram builds
    flops += 3 * (2.0 / 3.0) * r2**3              # Cholesky solves
    flops += 12.0 * n                             # fused elementwise block
    reads = 5 + 3                                  # block reads + 3 T re-reads
    writes = 5                                     # o, e, y_l, y_o, t  (+L)
    writes += 1
    bytes_ = (reads + writes) * n * elem_bytes
    return {
        "flops_per_iter": flops,
        "hbm_bytes_per_iter": bytes_,
        # live data-sized tensors across the loop: d, o, e, y_l, y_o, t, l
        "working_set_bytes": 7 * n * elem_bytes,
    }


def svt_admm_model(shape, kind: str, svt_method: str,
                   elem_bytes: int = 4) -> dict:
    """TTNN / RING / RC-FCTN per-iteration model.

    FLOPs: one spectral shrinkage per cut (see _svt_cut_cost) plus ~10 n
    pointwise ops for the joint solve / sparse prox / dual ascent.

    HBM bytes: per cut, read the shifted tensor and its dual, write the
    auxiliary (3 n); the fused joint-solve/dual block reads the cut outputs
    and data-sized state (~6 n) and writes the updated state (~5 n). GEMM
    operand traffic is counted at one read per operand per GEMM pass.
    """
    cuts = _cut_shapes(shape, kind)
    n = math.prod(shape)
    flops = 10.0 * n
    gemm_bytes = 0.0
    for dl, dr in cuts:
        gemm, decomp = _svt_cut_cost(dl, dr, svt_method)
        flops += gemm + decomp
        # each GEMM pass streams the wide matrix from HBM at least once;
        # 3 passes on the exact routes (gram/project/reconstruct)
        passes = 3 if not svt_method.startswith(("auto", "lowrank")) else 5
        gemm_bytes += passes * dl * dr * elem_bytes
    bytes_ = (3 * len(cuts) + 11) * n * elem_bytes + gemm_bytes
    return {
        "flops_per_iter": flops,
        "hbm_bytes_per_iter": bytes_,
        # live state: x/z/s + duals + per-cut auxiliaries and duals
        "working_set_bytes": (2 * len(cuts) + 6) * n * elem_bytes,
    }


def annotate(row: dict, model: dict | None, seconds_per_iter: float | None,
             timing_source: str) -> dict:
    """Attach achieved-vs-peak columns to a bench row (mutates + returns).

    `seconds_per_iter` should be device time where there is one;
    `timing_source` records which clock it came from ("cuda_events",
    "profiler", "walltime/n_iters")."""
    if model is None or not seconds_per_iter:
        row["roofline"] = None
        return row
    tflops = model["flops_per_iter"] / seconds_per_iter / 1e12
    gbps = model["hbm_bytes_per_iter"] / seconds_per_iter / 1e9
    pct_flop = 100.0 * tflops / FP32_PEAK_TFLOPS
    pct_hbm = 100.0 * gbps / HBM_PEAK_GBPS
    intensity = model["flops_per_iter"] / model["hbm_bytes_per_iter"]
    ridge = FP32_PEAK_TFLOPS * 1e12 / (HBM_PEAK_GBPS * 1e9)
    # the bound is the model's, from its intensity alone: the memory side
    # below the ridge point, the float32 rate above it
    if intensity < ridge:
        bound, pct_bound = "hbm", pct_hbm
    else:
        bound, pct_bound = "fp32", pct_flop
    row["roofline"] = {
        "model_flops_per_iter": round(model["flops_per_iter"]),
        "model_hbm_bytes_per_iter": round(model["hbm_bytes_per_iter"]),
        "working_set_mb": round(model.get("working_set_bytes", float("inf")) / 1e6, 1),
        "achieved_tflops": round(tflops, 3),
        "achieved_gbps": round(gbps, 1),
        "pct_flop_peak": round(pct_flop, 2),
        "pct_hbm_peak": round(pct_hbm, 1),
        "arithmetic_intensity": round(intensity, 2),
        "roofline_bound": bound,
        "pct_of_bound": round(pct_bound, 1),
        "timing_source": timing_source,
    }
    return row


def model_for(method: str, shape, svt_method: str | None,
              rank: int = 5, elem_bytes: int = 4,
              fctn_subdim: int | None = None) -> dict | None:
    """Bench-row dispatcher. Returns None for unmodeled methods (sofia)."""
    if method == "triple":
        return tritd_model(shape, rank, elem_bytes)
    if method == "ttnn":
        return svt_admm_model(shape, "tt", svt_method or "gram", elem_bytes)
    if method == "ring":
        return svt_admm_model(shape, "ring", svt_method or "gram", elem_bytes)
    if method == "fctn":
        i, j, k = shape
        sub = fctn_subdim or 8
        shape4 = (i, j, k // sub, sub)
        return svt_admm_model(shape4, "fctn", svt_method or "gram", elem_bytes)
    return None
