"""The benchmark's frozen arithmetic: bytes, shapes, operation counts and peaks.

Kept here, under the benchmark's own folder, so that the yardstick a
per-layer metric divides by cannot move with the program it measures.

* The elementwise ADMM block reads each input once and writes each output
  once: D in its dtype, L in the compute dtype, E, Y_L and Y_O in the storage
  dtype (read), O, E, Y_L and Y_O in the storage dtype (written), and T' when
  it is built. Float32 throughout: 40 bytes an element.
* TT-TRPCA's SVTs work on the sequential tensor-train unfoldings of the
  tensor: (n1, n2 n3), (n1 n2, n3), ...
* An SVD of an m x k matrix (k <= m, thin form) takes Golub-Kahan
  bidiagonalisation's 4 m k^2 - 4 k^3 / 3 flops; that count is the SVT's
  floor whatever algorithm a later kernel uses.
* Peaks of one NVIDIA H100 SXM (data sheet, at its 700 W limit): 3.35 TB/s of
  HBM3, 67 TFLOP/s float32 outside the tensor cores (TF32 is off).
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2, "float8_e4m3fn": 1, "float8_e5m2": 1}


def block_bytes_per_element(data: str, compute: str, storage: str, t: str | None) -> int:
    """Bytes the elementwise block moves per element: D and L read, E, Y_L,
    Y_O read and O, E, Y_L, Y_O written in the storage dtype, T' written
    when built (`t` None: a masked solve, which builds none)."""
    return (DTYPE_BYTES[data] + DTYPE_BYTES[compute] + 7 * DTYPE_BYTES[storage]
            + (DTYPE_BYTES[t] if t is not None else 0))


def block_bound_s(shape, bytes_per_element: int) -> float:
    """Least time one block launch can take on the card: its bytes over the
    memory rate."""
    return bytes_per_element * math.prod(shape) / HBM_BYTES_PER_S


def tt_unfoldings(shape) -> list[tuple[int, int]]:
    """(rows, columns) of each sequential tensor-train unfolding."""
    total = math.prod(shape)
    rows = [math.prod(shape[: m + 1]) for m in range(len(shape) - 1)]
    return [(r, total // r) for r in rows]


def golub_kahan_flops(rows: int, cols: int) -> float:
    """4 m k^2 - 4 k^3 / 3 for the thin side k and the tall side m."""
    m, k = max(rows, cols), min(rows, cols)
    return 4.0 * m * k * k - 4.0 * k**3 / 3.0


def svd_bound_s(rows: int, cols: int) -> float:
    """Least time an SVD of a rows x cols float32 matrix can take on the card."""
    return golub_kahan_flops(rows, cols) / FP32_FLOPS_PER_S
