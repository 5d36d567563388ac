"""Casts into the narrow dtypes with the reference's rounding.

The port's counterpart of `jnp.ndarray.astype` into a narrow dtype; no module
of the JAX package holds it, since there XLA does the conversion. Torch's
`Tensor.to` parts from JAX in two ways, and `narrow_cast` repairs both:

* From float64, torch converts through float32 and rounds twice; JAX rounds
  once. Here a float64 tensor is first rounded to float32 by round-to-odd
  (truncate toward zero, then set the last bit if the value was inexact),
  then to nearest even into the target. Round-to-odd into a format with at
  least two more significand bits than the target makes the second rounding
  the one a direct conversion gives (float32 keeps 24 bits; float16 has 11,
  float8_e4m3fn 4, float8_e5m2 3). Example: 1 + 2**-11 + 2**-40 goes to
  float16 as 1.0009765625, not 1.0.
* float8_e4m3fn has no infinity. JAX gives NaN when the rounded value would
  pass the largest finite one, 448: for |x| > 464 (464 ties to 448) and for
  +-inf. Torch saturates to +-448.

bfloat16 is left to `Tensor.to`: both packages round a float64 into it
through float32, so the double rounding is the reference's too. float8_e5m2
overflows to +-inf from 61440 on in both, as float16 does from 65520.

The cast is plain PyTorch and runs on any device: it is what the elementwise
kernel's plain version stores, and what the solvers narrow D, T and a
loaded checkpoint with.
"""

from __future__ import annotations

import torch

FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)
# the dtypes that torch's own conversion rounds otherwise than JAX
ROUNDED_ONCE = (torch.float16, *FLOAT8)
# |x| above this goes to NaN in float8_e4m3fn; 464 itself ties to 448
E4M3_NAN_ABOVE = 464.0


def round_to_odd_f32(x: torch.Tensor) -> torch.Tensor:
    """A float64 tensor rounded to float32 toward zero, with the last bit
    set where that lost anything. NaN and +-inf pass through; a finite value
    beyond float32's range becomes +-FLT_MAX."""
    y = x.to(torch.float32)
    back = y.to(torch.float64)
    bits = y.view(torch.int32)
    # where round-to-nearest went away from zero, step one ulp back
    bits = bits - (back.abs() > x.abs()).to(torch.int32)
    bits = bits | (back != x).to(torch.int32)
    return bits.view(torch.float32)


def narrow_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`x` in `dtype`, rounded as JAX's `astype` rounds. Other dtypes than
    float16 and the two float8 formats are `x.to(dtype)`."""
    if x.dtype == dtype or dtype not in ROUNDED_ONCE:
        return x.to(dtype)
    if x.dtype == torch.float64:
        x = round_to_odd_f32(x)
    elif x.dtype != torch.float32:
        x = x.to(torch.float32)  # exact from every narrower float type
    if dtype == torch.float8_e4m3fn:
        x = torch.where((x.abs() > E4M3_NAN_ABOVE) | x.isinf(), torch.nan, x)
    return x.to(dtype)

