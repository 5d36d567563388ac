"""Matrix products of the plain references, in full precision or as TF32.

TF32 keeps float32's 8-bit exponent and 10 of its 23 significand bits; a
tensor core on TF32 rounds each operand to it and accumulates in float32.
`round_tf32` rounds float32 values to nearest, ties to even, so the
emulation gives the same numbers on the CPU as on the card, whatever the
process's TF32 setting (the benchmark keeps it off).
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32's significand, kept in float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def matmul(x: torch.Tensor, y: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """x @ y; with `tf32`, of both operands rounded to TF32 (float32 in, float32 out)."""
    if tf32:
        x, y = round_tf32(x.float()), round_tf32(y.float())
    return x @ y
