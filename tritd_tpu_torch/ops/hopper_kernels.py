"""The fused elementwise ADMM block: hand-written Hopper kernel + plain version.

PyTorch counterpart of `tritd_tpu/ops/pallas_kernels.py`. Per iteration the
solver ends with one pass over D, L, E, Y_L, Y_O:

    r1 = D - L + Y_L/muL            o  = (muL*r1 + muO*r2)/(muL+muO)
    r2 = E - Y_O/muO                e  = soft(o + Y_O/muO, lam/muO)
    res_l = D - L - o               Y_L += muL*res_l
    res_o = o - e                   Y_O += muO*res_o
    ||res_l||^2, ||res_o||^2

and, when `mu_l_next` is given, the next factor-solve target
T' = D - O' + Y_L'/muL_next (`tritd_tpu/solvers/admm.py:156-163`).

Routing is by device, with no fallback: CPU tensors take `_block_torch`,
CUDA tensors take `_block_cuda`, the kernel in `csrc/elementwise_block.cu`.
The scalars are host numbers; they are rounded to the tensors' dtype and
combined in it (lam/muO, muL+muO), as the reference does in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .shrinkage import soft_threshold

KERNEL_DTYPES = (torch.float32, torch.float64)

# Launches of each hand-written kernel, counted where the wrapper launches it.
LAUNCHES = {"elementwise_block": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _scalars(dtype: torch.dtype, *values):
    """Host scalars rounded to the tensor dtype, as numpy scalars."""
    np_t = np.dtype(str(dtype).removeprefix("torch.")).type
    return tuple(None if v is None else np_t(v) for v in values)


def _block_torch(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next=None):
    """Plain PyTorch version: a line-for-line port of `_block_jnp`
    (`tritd_tpu/ops/pallas_kernels.py:45-66`), plus T'."""
    mu_l, mu_o, lam, mu_l_next = _scalars(d.dtype, mu_l, mu_o, lam, mu_l_next)
    r1 = d - l + y_l / float(mu_l)
    r2 = e - y_o / float(mu_o)
    o = (float(mu_l) * r1 + float(mu_o) * r2) / float(mu_l + mu_o)
    e_new = soft_threshold(o + y_o / float(mu_o), float(lam / mu_o))
    res_l = d - l - o
    res_o = o - e_new
    y_l_new = y_l + float(mu_l) * res_l
    y_o_new = y_o + float(mu_o) * res_o
    nl = torch.sum(res_l * res_l)
    no = torch.sum(res_o * res_o)
    t_new = None if mu_l_next is None else d - o + y_l_new / float(mu_l_next)
    return o, e_new, y_l_new, y_o_new, nl, no, t_new


def _check_kernel_inputs(tensors) -> None:
    d = tensors[0]
    if d.dtype not in KERNEL_DTYPES:
        raise TypeError(f"elementwise_block kernel takes float32 or float64, got {d.dtype}")
    for x in tensors:
        if x.dtype != d.dtype:
            raise TypeError(f"mixed dtypes: {x.dtype} vs {d.dtype}")
        if x.shape != d.shape:
            raise ValueError(f"mixed shapes: {tuple(x.shape)} vs {tuple(d.shape)}")
        if not x.is_contiguous():
            raise ValueError("elementwise_block kernel needs contiguous tensors")
    for x in tensors:
        if x.device.type != "cuda" or x.device != d.device:
            raise ValueError(f"elementwise_block kernel needs tensors on one CUDA device, got {x.device}")


def _block_cuda(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next=None):
    """Launch `csrc/elementwise_block.cu` on the current stream. Returns the
    same tuple as `_block_torch`; the norms are 0-d device tensors, so
    nothing waits for the device."""
    from ..runtime import kernels

    tensors = (d, l, e, y_l, y_o)
    _check_kernel_inputs(tensors)
    lib = kernels.library()
    with_t = mu_l_next is not None
    mu_l, mu_o, lam, mu_l_next = _scalars(
        d.dtype, mu_l, mu_o, lam, mu_l_next if with_t else 1.0
    )
    outs = [torch.empty_like(d) for _ in range(5 if with_t else 4)]
    nl = torch.empty((), dtype=d.dtype, device=d.device)
    no = torch.empty((), dtype=d.dtype, device=d.device)
    partials = torch.empty(lib.tritd_partials_len(), dtype=torch.float64, device=d.device)
    fn = (lib.tritd_elementwise_block_f32 if d.dtype == torch.float32
          else lib.tritd_elementwise_block_f64)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = fn(
            *(x.data_ptr() for x in tensors),
            *(x.data_ptr() for x in outs[:4]),
            outs[4].data_ptr() if with_t else None,
            nl.data_ptr(), no.data_ptr(), partials.data_ptr(),
            d.numel(), float(mu_l), float(mu_o), float(lam), float(mu_l_next), stream,
        )
    kernels.check(err, "elementwise_block launch")
    LAUNCHES["elementwise_block"] += 1
    o, e_new, y_l_new, y_o_new = outs[:4]
    return o, e_new, y_l_new, y_o_new, nl, no, (outs[4] if with_t else None)


def elementwise_block(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next=None):
    """Fused O/E/dual/residual update. Returns
    (o, e_new, y_l_new, y_o_new, ||res_l||^2, ||res_o||^2, t_new), where
    t_new = D - O' + Y_L'/mu_l_next, or None when mu_l_next is None."""
    if d.device.type == "cpu":
        return _block_torch(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next)
    if d.device.type == "cuda":
        return _block_cuda(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next)
    raise ValueError(f"elementwise_block runs on CPU or CUDA tensors, got {d.device}")
