"""PSNR / SSIM / MSAM image-quality metrics for the video benchmark.

PyTorch counterpart of `tritd_tpu/metrics/image.py`. Reference:
`quality_ybz.m:1-34` averages psnr_index/ssim_index over frames.
psnr_index (`psnr_index.m:1-5`) is 10*log10(255^2 / mse), the range fixed
to [0, 255]. ssim_index is Wang et al. 2004: an 11x11 Gaussian window with
sigma 1.5, K = (0.01, 0.03), L = 255 and 'valid' filtering.

Everything runs in float32 on the device of the input, the frames of a
tensor as one batch. The 11x11 window is the outer product of a normalized
1-D Gaussian with itself, so the 'valid' filter is written as two banded
matrix products per frame, W_h @ frame @ W_w^T: float32 GEMMs (TF32 is off
for matmul by default), where a cuDNN convolution would run in TF32 unless
told otherwise. It equals the reference's 2-D filter up to rounding.
"""

from __future__ import annotations

import math

import torch


def psnr(x: torch.Tensor, y: torch.Tensor, peak: float = 255.0) -> torch.Tensor:
    """10*log10(peak^2 / mse) per `psnr_index.m:4` (mse over all entries)."""
    mse = torch.mean((x.to(torch.float32) - y.to(torch.float32)) ** 2)
    return 10.0 * torch.log10(peak**2 / mse)


def _gaussian_1d(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    """Normalized 1-D Gaussian, float32; fspecial('gaussian', size, sigma)
    is its outer product with itself."""
    half = (size - 1) / 2.0
    coords = torch.arange(size, dtype=torch.float32, device=device) - half
    g1 = torch.exp(-(coords**2) / (2.0 * sigma**2))
    return g1 / torch.sum(g1)


def _band(n: int, g: torch.Tensor) -> torch.Tensor:
    """(n - len(g) + 1, n) matrix whose row i holds g at columns i..i+len(g)-1:
    a 'valid' correlation with g along one axis."""
    k = g.shape[0]
    m = n - k + 1
    band = torch.zeros(m, n, dtype=g.dtype, device=g.device)
    rows = torch.arange(m, device=g.device)[:, None]
    band[rows, rows + torch.arange(k, device=g.device)[None, :]] = g
    return band


def _filter2_valid(frames: torch.Tensor, w_h: torch.Tensor, w_w: torch.Tensor) -> torch.Tensor:
    """filter2(window, frame, 'valid') for each frame of a (T, H, W) batch."""
    return w_h @ frames @ w_w.T


def ssim_frames(
    frames1: torch.Tensor,
    frames2: torch.Tensor,
    k1: float = 0.01,
    k2: float = 0.03,
    peak: float = 255.0,
    win_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Mean SSIM of each frame of two (T, H, W) batches, shape (T,)."""
    img1 = frames1.to(torch.float32)
    img2 = frames2.to(torch.float32)
    g = _gaussian_1d(win_size, sigma, device=img1.device)
    w_h, w_w = _band(img1.shape[1], g), _band(img1.shape[2], g)
    c1 = (k1 * peak) ** 2
    c2 = (k2 * peak) ** 2
    mu1 = _filter2_valid(img1, w_h, w_w)
    mu2 = _filter2_valid(img2, w_h, w_w)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2_valid(img1 * img1, w_h, w_w) - mu1_sq
    sigma2_sq = _filter2_valid(img2 * img2, w_h, w_w) - mu2_sq
    sigma12 = _filter2_valid(img1 * img2, w_h, w_w) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(ssim_map, dim=(1, 2))


def ssim_frame(img1: torch.Tensor, img2: torch.Tensor, **kwargs) -> torch.Tensor:
    """Mean SSIM of one 2-D frame, Wang et al. defaults (`ssim_index.m`)."""
    return ssim_frames(img1[None], img2[None], **kwargs)[0]


def quality(x: torch.Tensor, x_hat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean PSNR, mean SSIM) over mode-3 frames, `quality_ybz.m:22-33`.
    Takes (H, W, T) tensors."""
    frames1 = torch.movedim(x, -1, 0)
    frames2 = torch.movedim(x_hat, -1, 0)
    mse = torch.mean((frames1.to(torch.float32) - frames2.to(torch.float32)) ** 2, dim=(1, 2))
    psnrs = 10.0 * torch.log10(255.0**2 / mse)
    return torch.mean(psnrs), torch.mean(ssim_frames(frames1, frames2))


def msam(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """Mean Spectral Angle Mapper in degrees, `MSIQA.m:49-71`: per spatial
    pixel, the angle between the two mode-3 fibers, averaged over pixels.
    The arccos input is clamped to [-1, 1]; zero fibers give NaN, which the
    mean propagates, as in the reference."""
    a = x.to(torch.float32)
    b = x_hat.to(torch.float32)
    dot = torch.sum(a * b, dim=-1)
    na = torch.sum(a * a, dim=-1)
    nb = torch.sum(b * b, dim=-1)
    cosv = dot / torch.sqrt(na * nb)
    ang = torch.acos(torch.clamp(cosv, -1.0, 1.0)) * (180.0 / math.pi)
    return torch.mean(ang)


def msiqa(x: torch.Tensor, x_hat: torch.Tensor):
    """(psnr, ssim, msam), the `MSIQA.m:1-47` output on equal-shaped
    [0, 255]-range tensors."""
    p, s = quality(x, x_hat)
    return p, s, msam(x, x_hat)
