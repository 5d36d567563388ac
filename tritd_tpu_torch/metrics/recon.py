"""Reconstruction metrics: RMSE / NRMSE (RRE) over masked entries.

PyTorch counterpart of `tritd_tpu/metrics/recon.py`
(reference: `traffic_triple_comparison.m:194-202`): rmse is the l2 distance
over the selected entries (un-normalized, despite the name), nrmse divides
it by the l2 norm of the selected ground truth — the "RRE" of the tables.
"""

from __future__ import annotations

import torch

from ..ops.kruskal import on_input_device


@on_input_device("x_hat", "gt", "mask")
def evaluate(x_hat: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor | None = None):
    """(rmse, nrmse) as 0-d tensors over entries where mask is True (all if None)."""
    diff = x_hat - gt
    if mask is not None:
        diff = torch.where(mask, diff, torch.zeros_like(diff))
        gt = torch.where(mask, gt, torch.zeros_like(gt))
    rmse = torch.linalg.vector_norm(diff)
    return rmse, rmse / torch.linalg.vector_norm(gt)


@on_input_device("x_hat", "gt", "mask")
def rre(x_hat: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor | None = None):
    """Relative reconstruction error — the headline metric."""
    return evaluate(x_hat, gt, mask)[1]


@on_input_device("new", "old")
def relative_change(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """||new - old|| / ||old||, the baselines' convergence probe
    (`TT_TRPCA.m:73`, `RTRC.m:69-70`, `RC_FCTN.m:103`)."""
    return torch.linalg.vector_norm(new - old) / torch.linalg.vector_norm(old)
