"""CDnet-style foreground/background segmentation metrics.

Counterpart of `tritd_tpu/metrics/foreground.py`, copied as host numpy:
importing it from `tritd_tpu` would load JAX through that package's
`__init__`. Reference: the `eval` and `mAP` local functions of the video driver
(`video_triple_comparison.m:316-371, 374-406`):

  * binary foreground prediction: |O| frame thresholded at 50 (a graythresh
    Otsu level is computed but unused — `:335-339`);
  * CDnet ground-truth labels: 255 = foreground, 170 = non-ROI (ignore);
  * per-frame confusion counts with the ignore-region convention
    TP = pred & (gt | ns), FP = pred & ~gt, FN = ~pred & gt,
    TN = ~pred & (~gt | ns)  (`:342-360`);
  * Precision / Recall / F1 / PWC = 100*(FP+FN)/numel  (`:362-370`);
  * mAP: per frame, sigmoid probability 1/(1+exp(-alpha*(|O| - T))) with
    alpha = 0.5 and T = graythresh(|O|)*255 (MATLAB Otsu on a double image,
    i.e. values clipped to [0,1] then quantized to uint8 — replicated
    exactly), AP = trapezoidal area under the precision-recall curve,
    frames with a single-class ground truth skipped as NaN (`:374-406`).

Host-side numpy: these run once per experiment on results, not in the hot
loop. Callers pass numpy arrays (`tensor.cpu().numpy()`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# numpy 2 renamed trapz to trapezoid; take whichever this numpy has
_trapezoid = getattr(np, "trapezoid", None) or np.trapz

FOREGROUND_LABEL = 255
NON_ROI_LABEL = 170
DEFAULT_THRESHOLD = 50.0


@dataclasses.dataclass
class ForegroundScores:
    tp: int
    fp: int
    fn: int
    tn: int
    precision: float
    recall: float
    f1: float
    pwc: float


def predict_masks(foreground: np.ndarray, threshold: float = DEFAULT_THRESHOLD):
    """|O| > threshold per frame (`video_triple_comparison.m:339`)."""
    return np.abs(np.asarray(foreground)) > threshold


def foreground_scores(
    foreground: np.ndarray,
    groundtruth: np.ndarray,
    threshold: float = DEFAULT_THRESHOLD,
) -> ForegroundScores:
    """Precision/Recall/F1/PWC with the CDnet ignore convention.

    Args are (H, W, T) tensors: |O| sparse component and label frames."""
    pred = predict_masks(foreground, threshold)
    gt = np.asarray(groundtruth) == FOREGROUND_LABEL
    ns = np.asarray(groundtruth) == NON_ROI_LABEL
    tp = int(np.sum(pred & (gt | ns)))
    fp = int(np.sum(pred & ~gt))
    fn = int(np.sum(~pred & gt))
    tn = int(np.sum(~pred & (~gt | ns)))
    precision = tp / (tp + fp) if tp + fp else float("nan")
    recall = tp / (tp + fn) if tp + fn else float("nan")
    f1 = (
        2 * precision * recall / (precision + recall)
        if precision + recall
        else float("nan")
    )
    pwc = 100.0 * (fp + fn) / gt.size
    return ForegroundScores(tp, fp, fn, tn, precision, recall, f1, pwc)


def graythresh_matlab_double(img: np.ndarray) -> float:
    """MATLAB graythresh on a DOUBLE image: values are clipped to [0, 1],
    quantized to uint8, then Otsu's method on the 256-bin histogram.
    Returns the normalized level in [0, 1]. The driver feeds raw |O| (often
    >> 1), so most mass saturates at bin 255 — that quirk is part of the
    published mAP numbers and is replicated deliberately."""
    u8 = np.round(np.clip(np.asarray(img, np.float64), 0.0, 1.0) * 255.0).astype(
        np.int64
    )
    hist = np.bincount(u8.ravel(), minlength=256).astype(np.float64)
    p = hist / hist.sum()
    omega = np.cumsum(p)
    mu = np.cumsum(p * np.arange(256))
    mu_t = mu[-1]
    denom = omega * (1.0 - omega)
    with np.errstate(divide="ignore", invalid="ignore"):
        sigma_b = (mu_t * omega - mu) ** 2 / denom
    sigma_b[~np.isfinite(sigma_b)] = 0.0
    # MATLAB tie-break: mean of all maximizing bins (graythresh semantics)
    maxval = sigma_b.max()
    if maxval <= 0:
        return 0.0
    idx = np.flatnonzero(sigma_b == maxval)
    return float(idx.mean()) / 255.0


def average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
    """Trapezoidal area under the PR curve — perfcurve(...,'reca','prec') +
    trapz semantics (`video_triple_comparison.m:394-400`)."""
    order = np.argsort(-scores, kind="stable")
    y = labels[order].astype(np.float64)
    tp = np.cumsum(y)
    fp = np.cumsum(1.0 - y)
    total_pos = y.sum()
    if total_pos == 0:
        return float("nan")
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / total_pos
    valid = np.isfinite(precision) & np.isfinite(recall)
    if valid.sum() <= 1:
        return 0.0
    return float(_trapezoid(precision[valid], recall[valid]))


def mean_average_precision(
    foreground: np.ndarray,
    groundtruth: np.ndarray,
    alpha: float = 0.5,
) -> float:
    """Sigmoid-probability mAP (`video_triple_comparison.m:374-406`)."""
    fg = np.abs(np.asarray(foreground, np.float64))
    gt = np.asarray(groundtruth)
    num_frames = fg.shape[2]
    aps = []
    for i in range(num_frames):
        diff = fg[:, :, i]
        gt_mask = (gt[:, :, i] == FOREGROUND_LABEL).astype(np.float64)
        if np.unique(gt_mask).size < 2:
            continue
        t = graythresh_matlab_double(diff) * 255.0
        prob = 1.0 / (1.0 + np.exp(-alpha * (diff - t)))
        aps.append(average_precision(gt_mask.ravel(), prob.ravel()))
    aps = np.asarray(aps, np.float64)
    aps = aps[~np.isnan(aps)]
    return float(np.mean(aps)) if aps.size else float("nan")
