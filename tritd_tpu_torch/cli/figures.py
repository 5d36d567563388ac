"""Result visualization: the comparison figure grid and video export.

Counterpart of `tritd_tpu/cli/figures.py`, on numpy and the port's artifact
store (the same `<dataset>_<method>_*` stems, so it also reads the JAX
package's artifacts).

Reference counterparts:
  * `foreground_grid.m:8-60` — rows = CDnet sequences, columns = methods
    (Observed / GT / per-method reconstructions), one chosen frame per
    sequence rendered in grayscale with measured runtimes captioned.
  * `tensor2video` (`video_triple_comparison.m:300-313`) — mat2gray ->
    uint8 -> VideoWriter .avi; here -> animated GIF (PIL) with an .npz
    frame-stack fallback, no codec dependencies.

Artifacts are read from the .npz store (`tritd_tpu_torch.utils.artifacts`)
with the same `<dataset>_<method>_*` stems the reference uses.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import artifacts

DEFAULT_METHODS = ("Observed", "gt", "ttnn", "sofia", "ring", "fctn", "triple")
METHOD_TITLES = {
    "Observed": "Observed",
    "gt": "GroundTruth",
    "ttnn": "TTNN",
    "sofia": "Sofia",
    "ring": "TRLRF",
    "fctn": "RC-FCTN",
    "triple": "Triple",
}


def mat2gray(x: np.ndarray) -> np.ndarray:
    """MATLAB mat2gray: linear rescale to [0, 1]."""
    x = np.asarray(x, np.float64)
    lo, hi = x.min(), x.max()
    if hi <= lo:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


def tensor2video(x: np.ndarray, path: str, fps: int = 20) -> str:
    """Write an (H, W, T) tensor as an animated grayscale GIF (or .npz frame
    stack when PIL is unavailable)."""
    frames = (mat2gray(x) * 255).astype(np.uint8)
    try:
        from PIL import Image

        imgs = [Image.fromarray(frames[:, :, t]) for t in range(frames.shape[2])]
        if not path.endswith(".gif"):
            path = os.path.splitext(path)[0] + ".gif"
        imgs[0].save(
            path, save_all=True, append_images=imgs[1:],
            duration=int(1000 / fps), loop=0,
        )
        return path
    except ImportError:
        path = os.path.splitext(path)[0] + ".npz"
        np.savez_compressed(path, frames=frames)
        return path


def _load_cell(out_dir, dataset, method):
    if method == "Observed":
        with np.load(os.path.join(out_dir, f"{dataset}_raw.npz")) as f:
            return f["Y"]
    if method == "gt":
        path = os.path.join(out_dir, f"{dataset}_gt.npz")
        if not os.path.exists(path):
            return None
        with np.load(path) as f:
            return f[list(f.keys())[0]]
    try:
        return artifacts.load_artifact(out_dir, dataset, method, "Xhat")
    except FileNotFoundError:
        return None


def foreground_grid(
    out_dir: str,
    datasets=("highway", "sofa", "office", "PETS2006"),
    methods=DEFAULT_METHODS,
    frame_ids=(200, 50, 50, 50),
    runtimes: np.ndarray | None = None,
    save_path: str | None = None,
):
    """Assemble the rows-x-methods frame-comparison figure. Returns the
    matplotlib Figure (saved to save_path if given). Missing artifacts render
    as blank tiles (the reference would error; we degrade gracefully)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows, cols = len(datasets), len(methods)
    fig, axes = plt.subplots(rows, cols, figsize=(2.0 * cols, 1.6 * rows))
    axes = np.atleast_2d(axes)
    for r, dataset in enumerate(datasets):
        for c, method in enumerate(methods):
            ax = axes[r, c]
            ax.set_axis_off()
            x = _load_cell(out_dir, dataset, method)
            if x is not None:
                fid = min(frame_ids[r], x.shape[2] - 1)
                ax.imshow(x[:, :, fid], cmap="gray")
            if r == 0:
                ax.set_title(METHOD_TITLES.get(method, method), fontsize=10)
            if runtimes is not None and np.isfinite(runtimes[r][c]):
                ax.text(
                    0.5, -0.06, f"{runtimes[r][c]:.2f} s",
                    transform=ax.transAxes, ha="center", va="top",
                    fontsize=9, fontweight="bold",
                )
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig
