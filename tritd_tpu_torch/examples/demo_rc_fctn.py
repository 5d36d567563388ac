"""Demo: RC-FCTN robust tensor completion on a video tensor.

Counterpart of the JAX package's `examples/demo_rc_fctn.py`, after the
reference's `Demo_RC_FCTN.m`: load a grayscale video, normalize to [0, 1],
reshape to 4-way [I, J, 1, K] (`Demo_RC_FCTN.m:13`), draw a uniform
observation set at `sample_ratio` (committed value 1.0, `:22`), run RC_FCTN
with lambda = 5/sqrt(max(I,J)*n3*n4) and the demo's (gamma, deta, f) grid
point (1e-4, 1e-3, 0.7) (`:30-41`), and report RSE and the per-frame
PSNR/SSIM of the reconstruction.

Run: python -m tritd_tpu_torch.examples.demo_rc_fctn [--dataset highway]
     [--frames 60] [--max-iter 30] [--sample-ratio 1.0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from ._common import add_device_flags, device_of, uniform, video_frames


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="highway")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--max-iter", type=int, default=30)
    p.add_argument("--sample-ratio", type=float, default=1.0)
    p.add_argument("--out-dir", default="demo_out")
    add_device_flags(p, cpu_alias=True)
    args = p.parse_args(argv)
    device = device_of(args)

    from ..baselines import rc_fctn
    from ..metrics.image import quality
    from ..utils.artifacts import save_artifact

    x, provenance = video_frames(args.dataset, args.frames, device)
    i, j, k = x.shape
    x4 = x.reshape(i, j, 1, k)  # `Demo_RC_FCTN.m:13`: reshape(double(gray_images), [I J 1 K])
    print(f"dataset={args.dataset} ({provenance}), 4-way shape={tuple(x4.shape)}, device={device}")

    obs = uniform(x4.shape, 0, device) <= args.sample_ratio
    f_obs = torch.where(obs, x4, torch.zeros_like(x4))
    lam = 5.0 / math.sqrt(max(i, j) * 1 * k)  # `Demo_RC_FCTN.m:34`: lamb / sqrt(max(I,J)*n3*n4), lamb = 5
    t0 = time.perf_counter()
    x_hat4, s4, err_hist = rc_fctn(f_obs, lam, obs.to(x4.dtype), origin=x4, f=0.7, gamma=1e-4, deta=1e-3,
                                   max_iter=args.max_iter)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    x_hat = torch.clamp(x_hat4.reshape(i, j, k), 0.0, 1.0)

    save_artifact(args.out_dir, args.dataset, "fctn", "Xhat", x_hat.cpu().numpy())
    save_artifact(args.out_dir, args.dataset, "fctn", "O", s4.reshape(i, j, k).cpu().numpy())
    save_artifact(args.out_dir, args.dataset, "fctn", "errHist", torch.as_tensor(err_hist).cpu().numpy())

    rse = float(torch.linalg.vector_norm(x_hat - x) / torch.linalg.vector_norm(x))
    mean_psnr, mean_ssim = quality(255.0 * x, 255.0 * x_hat)
    print(json.dumps({
        "method": "rc_fctn",
        "seconds": round(elapsed, 3),
        "rse": round(rse, 5),
        "mean_psnr": round(float(mean_psnr), 3),
        "mean_ssim": round(float(mean_ssim), 4),
        "device": str(device),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
