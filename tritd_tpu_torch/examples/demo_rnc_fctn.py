"""Demo: RNC-FCTN (PAM on explicit FCTN factors) on a video tensor.

Counterpart of the JAX package's `examples/demo_rnc_fctn.py`, after the
reference's `Demo_RNC_FCTN.m`: load a grayscale video, normalize, reshape to
4-way [I, J, 1, K] (`Demo_RNC_FCTN.m:11`), observe at `sample_ratio`
(committed value 1.0, `:15`) and run the PAM solver with the demo's rank
schedule. Below a sample ratio of 1 the reference's two-direction
interpolated warm start (`:33-55`, `baselines.rnc_fctn.interpolate_init`)
replaces the zero-filled data; at 1 it is the identity and is skipped.

Run: python -m tritd_tpu_torch.examples.demo_rnc_fctn [--dataset highway]
     [--frames 40] [--max-iter 20] [--sample-ratio 1.0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ._common import add_device_flags, device_of, uniform, video_frames


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="highway")
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--max-iter", type=int, default=20)
    p.add_argument("--sample-ratio", type=float, default=1.0)
    p.add_argument("--out-dir", default="demo_out")
    add_device_flags(p, cpu_alias=True)
    args = p.parse_args(argv)
    device = device_of(args)

    from ..baselines import rnc_fctn
    from ..baselines.rnc_fctn import interpolate_init
    from ..metrics.image import quality
    from ..utils.artifacts import save_artifact

    x, provenance = video_frames(args.dataset, args.frames, device)
    i, j, k = x.shape
    x4 = x.reshape(i, j, 1, k)
    print(f"dataset={args.dataset} ({provenance}), 4-way shape={tuple(x4.shape)}, device={device}")

    omega = uniform(x4.shape, 0, device) <= args.sample_ratio
    f_obs = torch.where(omega, x4, torch.zeros_like(x4))
    if args.sample_ratio < 1.0:
        f_obs = interpolate_init(f_obs, omega)

    t0 = time.perf_counter()
    x_hat4, _gs, _e4, rse_hist, n_iters = rnc_fctn(f_obs, lam=1.0, omega=omega, origin=x4, max_iter=args.max_iter,
                                                    generator=torch.Generator().manual_seed(0))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    x_hat = torch.clamp(x_hat4.reshape(i, j, k), 0.0, 1.0)

    save_artifact(args.out_dir, args.dataset, "rnc_fctn", "Xhat", x_hat.cpu().numpy())
    save_artifact(args.out_dir, args.dataset, "rnc_fctn", "errHist", torch.as_tensor(rse_hist).cpu().numpy())

    rse = float(torch.linalg.vector_norm(x_hat - x) / torch.linalg.vector_norm(x))
    mean_psnr, mean_ssim = quality(255.0 * x, 255.0 * x_hat)
    print(json.dumps({
        "method": "rnc_fctn",
        "seconds": round(elapsed, 3),
        "n_iters": int(n_iters),
        "rse": round(rse, 5),
        "mean_psnr": round(float(mean_psnr), 3),
        "mean_ssim": round(float(mean_ssim), 4),
        "device": str(device),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
