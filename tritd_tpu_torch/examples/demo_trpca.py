"""Demo: tensor robust PCA competitors (SNN / TNN / TTNN) on a video tensor.

Counterpart of the JAX package's `examples/demo_trpca.py`, after the
reference's `Demo_TRPCA.m`: normalize a grayscale video tensor to [0, 1],
optionally corrupt a fraction `rhos` of entries with uniform noise (the
committed demo uses rhos = 0, `Demo_TRPCA.m:18-21`), run each method, save
`<name>_<method>_{Xhat,O,errHist}` artifacts and video exports, and report
the per-frame PSNR of the clipped reconstruction (`Demo_TRPCA.m:43-48`).

Run: python -m tritd_tpu_torch.examples.demo_trpca [--dataset highway]
     [--frames 60] [--max-iter 30] [--rhos 0.1] [--methods snn tnn ttnn]
     [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ._common import add_device_flags, device_of, uniform, video_frames


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="highway")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--max-iter", type=int, default=30)
    p.add_argument("--rhos", type=float, default=0.0, help="corruption density (Demo_TRPCA.m:18, committed 0)")
    p.add_argument("--methods", nargs="+", default=["snn", "tnn", "ttnn"], choices=["snn", "tnn", "ttnn"])
    p.add_argument("--out-dir", default="demo_out")
    add_device_flags(p, cpu_alias=True)
    args = p.parse_args(argv)
    device = device_of(args)

    from ..baselines import trpca_snn, trpca_tnn, tt_trpca
    from ..cli.figures import tensor2video
    from ..metrics.image import psnr
    from ..utils.artifacts import save_artifact

    x0, provenance = video_frames(args.dataset, args.frames, device)
    max_p = float(x0.abs().max())
    n3 = x0.shape[2]
    print(f"dataset={args.dataset} ({provenance}), shape={tuple(x0.shape)}, device={device}")

    xn = x0
    if args.rhos > 0:  # `rand('seed', 42)`: the hits and the noise from two seeded draws
        hit = uniform(x0.shape, 42, device) < args.rhos
        xn = torch.where(hit, uniform(x0.shape, 43, device), x0)

    for method in args.methods:
        t0 = time.perf_counter()
        if method == "snn":  # `Demo_TRPCA.m` SNN block: alpha=[7 9 2.6], mu=1e-3, rho=1.2
            x_hat, e, err_hist = trpca_snn(xn, alpha=(7.0, 9.0, 2.6), mu=1e-3, rho=1.2, max_iter=args.max_iter)
        elif method == "tnn":
            x_hat, e, err_hist = trpca_tnn(xn, origin=x0, max_iter=args.max_iter)
        else:
            x_hat, e, err_hist, _ = tt_trpca(xn, lam=50.0, f=5.0, origin=x0, max_iter=args.max_iter)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - t0
        hist = np.asarray(err_hist.detach().cpu() if isinstance(err_hist, torch.Tensor) else err_hist)
        x_np, e_np = x_hat.detach().cpu().numpy(), e.detach().cpu().numpy()

        save_artifact(args.out_dir, args.dataset, method, "Xhat", x_np)
        save_artifact(args.out_dir, args.dataset, method, "O", e_np)
        save_artifact(args.out_dir, args.dataset, method, "errHist", hist)
        tensor2video(x_np, f"{args.out_dir}/{args.dataset}_{method}_Xhat")
        tensor2video(e_np, f"{args.out_dir}/{args.dataset}_{method}_O")

        # `Demo_TRPCA.m:43-48`: clip to [0, maxP], per-frame PSNR at 255 scale
        x_clip = torch.clamp(x_hat, 0.0, max_p)
        psnrs = [float(psnr(255.0 * x0[:, :, i], 255.0 * x_clip[:, :, i])) for i in range(n3)]
        print(json.dumps({
            "method": method,
            "seconds": round(elapsed, 3),
            "mean_psnr": round(float(np.mean(psnrs)), 3),
            "final_err": float(hist[-1]) if hist.size else None,
            "device": str(device),
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
