"""Demo: the Tensor Toolbox class surface, end to end.

Counterpart of the JAX package's `examples/demo_toolbox.py`, in the style of
the toolbox's own documentation scripts: build dense, sparse, Kruskal,
Tucker and symmetric tensors through `tritd_tpu_torch.ops.classes` on the
device, run the headline algorithms through the class face, round-trip the
matricized forms, and take one gradient step of the symmetric Kruskal
objective, checked against `torch.autograd`.

Run: python -m tritd_tpu_torch.examples.demo_toolbox [--n 20] [--rank 3]
     [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ._common import add_device_flags, device_of


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=20)
    p.add_argument("--rank", type=int, default=3)
    add_device_flags(p)
    args = p.parse_args(argv)
    device = device_of(args)

    from ..ops import cp_als, eig_sshopm, tucker_hooi
    from ..ops.classes import KTensor, SpTensor, SymKTensor, SymTensor, Tensor, TTensor

    rng = np.random.default_rng(0)
    n, r = args.n, args.rank
    f32 = dict(device=device, dtype=torch.float32)

    # 1. Kruskal ground truth -> dense -> CP-ALS recovery (cp_als.m)
    kt = KTensor([rng.standard_normal((n, r)) for _ in range(3)], **f32).normalize().arrange()
    x = kt.full()
    fit = cp_als(x.data, rank=r, max_iters=100, init="nvecs")
    rec = KTensor(fit["factors"], fit["weights"])
    rel = float((x - rec.full()).norm() / x.norm())
    print(f"cp_als through the class face: rel err {rel:.2e}, "
          f"score vs truth {float(kt.score(rec.normalize())):.3f}, device {x.data.device}")

    # 2. Tucker-HOOI + ttensor algebra (tucker_als.m, @ttensor methods)
    tk = tucker_hooi(x.data, (r, r, r), max_iters=30)
    tt = TTensor(tk["core"], tk["factors"])
    print(f"tucker_hooi core {tuple(tt.core.shape)}, "
          f"rel err {float((x - tt.full()).norm() / x.norm()):.2e}, "
          f"entry(1,2,3) {float(tt[1, 2, 3]):+.4f}")

    # 3. Sparse workflow: COO tensor, scatter ttm, sptenmat + matrix-free
    #    A*A'*x (@sptensor/ttm.m, @sptenmat/aatx.m)
    nnz = 5 * n
    coords = np.stack([rng.integers(0, n, nnz) for _ in range(3)], 1)
    sp = SpTensor(rng.standard_normal(nnz), coords, (n, n, n), **f32)
    u = rng.standard_normal((r, n))
    dense_slab = sp.ttm(u, 0)
    am = sp.to_sptenmat((0,))
    v = rng.standard_normal(n)
    aatv = am.aatx(v)
    a_dense = am.double()
    vt = torch.as_tensor(v, **f32)
    err = float((aatv - a_dense @ (a_dense.T @ vt)).abs().max())
    print(f"sptensor.ttm -> {dense_slab.shape}, sptenmat.aatx matrix-free max err {err:.1e}, nnz={sp.nnz}")

    # 4. Symmetric eigenpair via SS-HOPM on a symtensor (eig_sshopm.m)
    a = Tensor(rng.standard_normal((8, 8, 8)), **f32).symmetrize()
    sym = SymTensor(a.data, presymmetrized=True)
    res = eig_sshopm(sym.data, shift=2.0, generator=torch.Generator().manual_seed(0))
    lam, vec = res["eigval"], res["eigvec"]
    resid = float(torch.linalg.vector_norm(sym.ttsv(vec) - lam * vec))
    print(f"eig_sshopm: lambda {float(lam):+.4f}, ||Ax^2 - lam x|| {resid:.1e}, "
          f"converged={bool(res['converged'])}")

    # 5. Symmetric Kruskal objective surface (fg.m): one gradient step, the
    #    gradient held to autograd
    model = SymKTensor(rng.standard_normal(2), rng.standard_normal((8, 2)), 3, **f32)
    data = model.fg_setup(sym)
    f0, g = model.fg(data)
    vec0 = model.tovec().clone().requires_grad_(True)
    (g_auto,) = torch.autograd.grad(SymKTensor.from_vec(vec0, 8, 2, 3).fg(data)[0], vec0)
    stepped = SymKTensor.from_vec(model.tovec() - 1e-3 * g, 8, 2, 3)
    f1, _ = stepped.fg(data)
    gap = float((g - g_auto).abs().max() / g.abs().max())
    print(f"symktensor.fg: f {float(f0):.4f} -> {float(f1):.4f} after one "
          f"gradient step (must decrease: {bool(f1 < f0)}), gradient vs autograd rel {gap:.1e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
