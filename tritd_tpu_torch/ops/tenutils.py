"""Tensor constructors, matrix generators and Kruskal/Tucker class helpers —
the remaining Tensor Toolbox v3.1 function surface: `ttm/ttv/ttt`, `nvecs`,
`collapse/contract/scale`, `tendiag/teneye/tenones/tenzeros/tenrandblk`,
`matrandorth/matrandnorm/matrandcong`, `create_guess`,
`create_problem_binary`, `export_data/import_data`, and the `ktensor`
(`arrange`, `fixsigns`, `innerprod`, `norm`, `score`), `ttensor` and
`sumtensor` class operations.

PyTorch counterpart of `tritd_tpu/ops/tenutils.py`. Kruskal tensors are
`(weights, [U_1..U_N])`, Tucker tensors `(core, [U_1..U_N])`, sum tensors
plain lists of dense tensors. Random constructors take `generator`,
`dtype` and `device` as `ops/kruskal.py` describes.

Differences of idiom: `collapse(fun=...)` calls `fun(x, dim=dims)`, so pass
`torch.sum`, `torch.mean` or `torch.amax`/`torch.amin` (`torch.max` with a
`dim` returns a pair and takes one dim only). `nvecs(flipsign=True)` and
`ktensor_fixsigns` pick `argmax |u|` per column: on a tie the winner is not
defined across packages. `export_data`/`import_data` are numpy text I/O in
the reference's format: a file written by either package is read by the
other.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .decomp import _mode_product, mttkrp, tucker_ttm
from .kruskal import cp_normalize, default_device, default_generator, draw, ktensor_full


def ttm(x: torch.Tensor, u: torch.Tensor, mode: int, transpose: bool = False) -> torch.Tensor:
    """Single-mode tensor-times-matrix — Tensor Toolbox ``ttm(X, U, n)``
    (``@tensor/ttm.m``): contracts U (or Uᵀ with the toolbox's 't' flag)
    against mode `mode` (0-based), replacing that dimension. N-way."""
    return _mode_product(x, u, mode, transpose)


def ttv(x: torch.Tensor, vecs, modes=None) -> torch.Tensor:
    """Tensor-times-vector(s) — Tensor Toolbox ``ttv(X, v, n)`` /
    ``ttv(X, {v1..vk}, dims)`` (``@tensor/ttv.m``): contracts each vector
    along its mode and DROPS that mode. `vecs` is one vector or a sequence;
    `modes` defaults to the first len(vecs) modes, like the toolbox."""
    if isinstance(vecs, torch.Tensor) and vecs.ndim == 1:
        vecs = [vecs]
        modes = [0 if modes is None else int(modes)]
    else:
        vecs = list(vecs)
        modes = (
            list(range(len(vecs)))
            if modes is None
            else [int(m) for m in modes]
        )
    # contract highest mode first so earlier mode indices stay valid
    for m, v in sorted(zip(modes, vecs), key=lambda p: -p[0]):
        x = torch.tensordot(x, v, dims=([m], [0]))
    return x


def ttt(a: torch.Tensor, b: torch.Tensor, adims=None, bdims=None) -> torch.Tensor:
    """Tensor-times-tensor — Tensor Toolbox ``ttt(A, B[, adims[, bdims]])``
    (``@tensor/ttt.m``): with no dims the outer product, with dims the
    contraction of A's `adims` against B's `bdims` (defaulting to `adims`,
    as the toolbox does); contracting every mode yields the scalar inner
    product. Modes are 0-based. The result's modes are A's remaining modes
    followed by B's remaining modes (the toolbox's tenmat row/col order)."""
    if adims is None:
        adims = ()
    adims = (adims,) if isinstance(adims, int) else tuple(adims)
    bdims = adims if bdims is None else (
        (bdims,) if isinstance(bdims, int) else tuple(bdims)
    )
    if len(adims) == 0:
        return torch.tensordot(a, b, dims=0)
    return torch.tensordot(a, b, dims=(list(adims), list(bdims)))


def _positive_peak(u: torch.Tensor) -> torch.Tensor:
    """Per column, the sign of the largest-magnitude entry (1 where it is 0)."""
    mx = torch.argmax(torch.abs(u), dim=0)
    s = torch.sign(u.gather(0, mx[None, :])[0])
    return torch.where(s == 0, torch.ones_like(s), s)


def nvecs(x: torch.Tensor, mode: int, r: int, flipsign: bool = True) -> torch.Tensor:
    """Leading-r eigenvectors of the mode-`mode` unfolding Gram Xn·Xnᵀ —
    ``@tensor/nvecs.m`` (eigs 'LM' branch). Dense symmetric eigendecomposition
    instead of Lanczos: the Gram is (n_mode × n_mode), small by construction.
    `flipsign` makes each column's largest-|.|-entry positive, as the
    toolbox default does."""
    xn = x.movedim(mode, 0).reshape(x.shape[mode], -1)
    _w, v = torch.linalg.eigh(xn @ xn.T)  # ascending
    u = v.flip(1)[:, :r]
    if flipsign:
        u = u * _positive_peak(u)[None, :]
    return u


def collapse(x: torch.Tensor, dims=None, fun=torch.sum) -> torch.Tensor:
    """Reduce over `dims` with `fun` (default sum) — ``@tensor/collapse.m``.
    `fun` is any reduction accepting a `dim` tuple (torch.sum, torch.amax,
    torch.mean, ...); collapsing every mode returns a scalar.

    Negative dims follow the toolbox's `tt_dimscheck` exclusion convention
    (0-based here): ``dims=-k`` (or a tuple of negatives) means "all modes
    EXCEPT mode k" — e.g. ``collapse(x, -2)`` reduces every mode but mode 2
    (`@tensor/collapse.m` via `tt_dimscheck.m`). Mixing signs is an error,
    matching the toolbox."""
    if dims is None:
        dims = tuple(range(x.ndim))
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    if len(dims) == 0:
        return x
    if any(d < 0 for d in dims):
        if not all(d < 0 for d in dims):
            raise ValueError("collapse dims must be all >=0 or all negative")
        excluded = {-d for d in dims}
        dims = tuple(d for d in range(x.ndim) if d not in excluded)
        if len(dims) == 0:
            return x
    return fun(x, dim=dims)


def contract(x: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """Trace over modes `i` and `j` (equal size, distinct) —
    ``@tensor/contract.m``."""
    if i == j:
        raise ValueError("must contract along two different dimensions")
    if x.shape[i] != x.shape[j]:
        raise ValueError("must contract along equally sized dimensions")
    return torch.diagonal(x, dim1=i, dim2=j).sum(dim=-1)


def scale(x: torch.Tensor, s: torch.Tensor, dims) -> torch.Tensor:
    """Scale the fibers of `x` lying in modes `dims` elementwise by the
    tensor `s` of shape ``x.shape[dims]`` — ``@tensor/scale.m``. A vector
    `s` with ``dims=k`` rescales mode-k slices; a full-shape `s` with all
    dims is a Hadamard product."""
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    s = torch.as_tensor(s, device=x.device)
    expect = tuple(x.shape[d] for d in dims)
    if tuple(s.shape) != expect:
        raise ValueError(f"scale factor shape {tuple(s.shape)} != {expect}")
    # align s's axes with x's dims (dims may be unordered), broadcast the rest
    pairs = sorted(zip(dims, range(len(dims))))
    s = s.permute([k for _, k in pairs])
    shape = [1] * x.ndim
    for d, _ in pairs:
        shape[d] = x.shape[d]
    return x * s.reshape(shape)


# ---------------------------------------------------------------- constructors


def tenzeros(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """``tenzeros(sz)``."""
    return torch.zeros(tuple(shape), dtype=dtype, device=default_device(device))


def tenones(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """``tenones(sz)``."""
    return torch.ones(tuple(shape), dtype=dtype, device=default_device(device))


def tendiag(v: torch.Tensor, shape=None) -> torch.Tensor:
    """Dense tensor with `v` on the superdiagonal — ``tendiag(v, sz)``."""
    n = int(v.shape[0])
    if shape is None:
        shape = (n, n, n)
    shape = tuple(int(s) for s in shape)
    if n > min(shape):
        raise ValueError(f"{n} diagonal entries do not fit in shape {shape}")
    out = torch.zeros(shape, dtype=v.dtype, device=v.device)
    idx = torch.arange(n, device=v.device)
    out[tuple(idx for _ in shape)] = v
    return out


def teneye(order: int, size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity tensor E of even order m with ``ttsv(E, x, -1) = x`` for all
    unit-norm x — ``teneye.m`` semantics (reference
    ``other_methods/tensor_toolbox-v3.1/teneye.m:30-38``: each entry is the
    fraction of the m! index permutations whose m/2 adjacent pairs are all
    equal). Built as the permutation-average of the delta-chain
    prod_k delta(i_{2k}, i_{2k+1}) — identical by symmetry of the count,
    without the per-index loop. Built in float64 on the host with numpy, as
    the reference builds it, then moved. Like the original it only exists
    for even order and is practical only for small (m, n)."""
    if order % 2 != 0:
        raise ValueError("identity tensor only exists for even order")
    shape = (size,) * order
    idx = np.indices(shape)
    chain = np.ones(shape, dtype=np.float64)
    for k in range(0, order - 1, 2):
        chain = chain * (idx[k] == idx[k + 1])
    out = np.zeros(shape, dtype=np.float64)
    perms = list(itertools.permutations(range(order)))
    for p in perms:
        out += np.transpose(chain, p)
    return torch.from_numpy(out / len(perms)).to(device=default_device(device), dtype=dtype)


def tenrandblk(generator, block_sizes, noise: float = 0.1, dtype=torch.float32, device=None):
    """Nearly block-diagonal random tensor — ``tenrandblk``: dense noise of
    magnitude `noise` plus unit-norm random blocks on the diagonal. Block
    rows of `block_sizes` (n_blocks, N) give each block's extent per mode."""
    generator = default_generator(generator)
    device = default_device(device)
    block_sizes = [tuple(int(s) for s in row) for row in block_sizes]
    n = len(block_sizes[0])
    shape = tuple(sum(row[ax] for row in block_sizes) for ax in range(n))
    out = noise * draw("normal", generator, shape, dtype, device)
    offs = [0] * n
    for row in block_sizes:
        blk = draw("normal", generator, row, dtype, device)
        blk = blk / torch.linalg.vector_norm(blk)
        sl = tuple(slice(offs[ax], offs[ax] + row[ax]) for ax in range(n))
        out[sl] += blk
        offs = [offs[ax] + row[ax] for ax in range(n)]
    return out


# ------------------------------------------------------------- random matrices


def matrandnorm(x: torch.Tensor) -> torch.Tensor:
    """Normalize columns to unit 2-norm — ``matrandnorm``."""
    norms = torch.linalg.vector_norm(x, dim=0, keepdim=True)
    return x / torch.where(norms > 0, norms, torch.ones_like(norms))


def matrandorth(generator, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Random n x n orthogonal matrix (Haar via QR with sign fix) —
    ``matrandorth``."""
    a = draw("normal", default_generator(generator), (n, n), dtype, default_device(device))
    q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r))[None, :]


def matrandcong(generator, m: int, n: int, gamma: float, dtype=torch.float32, device=None):
    """Random (m, n) matrix with unit-norm columns and pairwise congruence
    (column inner product) exactly `gamma` — ``matrandcong``'s contract,
    constructed directly: columns = sqrt(gamma)*u + sqrt(1-gamma)*e_i with a
    shared random unit vector u in the orthogonal complement of the chosen
    orthonormal columns e_i."""
    if m <= n:
        raise ValueError("matrandcong requires m > n")
    generator = default_generator(generator)
    device = default_device(device)
    q = matrandorth(generator, m, dtype, device)  # orthonormal basis
    e = q[:, :n]
    # unit vector in span of remaining basis columns
    w = draw("normal", generator, (m - n,), dtype, device)
    u = q[:, n:] @ (w / torch.linalg.vector_norm(w))
    c = gamma**0.5
    s = (1.0 - gamma) ** 0.5
    return c * u[:, None] + s * e


# --------------------------------------------------------------- ktensor class


def ktensor_norm(weights: torch.Tensor, factors) -> torch.Tensor:
    """Frobenius norm of a Kruskal tensor without materializing it —
    ``norm(ktensor)``: sqrt(w^T (hadamard of Grams) w)."""
    g = weights[:, None] * weights[None, :]
    for u in factors:
        g = g * (u.T @ u)
    return torch.sqrt(torch.clamp(g.sum(), min=0.0))


def ktensor_innerprod(weights, factors, other) -> torch.Tensor:
    """<ktensor, X> for dense X or another ktensor `(weights, factors)` —
    ``innerprod(ktensor, ...)``."""
    if isinstance(other, tuple):
        w2, f2 = other
        g = weights[:, None] * w2[None, :]
        for u, v in zip(factors, f2):
            g = g * (u.T @ v)
        return g.sum()
    n = len(factors)
    m = mttkrp(other, factors, n - 1)
    return (weights[None, :] * factors[n - 1] * m).sum()


def ktensor_arrange(weights, factors):
    """Normalize columns and sort components by weight descending —
    ``arrange(ktensor)``."""
    factors, weights = cp_normalize(list(factors), weights)
    order = torch.argsort(-weights)
    return weights[order], [u[:, order] for u in factors]


def ktensor_fixsigns(weights, factors):
    """Flip signs so each column's largest-magnitude entry is positive,
    keeping the product invariant — ``fixsigns(ktensor)``: sign flips are
    absorbed pairwise; an odd total flip count per component is absorbed
    into the weight."""
    total_sign = torch.ones_like(weights)
    new_factors = []
    for u in factors:
        s = _positive_peak(u)
        new_factors.append(u * s[None, :])
        total_sign = total_sign * s
    return weights * total_sign, new_factors


def ktensor_score(weights_a, factors_a, weights_b, factors_b) -> torch.Tensor:
    """Congruence score between two same-rank Kruskal tensors —
    ``score(ktensor, ktensor)`` with greedy component matching: mean over
    matched components of the product of per-mode column cosines times the
    weight-penalty factor (1 - |wa - wb| / max(wa, wb)).

    The greedy match walks the R x R congruence matrix on the host (one
    copy of R^2 numbers instead of R reads from the device)."""
    wa, fa = ktensor_arrange(weights_a, factors_a)
    wb, fb = ktensor_arrange(weights_b, factors_b)
    r = wa.shape[0]
    c = torch.ones((r, r), dtype=fa[0].dtype, device=fa[0].device)
    for u, v in zip(fa, fb):
        c = c * torch.abs(u.T @ v)
    penalty = 1.0 - torch.abs(wa[:, None] - wb[None, :]) / torch.clamp(
        torch.maximum(wa[:, None], wb[None, :]), min=1e-30
    )
    c = c * penalty
    # greedy assignment (the toolbox default 'greedy' option)
    cmat = c.detach().cpu().numpy().copy()
    rows, cols = [], []
    for _ in range(r):
        i, j = np.unravel_index(np.argmax(cmat), cmat.shape)
        rows.append(int(i))
        cols.append(int(j))
        cmat[i, :] = -np.inf
        cmat[:, j] = -np.inf
    picked = c[torch.as_tensor(rows, device=c.device), torch.as_tensor(cols, device=c.device)]
    return picked.sum() / r


# ------------------------------------------------------ ttensor / sumtensor


def ttensor_full(core: torch.Tensor, factors) -> torch.Tensor:
    """Dense tensor of a Tucker operator — ``full(ttensor)``."""
    return tucker_ttm(core, list(factors), transpose=False)


def ttensor_norm(core: torch.Tensor, factors) -> torch.Tensor:
    """``norm(ttensor)`` without materializing: fold the small Gram of each
    factor into the core (exact also for non-orthonormal factors)."""
    y = core
    for ax, u in enumerate(factors):
        y = _mode_product(y, u.T @ u, ax, transpose=False)
    return torch.sqrt(torch.clamp((core * y).sum(), min=0.0))


def sumtensor_full(parts) -> torch.Tensor:
    """``full(sumtensor)``: sum of already-densified parts."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


# ----------------------------------------------------------- problem helpers


def create_guess(generator, shape, rank: int, dtype=torch.float32, device=None):
    """Random initial factor guess — ``create_guess`` ('rand' factors)."""
    generator = default_generator(generator)
    device = default_device(device)
    return [draw("uniform", generator, (s, rank), dtype, device) for s in shape]


def create_problem_binary(generator, shape, rank: int, noise: float = 0.1, device=None):
    """Random low-rank 0/1 tensor — ``create_problem_binary``: Bernoulli
    draws with odds given by a low-rank nonnegative parameter tensor."""
    generator = default_generator(generator)
    device = default_device(device)
    factors = [draw("uniform", generator, (s, rank), torch.float32, device) for s in shape]
    m = ktensor_full(factors)
    p = m / (1.0 + m)  # odds -> probability
    p = (1.0 - noise) * p + noise * 0.5
    data = (draw("uniform", generator, p.shape, torch.float32, device) < p).to(torch.float32)
    return {"factors": factors, "prob": p, "data": data}


# ------------------------------------------------------------------ data files


def export_data(x, path: str) -> None:
    """Write a tensor/matrix in the Tensor Toolbox interchange format —
    ``export_data``: a 'tensor'/'matrix' header, ndims, size line, then
    values (one per line, last index varying fastest: the row-major
    convention of this framework)."""
    arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    kind = "matrix" if arr.ndim == 2 else "tensor"
    with open(path, "w") as f:
        f.write(f"{kind}\n{arr.ndim}\n")
        f.write(" ".join(str(s) for s in arr.shape) + "\n")
        for v in arr.ravel():
            f.write(f"{v:.16g}\n")


def import_data(path: str) -> np.ndarray:
    """Read the interchange format written by :func:`export_data` —
    ``import_data``. Returns a float64 numpy array, as the reference does."""
    with open(path) as f:
        kind = f.readline().strip()
        if kind not in ("tensor", "matrix"):
            raise ValueError(f"unsupported data type {kind!r}")
        ndim = int(f.readline())
        shape = tuple(int(s) for s in f.readline().split())
        assert len(shape) == ndim
        vals = np.array([float(f.readline()) for _ in range(int(np.prod(shape)))])
    return vals.reshape(shape)
