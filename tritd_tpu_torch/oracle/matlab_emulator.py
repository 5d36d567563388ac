"""MATLAB-semantics emulators of the five benchmarked reference solvers.

Pure numpy float64, order='F' reshapes (numpy's exact model of MATLAB
column-major `reshape`/`permute`), `np.linalg.pinv`/`svd` where the
reference calls `pinv`/`svd`, and the reference's exact control flow —
including its quirks (the SVT `r = sum(S > 1)` truncation gate, RC-FCTN's
all-ones traffic `Ind`, bypassed tolerance breaks). These are ORACLES:
slow, literal, and deliberately structured like the MATLAB, so that
agreement with the PyTorch implementations is evidence about semantics, not
a shared-code tautology. This package's own copy of
`tritd_tpu/oracle/matlab_emulator.py` (the two are held equal by
`tests/test_torch_oracle.py`); it imports `itertools`, `math` and `numpy`
only.

Where the reference randomizes an init (`randn`/`rand`), the emulator takes
it as an argument; the parity tool hands both sides the same arrays.

Reference map (each emulator cites its exact source lines inline):
  tritd_admm_em  <- fast_robust_triple_tensor/triple_decomp_ADMM.m:1-130
  tt_trpca_em    <- .../lib/TT_TRPCA.m:1-77 (+ weightTC.m, SVT quirk)
  rtrc_em        <- other_methods/tensor-ring/RTRC.m:1-83 (+ shrink_*.m,
                    evaluate_fr_R.m)
  rc_fctn_em     <- other_methods/IPI_RTC_FCTN-main/RTC_FCTN/RC_FCTN.m:1-150
                    (+ lib/SVT.m, lib/prox_l1.m)
  sofia_init_em  <- other_methods/sofia/sofia_init.m:1-110 (+ sofia_als.m)
"""

from __future__ import annotations

import itertools
import math

import numpy as np


# --- MATLAB column-major primitives -----------------------------------------


def m_reshape(x: np.ndarray, shape) -> np.ndarray:
    return np.reshape(x, shape, order="F")


def m_permute(x: np.ndarray, order) -> np.ndarray:
    """1-based MATLAB permute."""
    return np.transpose(x, [o - 1 for o in order])


def m_ipermute(x: np.ndarray, order) -> np.ndarray:
    inv = np.argsort([o - 1 for o in order])
    return np.transpose(x, inv)


def m_norm(x: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(x).ravel()))


def soft(x: np.ndarray, tau: float) -> np.ndarray:
    """`soft_threshold.m` / `shrink_vector.m` / `thres_soft.m`."""
    return np.sign(x) * np.maximum(np.abs(x) - tau, 0.0)


# --- TriTD-ADMM -------------------------------------------------------------


def m_unfold(x: np.ndarray, mode: int) -> np.ndarray:
    """`triple_decomp_ADMM.m:98-110` (same as `unfold.m:1-14`)."""
    n1, n2, n3 = x.shape
    if mode == 1:
        return m_reshape(x, (n1, n2 * n3))
    if mode == 2:
        return m_reshape(m_permute(x, (2, 1, 3)), (n2, n1 * n3))
    if mode == 3:
        return m_reshape(m_permute(x, (3, 1, 2)), (n3, n1 * n2))
    raise ValueError(mode)


def m_build_f(b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """`triple_decomp_ADMM.m:131-139` (= `buildF.m:17-22`)."""
    r, n2, _ = b.shape
    n3 = c.shape[2]
    bu = m_reshape(m_unfold(b, 2), (n2, r * r, 1))
    cu = m_reshape(m_unfold(c, 3).T, (1, r * r, n3))
    f = m_reshape(bu * cu, (n2, r, r, n3))
    return m_reshape(m_permute(f, (2, 3, 1, 4)), (r * r, n2 * n3))


def m_build_g(a: np.ndarray, c: np.ndarray) -> np.ndarray:
    """`triple_decomp_ADMM.m:141-149` (= `buildG.m:17-22`)."""
    n1, r, _ = a.shape
    n3 = c.shape[2]
    au = m_reshape(m_unfold(a, 1), (n1, r * r, 1))
    cu = m_reshape(m_unfold(c, 3).T, (1, r * r, n3))
    g = m_reshape(au * cu, (n1, r, r, n3))
    return m_reshape(m_permute(g, (2, 3, 1, 4)), (r * r, n1 * n3))


def m_build_h(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """`triple_decomp_ADMM.m:151-159` (= `buildH.m:17-22`)."""
    n1, r, _ = a.shape
    n2 = b.shape[1]
    au = m_reshape(m_unfold(a, 1), (n1, r * r, 1))
    bu = m_reshape(m_unfold(b, 2).T, (1, r * r, n2))
    h = m_reshape(au * bu, (n1, r, r, n2))
    return m_reshape(m_permute(h, (2, 3, 1, 4)), (r * r, n1 * n2))


def m_triple_product(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """`triple_product.m:6-7`."""
    n1 = a.shape[0]
    n2, n3 = b.shape[1], c.shape[2]
    return m_reshape(m_unfold(a, 1) @ m_build_f(b, c), (n1, n2, n3))


def _reshape_a_from_a1(a1, n1, r):
    """`triple_decomp_ADMM.m:112-116` — per-row column-major (r, r)."""
    a = np.zeros((n1, r, r))
    for i in range(n1):
        a[i] = m_reshape(a1[i], (r, r))
    return a


def _reshape_b_from_b2(b2, n2, r):
    """`triple_decomp_ADMM.m:118-122`."""
    b = np.zeros((r, n2, r))
    for j in range(n2):
        b[:, j, :] = m_reshape(b2[j], (r, r))
    return b


def _reshape_c_from_c3(c3, n3, r):
    """`triple_decomp_ADMM.m:124-128`."""
    c = np.zeros((r, r, n3))
    for t in range(n3):
        c[:, :, t] = m_reshape(c3[t], (r, r))
    return c


def tritd_admm_em(
    d: np.ndarray,
    a0: np.ndarray,
    b0: np.ndarray,
    c0: np.ndarray,
    *,
    mu: float = 1e-3,
    rho: float = 1.25,
    lam: float = 1.8,
    lam2: float = 1e-3,
    alpha_c: float = 1e-9,
    max_iter: int = 100,
    tol: float = 1e-5,
    origin: np.ndarray | None = None,
) -> dict:
    """`triple_decomp_ADMM.m:16-67` with the completion preset defaults
    (`traffic_triple_comparison.m:42-51`). a0/b0/c0 stand in for the
    reference's `randn` init (`:24`); everything else is literal, including
    the pinv ridge solves (`:73-95`), the mu*1e6 caps (`:17-18`) and the
    relative-change stop (`:63-65`)."""
    d = np.asarray(d, np.float64)
    a = np.asarray(a0, np.float64)
    b = np.asarray(b0, np.float64)
    c = np.asarray(c0, np.float64)
    r = a.shape[1]
    n1, n2, n3 = d.shape
    mu_l = mu_o = mu
    mu_l_max = mu_o_max = mu * 1e6
    o = np.zeros_like(d)
    e = np.zeros_like(d)
    y_l = np.zeros_like(d)
    y_o = np.zeros_like(d)
    norm_d = m_norm(d)
    norm_origin = m_norm(origin) if origin is not None else 1.0
    err_hist: list[float] = []
    rre_hist: list[float] = []
    eye = np.eye(r * r)
    l = np.zeros_like(d)
    for k in range(max_iter):
        t = d - o + y_l / mu_l
        f = m_build_f(b, c)
        a1 = (m_unfold(t, 1) @ f.T) @ np.linalg.pinv(f @ f.T + lam2 * eye)
        a = _reshape_a_from_a1(a1, n1, r)
        g = m_build_g(a, c)
        b2 = (m_unfold(t, 2) @ g.T) @ np.linalg.pinv(g @ g.T + lam2 * eye)
        b = _reshape_b_from_b2(b2, n2, r)
        h = m_build_h(a, b)
        c3 = (m_unfold(t, 3) @ h.T) @ np.linalg.pinv(h @ h.T + alpha_c * eye)
        c = _reshape_c_from_c3(c3, n3, r)
        l = m_triple_product(a, b, c)
        r1 = d - l + y_l / mu_l
        r2 = e - y_o / mu_o
        o = (mu_l * r1 + mu_o * r2) / (mu_l + mu_o)
        e = soft(o + y_o / mu_o, lam / mu_o)
        res_l = d - l - o
        res_o = o - e
        y_l = y_l + mu_l * res_l
        y_o = y_o + mu_o * res_o
        mu_l = min(mu_l * rho, mu_l_max)
        mu_o = min(mu_o * rho, mu_o_max)
        err_hist.append(m_norm(res_l) / norm_d + m_norm(res_o) / norm_d)
        if origin is not None:
            rre_hist.append(m_norm(l - origin) / norm_origin)
        if k >= 1 and abs(err_hist[k] - err_hist[k - 1]) < tol * err_hist[k - 1]:
            break
    return {
        "a": a, "b": b, "c": c, "l": l, "o": o, "e": e,
        "err_hist": np.asarray(err_hist),
        "rre_hist": np.asarray(rre_hist),
        "n_iters": len(err_hist),
    }


# --- TT-TRPCA ("TTNN") ------------------------------------------------------


def _svt_ref(a: np.ndarray, tau: float) -> np.ndarray:
    """`lib/SVT.m:1-13` with its `r = sum(S > 1)` truncation quirk: keep
    only shrunk singular values ABOVE ONE (not above zero)."""
    u0, s0, v0t = np.linalg.svd(a, full_matrices=False)
    s = soft(s0, tau)
    r = int(np.sum(s > 1))
    return (u0[:, :r] * s[:r]) @ v0t[:r]


def _weight_tc(nway) -> np.ndarray:
    """`weightTC.m:1-11`: alpha_k = min(dimL, dimR), normalized."""
    n = len(nway)
    lam = np.zeros(n - 1)
    il = nway[0]
    for k in range(n - 1):
        ir = math.prod(nway[k + 1:])
        lam[k] = min(il, ir)
        il *= nway[k + 1]
    return lam / lam.sum()


def tt_trpca_em(
    x_noise: np.ndarray,
    origin: np.ndarray,
    *,
    lam: float = 50.0,
    f: float = 5.0,
    gamma: float = 0.001,
    deta: float = 0.002,
    max_iter: int = 100,
) -> dict:
    """`TT_TRPCA.m:1-77` (tol break bypassed as committed, `:39-40`), with
    the experiment script preset (`traffic_triple_comparison.m:116-120`)."""
    x_noise = np.asarray(x_noise, np.float64)
    nway = x_noise.shape
    n = len(nway)
    alpha = _weight_tc(nway)
    beta = f * alpha
    dim_l = np.zeros(n - 1, int)
    il = 1
    for m in range(n - 1):
        dim_l[m] = il * nway[m]
        il = dim_l[m]
    z = np.zeros(nway)
    cs = [np.zeros(nway) for _ in range(n - 1)]
    e = np.zeros(nway)
    s = np.zeros(nway)
    j = np.zeros(nway)
    norm_origin = m_norm(origin)
    err_hist = np.zeros(max_iter)
    rel_hist = np.zeros(max_iter)
    for k in range(max_iter):
        z_last = z
        us = []
        for m in range(n - 1):
            un = _svt_ref(
                m_reshape(z, (dim_l[m], -1))
                - m_reshape(cs[m], (dim_l[m], -1)) / beta[m],
                alpha[m] / beta[m],
            )
            us.append(m_reshape(un, nway))
        y = soft(s - j / deta, lam / deta)
        temp = sum(beta[m] * (us[m] + cs[m] / beta[m]) for m in range(n - 1))
        ee = temp + gamma * (x_noise + e / gamma)
        ff = gamma * (x_noise + e / gamma) + deta * (y + j / deta)
        tt = gamma**2 - (beta.sum() + gamma) * (gamma + deta)
        z = (gamma * ff - (gamma + deta) * ee) / tt
        s = (gamma * ee - (beta.sum() + gamma) * ff) / tt
        for m in range(n - 1):
            cs[m] = cs[m] + beta[m] * (us[m] - z)
        e = e + gamma * (x_noise - z - s)
        j = j + deta * (y - s)
        gamma *= 1.1
        deta *= 1.1
        rel_hist[k] = abs(m_norm(z - z_last)) / (m_norm(z_last) or np.inf)
        err_hist[k] = m_norm(origin - z) / norm_origin
    return {"z": z, "s": s, "err_hist": err_hist, "rel_hist": rel_hist}


# --- RTRC ("RING"/TRLRF) ----------------------------------------------------


def _shrink_matrix_plain(m0: np.ndarray, tau: float) -> np.ndarray:
    """`shrink_matrix.m` flag=false branch (the one both experiment scripts hit):
    econ SVD, keep singular values STRICTLY above tau, shrink by tau."""
    u, s, vt = np.linalg.svd(m0, full_matrices=False)
    idx = int(np.sum(s > tau))
    return (u[:, :idx] * (s[:idx] - tau)) @ vt[:idx]


def _circular_order(n: int, shift: int):
    """`order=[n:N 1:n-1]` (1-based shift) as 0-based axes."""
    return [(shift + i) % n for i in range(n)]


def rtrc_em(
    tnsr: np.ndarray,
    p: np.ndarray,
    origin: np.ndarray,
    *,
    mu: float = 1e-1,
    max_iter: int = 100,
) -> dict:
    """`RTRC.m:1-83`: circular-unfolding SVT ADMM with the freedom-ratio
    weight heuristic (`evaluate_fr_R.m`), auto-lambda (`:17-23`), commented-
    out convergence break kept bypassed (`:70-72`)."""
    tnsr = np.asarray(tnsr, np.float64)
    p = np.asarray(p, np.float64)
    n = tnsr.ndim
    jdims = tnsr.shape
    x = p * tnsr
    y = np.zeros(jdims)
    big_l = math.ceil(n / 2)
    sr = p.sum() / p.size
    lam = 0.0
    for shift in range(big_l):
        order = _circular_order(n, shift)
        dl = math.prod(jdims[o] for o in order[:big_l])
        dr = math.prod(jdims[o] for o in order[big_l:])
        lam += 500.0 / math.sqrt(sr * max(dl, dr))
    # evaluate_fr_R: numerical rank of each circular unfolding of the
    # OBSERVED tensor drives the weights (`RTRC.m:32-35`)
    em = np.zeros(big_l)
    for shift in range(big_l):
        order = _circular_order(n, shift)
        mat = m_reshape(
            np.transpose(x, order),
            (math.prod(jdims[o] for o in order[:big_l]), -1),
        )
        rank = np.linalg.matrix_rank(mat)
        big = max(mat.shape)
        em[shift] = big * rank * math.log(big) ** 2.5
    weight = (1.0 / em) / (1.0 / em).sum()

    ls = [x.copy() for _ in range(big_l)]
    zs = [np.zeros(jdims) for _ in range(big_l)]
    w = np.zeros(jdims)
    norm_origin = m_norm(origin)
    err_hist = np.zeros(max_iter)
    for i in range(max_iter):
        l_cs = np.zeros(jdims)
        z_cs = np.zeros(jdims)
        for shift in range(big_l):
            order = _circular_order(n, shift)
            m_ = np.transpose(x - zs[shift] / mu, order)
            mat = m_reshape(m_, (math.prod(jdims[o] for o in order[:big_l]), -1))
            mat = _shrink_matrix_plain(mat, weight[shift] / mu)
            m_ = m_reshape(mat, tuple(jdims[o] for o in order))
            ls[shift] = np.transpose(m_, np.argsort(order))
            l_cs += ls[shift]
            z_cs += zs[shift]
        x = (l_cs + z_cs / mu + p * (tnsr - y - w / mu)) / (big_l + p)
        y = soft(p * (tnsr - x - w / mu), lam / mu)
        for shift in range(big_l):
            zs[shift] = zs[shift] + mu * (ls[shift] - x)
        w = w + mu * p * (x + y - tnsr)
        err_hist[i] = m_norm(x - origin) / norm_origin
        mu = min(mu * 1.1, 1e6)
    return {"x": x, "y": y, "err_hist": err_hist, "lam": lam,
            "weight": weight}


# --- RC-FCTN ----------------------------------------------------------------


def _myorder(n: int):
    """`RC_FCTN.m:119-136`: the C(N, N/2)/2 balanced bipartition orders
    [combo, complement], combos containing mode 1, lexicographic."""
    half = n // 2
    orders = []
    for combo in itertools.combinations(range(n), half):
        if combo[0] != 0:
            continue
        rest = tuple(i for i in range(n) if i not in combo)
        orders.append(combo + rest)
    return orders


def _weight_fctn(nway, orders) -> np.ndarray:
    """`RC_FCTN.m:138-150`: alpha_k = max(IL, IR), normalized."""
    half = len(nway) // 2
    lam = np.array([
        max(
            math.prod(nway[o] for o in order[:half]),
            math.prod(nway[o] for o in order[half:]),
        )
        for order in orders
    ], np.float64)
    return lam / lam.sum()


def rc_fctn_em(
    x_noise: np.ndarray,
    lam: float,
    ind1: np.ndarray,
    xtrue: np.ndarray,
    *,
    f: float = 0.1,
    gamma: float = 1e-3,
    deta: float = 1e-3,
    maxit: int = 100,
) -> dict:
    """`RC_FCTN.m:36-117`: bipartition SVT (with the `lib/SVT.m` quirk),
    prox_l1 sparse part, closed-form joint (X, E), observed projection of Y
    (`:92`), 1.5x penalty growth, RSE_real oracle history (`:102-104`)."""
    x_noise = np.asarray(x_noise, np.float64)
    nway = x_noise.shape
    dim = len(nway)
    half = math.ceil(dim / 2)
    orders = _myorder(dim)
    alpha = _weight_fctn(nway, orders)
    mu = f * alpha
    ind1 = np.asarray(ind1, np.float64)
    ind2 = 1.0 - (ind1 != 0)  # `Omega=find(Ind1==0); Ind2(Omega)=1` (`:40-42`)
    n1 = len(orders)
    x = np.zeros(nway)
    y = x_noise.copy()
    ls = [np.zeros(nway) for _ in range(n1)]
    zs = [np.zeros(nway) for _ in range(n1)]
    s = np.zeros(nway)
    p = np.zeros(nway)
    q = np.zeros(nway)
    e = np.zeros(nway)
    norm_xt = m_norm(xtrue)
    rse_real = np.zeros(maxit)
    for k in range(maxit):
        for n in range(n1):
            order = orders[n]
            temp = np.transpose(x - zs[n] / mu[n], order)
            a_ = m_reshape(temp, (math.prod(nway[o] for o in order[:half]), -1))
            ln = _svt_ref(a_, alpha[n] / mu[n])
            ln = m_reshape(ln, tuple(nway[o] for o in order))
            ls[n] = np.transpose(ln, np.argsort(order))
        # prox_l1 (`lib/prox_l1.m:12`)
        b_ = e - q / deta
        s = np.maximum(0.0, b_ - lam / deta) + np.minimum(0.0, b_ + lam / deta)
        temp = sum(mu[n] * (ls[n] + zs[n] / mu[n]) for n in range(n1))
        m_ = temp + gamma * (y + p / gamma)
        n_ = gamma * (y + p / gamma) + deta * (s + q / deta)
        tt = gamma**2 - (mu.sum() + gamma) * (gamma + deta)
        x = (gamma * n_ - (gamma + deta) * m_) / tt
        e = (gamma * m_ - (mu.sum() + gamma) * n_) / tt
        y = ind2 * (x + e - p / gamma) + ind1 * x_noise
        for n in range(n1):
            zs[n] = zs[n] + mu[n] * (ls[n] - x)
        p = p + gamma * (y - x - e)
        q = q + deta * (s - e)
        rse_real[k] = m_norm(x + s - xtrue) / norm_xt
        gamma *= 1.5
        deta *= 1.5
    return {"x": x, "s": s, "rse_real": rse_real}


# --- SOFIA (batch init) -----------------------------------------------------


def _ktensor_full(us) -> np.ndarray:
    """tensor_toolbox `full(ktensor(U))` for a 3-way CP factor list."""
    u1, u2, u3 = us
    return np.einsum("ir,jr,tr->ijt", u1, u2, u3)


def sofia_als_em(
    y: np.ndarray,
    omega: np.ndarray,
    r: int,
    m: int,
    lam1: float,
    lam2: float,
    init,
    max_iters: int = 300,
    fitchangetol: float = 1e-3,
) -> dict:
    """`sofia_als.m:27-152`: masked CP-ALS with per-row pinv solves on
    observed columns, init normalization into the last factor (`:32-38`),
    mode-3 Gauss-Seidel with temporal (lambda1) and seasonal (lambda2)
    Tikhonov coupling (`:92-125`), fit-change early stop (`:128-140`)."""
    omega = np.asarray(omega, bool)
    y = omega * np.asarray(y, np.float64)
    ysz = y.shape
    us = [np.array(u, np.float64) for u in init]
    n = len(us)
    for i in range(n - 1):
        weights = np.sqrt(np.sum(us[i] ** 2, axis=0))
        us[i] = us[i] / weights
        us[n - 1] = us[n - 1] * weights
    norm_y = m_norm(y)
    fit = 1 - m_norm(omega * (y - _ktensor_full(us))) / norm_y
    err_hist = []
    n_iters = 0
    for it in range(max_iters):
        fitold = fit
        # Mode 1 (`:57-68`)
        temp1 = us[1][None, :, None, :] * us[2][None, None, :, :]  # (1,n2,n3,R)
        temp2 = m_reshape(temp1, (-1, r)).T                        # tenmat(.,4)
        for i in range(ysz[0]):
            y_sl = y[i]                                            # (n2,n3)
            om_sl = omega[i].ravel(order="F")
            temp3 = np.sum(y_sl[:, :, None] * temp1[0], axis=(0, 1))
            temp4 = temp2[:, om_sl]
            us[0][i] = temp3 @ np.linalg.pinv(temp4 @ temp4.T)
        weights = np.sqrt(np.sum(us[0] ** 2, axis=0))
        us[0] = us[0] / weights
        us[n - 1] = us[n - 1] * weights
        # Mode 2 (`:72-86`)
        temp1 = us[0][:, None, None, :] * us[2][None, None, :, :]  # (n1,1,n3,R)
        temp2 = m_reshape(temp1, (-1, r)).T
        for i in range(ysz[1]):
            y_sl = y[:, i, :]
            om_sl = omega[:, i, :].ravel(order="F")
            temp3 = np.sum(y_sl[:, :, None] * temp1[:, 0], axis=(0, 1))
            temp4 = temp2[:, om_sl]
            us[1][i] = temp3 @ np.linalg.pinv(temp4 @ temp4.T)
        weights = np.sqrt(np.sum(us[1] ** 2, axis=0))
        us[1] = us[1] / weights
        us[n - 1] = us[n - 1] * weights
        # Mode 3, temporal, Gauss-Seidel in i (`:90-125`)
        temp1 = us[0][:, None, None, :] * us[1][None, :, None, :]  # (n1,n2,1,R)
        temp2 = m_reshape(temp1, (-1, r)).T
        n3 = ysz[2]
        for i in range(n3):
            y_sl = y[:, :, i]
            om_sl = omega[:, :, i].ravel(order="F")
            temp3 = np.sum(y_sl[:, :, None] * temp1[:, :, 0], axis=(0, 1))
            temp4 = temp2[:, om_sl]
            temp5 = temp4 @ temp4.T
            if i <= 0:
                temp3 = temp3 + lam1 * us[2][i + 1]
                temp5 = temp5 + lam1 * np.eye(r)
            elif i <= n3 - 2:
                temp3 = temp3 + lam1 * (us[2][i - 1] + us[2][i + 1])
                temp5 = temp5 + 2 * lam1 * np.eye(r)
            else:
                temp3 = temp3 + lam1 * us[2][i - 1]
                temp5 = temp5 + lam1 * np.eye(r)
            if i <= m - 1:
                temp3 = temp3 + lam2 * us[2][i + m]
                temp5 = temp5 + lam2 * np.eye(r)
            elif i <= n3 - m - 1:
                temp3 = temp3 + lam2 * (us[2][i - m] + us[2][i + m])
                temp5 = temp5 + 2 * lam2 * np.eye(r)
            else:
                temp3 = temp3 + lam2 * us[2][i - m]
                temp5 = temp5 + lam2 * np.eye(r)
            us[2][i] = temp3 @ np.linalg.pinv(temp5)
        x_hat = _ktensor_full(us)
        fit = 1 - m_norm(omega * (y - x_hat)) / norm_y
        err_hist.append(m_norm(omega * (y - x_hat)) / norm_y)
        n_iters = it + 1
        if it >= 1 and abs(fitold - fit) < fitchangetol:
            break
    return {"u": us, "x_hat": _ktensor_full(us),
            "err_hist": np.asarray(err_hist), "n_iters": n_iters}


def sofia_init_em(
    y: np.ndarray,
    omega: np.ndarray,
    r: int,
    m: int,
    lam1: float,
    lam2: float,
    lam3: float,
    u_init,
    origin: np.ndarray,
    *,
    max_epoch: int = 100,
    tol: float = 1e-5,
    als_max_iters: int = 300,
    als_fitchangetol: float = 1e-3,
) -> dict:
    """`sofia_init.m:28-110`: epochs of (ALS on Y-O, outlier peel
    O = soft(Y-X, lambda3)), lambda3 annealed 0.85x floored at
    lambda3_init/100 (`:68-71`), relative-change early stop (`:73-85`).
    `u_init` stands in for the `rand` init (`:44-47`)."""
    y = np.asarray(y, np.float64)
    omega = np.asarray(omega, bool)
    us = [np.array(u, np.float64) for u in u_init]
    o = np.zeros(y.shape)
    x = np.zeros(y.shape)
    norm_x = 0.0
    lam3_init = lam3
    norm_origin = m_norm(origin)
    err_hist = []
    n_epochs = 0
    for epoch in range(max_epoch):
        x_pre = x
        norm_x_pre = norm_x
        res = sofia_als_em(
            y - o, omega, r, m, lam1, lam2, us,
            max_iters=als_max_iters, fitchangetol=als_fitchangetol,
        )
        us, x = res["u"], res["x_hat"]
        o = soft(y - x, lam3)
        lam3 = max(lam3 * 0.85, lam3_init / 100.0)
        err_hist.append(m_norm(origin - x) / norm_origin)
        n_epochs = epoch + 1
        if epoch >= 1:
            relative_change = m_norm(x_pre - x) / norm_x_pre
            if relative_change < tol:
                norm_x = m_norm(x)
                break
        norm_x = m_norm(x)
    return {"u": us, "x_hat": x, "o": o,
            "err_hist": np.asarray(err_hist), "n_epochs": n_epochs}
