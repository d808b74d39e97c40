"""Literal NumPy simulation of the reference align_impl (CvoGPU.cu:1340-1572).

Used to validate that this repo's align loop reproduces the reference's
*trajectory* (ell schedule, step sizes, break iteration, final pose) on
identical inputs — the strongest fidelity check available without CUDA.

Includes the pieces this build intentionally redesigns, so differences
can be attributed: the ELL scan-order num_neighbors row cap
(fill_in_A_mat_gpu, CvoGPU.cu:541-589), the cap shrink to 1.2x the observed
max row count (CvoGPU.cu:1519-1529), and the std::queue indicator.
"""

import numpy as np

from oracle import OracleIndicator


def se3_exp_ref(xi, dt):
    w, v = xi[:3], xi[3:]
    theta = np.linalg.norm(w)
    I = np.eye(3)
    if theta < 1e-6:
        return I.copy(), dt * v
    A = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    t2 = theta * theta
    st, ct = np.sin(dt * theta), np.cos(dt * theta)
    omc = (1 - ct) / t2
    A2 = A @ A
    R = I + (st / theta) * A + omc * A2
    Jl = dt * I + omc * A + ((dt * theta - st) / (t2 * theta)) * A2
    return R, Jl @ v


def kernel_rows_capped(p, ell, x, y_t, xf, yf, cap):
    """fill_in_A_mat_gpu with the scan-order row cap. Returns dense A."""
    N, M = len(x), len(y_t)
    sigma2 = p.sigma**2
    l = (np.linalg.norm(x, axis=1) / 500.0 + 1.0) * ell  # [N]
    d2_thres = -2.0 * l * l * np.log(p.sp_thres / sigma2)
    d2 = ((x[:, None, :] - y_t[None, :, :]) ** 2).sum(-1)
    a = sigma2 * np.exp(-d2 / (2.0 * l * l)[:, None])
    ok = d2 < d2_thres[:, None]
    if p.is_using_intensity and xf is not None:
        c2 = p.c_ell**2
        cs2 = p.c_sigma**2
        d2c = ((xf[:, None, :] - yf[None, :, :]) ** 2).sum(-1)
        okc = d2c < -2.0 * c2 * np.log(p.sp_thres / cs2)
        a = a * cs2 * np.exp(-d2c / (2 * c2))
        ok &= okc
    A = np.where(ok & (a > p.sp_thres), a, 0.0).astype(np.float32)
    # scan-order cap: keep only the first `cap` nonzeros per row
    nzcount = np.cumsum(A > 0, axis=1)
    A = np.where(nzcount <= cap, A, 0.0)
    return A


def align_ref_sim(p, x, y0, xf=None, yf=None, init_guess=np.eye(4), max_iter=None,
                  collect=None):
    """Returns (transform, ret, history dict)."""
    R = init_guess[:3, :3].astype(np.float64).copy()
    T = init_guess[:3, 3].astype(np.float64).copy()
    ell = p.ell_init
    num_neighbors = p.nearest_neighbors_max
    ind = OracleIndicator(p.indicator_window_size)
    ind.thr = p.indicator_stable_threshold
    hist = {k: [] for k in ("ell", "step", "dist", "ip", "nonzeros", "num_neighbors")}
    ret = 0
    max_iter = max_iter or p.MAX_ITER
    k = 0
    for k in range(max_iter):
        Rinv = R.T
        Tinv = -Rinv @ T
        y_t = (y0 @ Rinv.T + Tinv).astype(np.float32)
        A = kernel_rows_capped(p, ell, x, y_t, xf, yf, num_neighbors)
        nonzeros = int((A > 0).sum())
        # flow (compute_flow_gpu_no_eigen)
        s = A.sum(1)
        w = A @ y_t
        omega = np.cross(x, w).sum(0) / p.c
        v = (w - s[:, None] * x).sum(0) / p.d
        joint = np.concatenate([omega, v])
        jn = np.linalg.norm(joint)
        unit = joint / jn if jn > 0 else joint
        # step size (compute_step_size_*)
        W = np.array([[0, -unit[2], unit[1]], [unit[2], 0, -unit[0]], [-unit[1], unit[0], 0]])
        vv = unit[3:]
        xiz = y_t @ W.T + vv
        xi2z = y_t @ (W @ W).T + W @ vv
        xi3z = y_t @ (W @ W @ W).T + W @ W @ vv
        xi4z = y_t @ (W @ W @ W @ W).T + W @ W @ W @ vv
        normxiz2 = (xiz**2).sum(1)
        xdx2 = -(xiz * xi2z).sum(1)
        epsc = (xi2z**2).sum(1) + 2 * (xiz * xi3z).sum(1)
        lcol = ((np.linalg.norm(x, axis=1) / 500.0 + 1.0) * ell) if p.is_using_range_ell \
            else np.full(len(x), ell)
        coef = (1.0 / (2 * lcol * lcol))[:, None]
        diff_dot = lambda q, yd: x @ q.T - yd[None, :]
        b_ = -2.0 * coef * diff_dot(xiz, (y_t * xiz).sum(1))
        g_ = -coef * (normxiz2[None, :] + 2.0 * diff_dot(xi2z, (y_t * xi2z).sum(1)))
        d_ = 2.0 * coef * (xdx2[None, :] - diff_dot(xi3z, (y_t * xi3z).sum(1)))
        e_ = -coef * (epsc[None, :] + 2.0 * diff_dot(xi4z, (y_t * xi4z).sum(1)))
        B = float((A * b_).sum())
        C = float((A * (g_ + b_**2 / 2)).sum())
        D = float((A * (d_ + b_ * g_ + b_**3 / 6)).sum())
        E = float((A * (e_ + b_ * d_ + b_**2 * g_ / 2 + g_**2 / 2 + b_**4 / 24)).sum())
        roots = np.roots([4 * E, 3 * D, 2 * C, B]) if any(abs(c) > 0 for c in (E, D, C)) else []
        temp = np.inf
        for r in roots:
            if r.real > 0 and r.real < temp and abs(r.imag) < 1e-5:
                temp = r.real
        step = float(np.clip(temp, p.min_step, p.max_step))
        # breaks
        if np.linalg.norm(unit[:3]) < p.eps and np.linalg.norm(unit[3:]) < p.eps:
            if jn < 1e-8:
                ret = -1
            break
        dR, dT = se3_exp_ref(unit.astype(np.float32), step)
        T = R @ dT + T
        R = R @ dR
        dist = step  # == ||log(exp(step*unit))|| for unit twist
        ip_curr = nonzeros / np.sqrt(len(x) * len(y0))
        decrease = ind.update(np.float32(ip_curr))
        hist["ell"].append(ell)
        hist["step"].append(step)
        hist["dist"].append(dist)
        hist["ip"].append(ip_curr)
        hist["nonzeros"].append(nonzeros)
        hist["num_neighbors"].append(num_neighbors)
        if collect is not None:
            collect(k, R, T)
        if dist < p.eps_2:
            break
        if k > p.ell_decay_start and decrease:
            ell = max(ell * p.ell_decay_rate, p.ell_min)
        max_row = int((A > 0).sum(1).max())
        num_neighbors = min(p.nearest_neighbors_max, int(max_row * 1.2))
    Rf = R.T
    Tf = -Rf @ T
    out = np.eye(4)
    out[:3, :3] = Rf
    out[:3, 3] = Tf
    return out, ret, hist
