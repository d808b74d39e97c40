"""Plain-NumPy oracles transcribed from the reference CUDA kernels.

These loops follow fill_in_A_mat_gpu (CvoGPU.cu:477-593),
compute_flow_gpu_no_eigen (:729-790), compute_step_size_xi /
compute_step_size_poly_coeff (:953-1082) literally (minus the ELL
num_neighbors row cap, which this build intentionally drops), so the
blocked jnp implementations can be validated element-by-element.
"""

import numpy as np


def oracle_kernel_matrix(p, ell, x, y, xf=None, yf=None, xl=None, yl=None,
                         xg=None, yg=None):
    N, M = len(x), len(y)
    A = np.zeros((N, M))
    sigma2 = p.sigma**2
    c2 = p.c_ell**2
    c_sigma2 = p.c_sigma**2
    s_ell = p.s_ell
    s_sigma2 = p.s_sigma**2
    for i in range(N):
        l = (np.linalg.norm(x[i]) / 500.0 + 1.0) * ell
        d2_thres = -2.0 * l * l * np.log(p.sp_thres / sigma2)
        d2_c_thres = -2.0 * c2 * np.log(p.sp_thres / c_sigma2) if p.is_using_intensity else 1
        d2_s_thres = -2.0 * s_ell * s_ell * np.log(p.sp_thres / s_sigma2) if p.is_using_semantics else 1
        for j in range(M):
            a, k, ck, sk, geo = 1.0, 1.0, 1.0, 1.0, 1.0
            if p.is_using_geometric_type:
                dot = float(np.dot(xg[i], yg[j]))
                geo = dot * dot / (np.dot(xg[i], xg[i]) * np.dot(yg[j], yg[j]))
                if geo < 0.01:
                    continue
            if p.is_using_geometry:
                d2 = float(np.sum((x[i] - y[j]) ** 2))
                if d2 < d2_thres:
                    k = sigma2 * np.exp(-d2 / (2.0 * l * l))
                else:
                    continue
            if p.is_using_intensity:
                d2c = float(np.sum((xf[i] - yf[j]) ** 2))
                if d2c < d2_c_thres:
                    ck = c_sigma2 * np.exp(-d2c / (2.0 * c2))
                else:
                    continue
            if p.is_using_semantics:
                d2s = float(np.sum((xl[i] - yl[j]) ** 2))
                if d2s < d2_s_thres:
                    sk = s_sigma2 * np.exp(-d2s / (2.0 * s_ell * s_ell))
                else:
                    continue
            a = k * ck * sk * geo
            if a > p.sp_thres:
                A[i, j] = a
    return A


def oracle_flow(p, A, x, y):
    omega = np.zeros(3)
    v = np.zeros(3)
    for i in range(len(x)):
        for j in range(len(y)):
            if A[i, j] > 0:
                omega += A[i, j] * np.cross(x[i], y[j])
                v += A[i, j] * (y[j] - x[i])
    omega /= p.c
    v /= p.d
    joint = np.concatenate([omega, v])
    n = np.linalg.norm(joint)
    return joint / n if n > 0 else joint, n


def oracle_step_coeffs(p, A, ell, x, y, omega, v):
    def skew(w):
        return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])

    W = skew(omega)
    B = C = D = E = 0.0
    xiz = y @ W.T + v
    xi2z = y @ (W @ W).T + W @ v
    xi3z = y @ (W @ W @ W).T + W @ W @ v
    xi4z = y @ (W @ W @ W @ W).T + W @ W @ W @ v
    normxiz2 = np.sum(xiz**2, 1)
    xdx2 = -np.sum(xiz * xi2z, 1)
    epsc = np.sum(xi2z**2, 1) + 2 * np.sum(xiz * xi3z, 1)
    for i in range(len(x)):
        temp_ell = (np.linalg.norm(x[i]) / 500.0 + 1.0) * ell if p.is_using_range_ell else ell
        coef = 1.0 / (2.0 * temp_ell * temp_ell)
        for j in range(len(y)):
            if A[i, j] <= 0:
                continue
            d = x[i] - y[j]
            beta = -2.0 * coef * float(np.dot(xiz[j], d))
            gamma = -coef * (normxiz2[j] + 2.0 * float(np.dot(xi2z[j], d)))
            delta = 2.0 * coef * (xdx2[j] - float(np.dot(xi3z[j], d)))
            epsil = -coef * (epsc[j] + 2.0 * float(np.dot(xi4z[j], d)))
            B += A[i, j] * beta
            C += A[i, j] * (gamma + beta**2 / 2.0)
            D += A[i, j] * (delta + beta * gamma + beta**3 / 6.0)
            E += A[i, j] * (
                epsil + beta * delta + beta**2 * gamma / 2.0 + gamma**2 / 2.0 + beta**4 / 24.0
            )
    return B, C, D, E


class OracleIndicator:
    """Literal std::queue transcription of A_sparsity_indicator_ell_update
    (CvoGPU.cu:1167-1285), including the double-push boundary quirks."""

    def __init__(self, window):
        self.W = window
        self.start = []
        self.end = []
        self.ssum = 0.0
        self.esum = 0.0

    def update(self, ind):
        decrease = False
        if len(self.start) < self.W:
            self.start.append(ind)
            self.ssum += ind
        if len(self.start) >= self.W and len(self.end) < self.W:
            self.end.append(ind)
            self.esum += ind
        if len(self.start) >= self.W and len(self.end) >= self.W:
            ratio = self.esum / self.ssum
            thr = self.thr
            if 1 - thr < ratio < 1 + thr:
                decrease = True
                self.start, self.end = [], []
                self.ssum = self.esum = 0.0
            else:
                f = self.end.pop(0)
                self.esum -= f
                self.ssum += f
                self.start.append(f)
                self.ssum -= self.start.pop(0)
                self.end.append(ind)
                self.esum += ind
        return decrease


def oracle_dense_moments(p, ell, x, y, twists=(), rows=256, xf=None, yf=None,
                         near_rel=1e-3):
    """Row-chunked float64 NumPy version of the three loops above, for
    clouds too large for them (16k x 16k): the same kernel gates
    (geometric and intensity channels) evaluated for every pair, then the
    flow moments and step coefficients summed over the pairs that pass.

    Pairs whose kernel value lies within `near_rel` (relative) of sp_thres
    are "near": an f32 evaluation may gate them either way. Returns a dict
    with a_sum, nonzeros, near (their count), the unit twist and its norm,
    flow_mag (the size of the terms the flow is a difference of),
    near_flow (a bound on how far the near pairs can move the unnormalized
    flow), and per entry of `twists` (each a unit twist [omega, v] to take
    the step along) the coefficients (B, C, D, E) in `steps`, the sums of
    their terms' magnitudes sum A|term| in `steps_abs`, and the same sums
    over the near pairs in `steps_near`."""
    assert not (p.is_using_semantics or p.is_using_geometric_type)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    sigma2 = p.sigma ** 2
    sp = p.sp_thres
    I, J, Av, Pv, Nv = [], [], [], [], []
    for lo in range(0, len(x), rows):
        xb = x[lo:lo + rows]
        l = (np.linalg.norm(xb, axis=1) / 500.0 + 1.0) * ell      # [r]
        d2 = sum((xb[:, None, c] - y[None, :, c]) ** 2 for c in range(3))
        thres = -2.0 * l[:, None] ** 2 * np.log(sp / sigma2)
        # a slightly wider candidate set than the gate, so that pairs just
        # beyond the distance threshold are counted as near too
        ii, jj = np.nonzero(d2 < thres * (1.0 + near_rel))
        ok = d2[ii, jj] < thres[ii, 0]
        a = sigma2 * np.exp(-d2[ii, jj] / (2.0 * l[ii] ** 2))
        if p.is_using_intensity:
            d2c = np.sum((np.asarray(xf, np.float64)[lo + ii]
                          - np.asarray(yf, np.float64)[jj]) ** 2, -1)
            ok &= d2c < -2.0 * p.c_ell ** 2 * np.log(sp / p.c_sigma ** 2)
            a = a * p.c_sigma ** 2 * np.exp(-d2c / (2.0 * p.c_ell ** 2))
        near = np.abs(a - sp) <= near_rel * sp
        passing = ok & (a > sp)
        keep = passing | near
        I.append(ii[keep] + lo)
        J.append(jj[keep])
        Av.append(a[keep])
        Pv.append(passing[keep])
        Nv.append(near[keep])
    ii, jj, A = np.concatenate(I), np.concatenate(J), np.concatenate(Av)
    passing, near = np.concatenate(Pv), np.concatenate(Nv)
    xi, yj = x[ii], y[jj]
    d = xi - yj
    w = np.where(passing, A, 0.0)                 # the pairs that pass
    wn = np.where(near, A, 0.0)                   # the pairs in doubt
    cross = np.cross(xi, yj)
    omega = (w[:, None] * cross).sum(0)
    vel = (w[:, None] * (yj - xi)).sum(0)
    ny = np.linalg.norm(yj, axis=1)
    mag = [np.sum(w * np.linalg.norm(xi, axis=1) * ny), np.sum(w * ny)]
    near_flow = np.sum(wn * np.hypot(np.linalg.norm(cross, axis=1) / p.c,
                                     np.linalg.norm(d, axis=1) / p.d))
    if p.is_using_range_ell:
        ls = (np.linalg.norm(xi, axis=1) / 500.0 + 1.0) * ell
    else:
        ls = np.full(len(ii), float(ell))
    coef = 1.0 / (2.0 * ls * ls)
    steps, steps_abs, steps_near = [], [], []
    for tw in twists:
        tw = np.asarray(tw, np.float64)
        W = np.array([[0, -tw[2], tw[1]], [tw[2], 0, -tw[0]],
                      [-tw[1], tw[0], 0]])
        v = tw[3:]
        xiz = yj @ W.T + v
        xi2z = yj @ (W @ W).T + W @ v
        xi3z = yj @ (W @ W @ W).T + W @ W @ v
        xi4z = yj @ (W @ W @ W @ W).T + W @ W @ W @ v
        beta = -2.0 * coef * np.sum(xiz * d, 1)
        gamma = -coef * (np.sum(xiz ** 2, 1) + 2.0 * np.sum(xi2z * d, 1))
        delta = 2.0 * coef * (-np.sum(xiz * xi2z, 1) - np.sum(xi3z * d, 1))
        epsil = -coef * (np.sum(xi2z ** 2, 1) + 2 * np.sum(xiz * xi3z, 1)
                         + 2.0 * np.sum(xi4z * d, 1))
        terms = (beta, gamma + beta ** 2 / 2.0,
                 delta + beta * gamma + beta ** 3 / 6.0,
                 epsil + beta * delta + beta ** 2 * gamma / 2.0
                 + gamma ** 2 / 2.0 + beta ** 4 / 24.0)
        steps.append(tuple(float(np.sum(w * t)) for t in terms))
        steps_abs.append(tuple(float(np.sum(w * np.abs(t))) for t in terms))
        steps_near.append(tuple(float(np.sum(wn * np.abs(t))) for t in terms))
    joint = np.concatenate([omega / p.c, vel / p.d])
    norm = np.linalg.norm(joint)
    return dict(a_sum=float(w.sum()), nonzeros=int(passing.sum()),
                near=int(near.sum()), near_a=float(wn.sum()),
                twist=joint / norm if norm > 0 else joint, joint_norm=norm,
                flow_mag=np.hypot(mag[0] / p.c, mag[1] / p.d),
                near_flow=near_flow, steps=steps, steps_abs=steps_abs,
                steps_near=steps_near)
