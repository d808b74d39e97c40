"""Fused pairwise-kernel reductions — the N x M hot path, in blocked jnp.

This re-designs the reference's sparse-ELL kernel pipeline
(fill_in_A_mat_gpu, CvoGPU.cu:477-593; compute_flow, :729-848;
compute_step_size_*, :953-1164) as *streaming dense-block reductions*: the
kernel matrix A is never materialized. Every quantity the align loop needs is
of the form sum_ij A_ij * g(x_i, y_j), so each (source x target-chunk) block
computes its A tile and immediately reduces it:

  * flow:  row sums s_i = sum_j A_ij and the matmul w_i = sum_j A_ij y_j give
    omega = sum_i x_i cross w_i / c and v = sum_i (w_i - s_i x_i) / d —
    exactly compute_flow_gpu_no_eigen's per-row accumulation, as a matmul.
  * step coefficients B,C,D,E: per-pair beta/gamma/delta/epsilon are built
    from four dot-product matrices X @ xi{1..4}z^T minus per-column scalars,
    then combined elementwise (compute_step_size_poly_coeff semantics).

Unlike the reference we apply no `num_neighbors` row cap: the cap is a CUDA
memory-format artifact (first-K-in-scan-order truncation of the ELL matrix,
CvoGPU.cu:576-589); the dense streaming form keeps *all* pairs above
sp_thres, which can only improve the registration. The nonzero count that
feeds the lengthscale indicator counts the same thresholded entries.

The geometric lengthscale is range-scaled per source point
l_i = (|x_i|/500 + 1) * ell unconditionally, as in fill_in_A_mat_gpu
(CvoGPU.cu:87-90, 507); the step-size pass range-scales only when
is_using_range_ell (CvoGPU.cu:1035-1038).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from unified_cvo_tpu.ops import lie
from unified_cvo_tpu.utils.pointcloud import PointCloud

DEFAULT_CHUNK = 2048


def _mm(a, b):
    """f32-exact matmul. On a GPU an f32 dot left at the default precision
    may run in TF32 (~3 decimal digits), and the kernel/flow/step math
    cancels catastrophically at that precision (e.g. the A @ y flow
    accumulation: ~0.05% rounding of 30 m coordinates is ~1.5 cm noise on
    a cm-scale signal), so every reduction here pins HIGHEST."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def range_ell(ell, dist_to_sensor):
    """compute_range_ell (reference CvoGPU.cu:87-90)."""
    return (dist_to_sensor / 500.0 + 1.0) * ell


def pad_cloud_to_multiple(pc: PointCloud, multiple: int) -> PointCloud:
    """Zero-pad (mask=0) a cloud so capacity % multiple == 0. Static shapes,
    so this is free to call inside jit."""
    n = pc.capacity
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return pc
    extra = target - n

    def pad(a):
        if a is None:
            return None
        width = [(0, extra)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, width)

    return PointCloud(
        xyz=pad(pc.xyz),
        mask=pad(pc.mask),
        features=pad(pc.features),
        labels=pad(pc.labels),
        geometric_types=pad(pc.geometric_types),
    )


def _slice_cloud(pc: PointCloud, start, size):
    def sl(a):
        return None if a is None else lax.dynamic_slice_in_dim(a, start, size, axis=0)

    return PointCloud(
        xyz=sl(pc.xyz),
        mask=sl(pc.mask),
        features=sl(pc.features),
        labels=sl(pc.labels),
        geometric_types=sl(pc.geometric_types),
    )


def kernel_block(params, ell, x: PointCloud, yb: PointCloud):
    """One [I, J] tile of the sparsified kernel matrix A.

    Transcribes the per-pair math of fill_in_A_mat_gpu (CvoGPU.cu:477-593):
    geometric SE kernel with range-scaled lengthscale, color kernel, semantic
    kernel, geometric-type cosine^2 gate, each with its own distance gate,
    then the sp_thres sparsification. Gated/masked entries are exactly 0.
    """
    f32 = jnp.float32
    xp, yp = x.xyz, yb.xyz
    I, J = xp.shape[0], yp.shape[0]
    a = jnp.ones((I, J), f32)
    ok = (x.mask[:, None] > 0) & (yb.mask[None, :] > 0)
    sp = f32(params.sp_thres)

    if params.is_using_geometric_type:
        xg, yg = x.geometric_types, yb.geometric_types
        dot = _mm(xg, yg.T)
        n2x = jnp.sum(xg * xg, -1)[:, None]
        n2y = jnp.sum(yg * yg, -1)[None, :]
        geo = dot * dot / jnp.maximum(n2x * n2y, 1e-12)
        ok &= geo >= 0.01  # gate (CvoGPU.cu:541-542)
        a = a * geo

    if params.is_using_geometry:
        sigma2 = f32(params.sigma) ** 2
        # explicit coordinate differences: no |x|^2 cancellation at small d2
        d2 = jnp.zeros((I, J), f32)
        for c in range(3):
            diff = xp[:, c : c + 1] - yp[None, :, c]
            d2 = d2 + diff * diff
        l_i = range_ell(ell, jnp.linalg.norm(xp, axis=-1))[:, None]
        two_l2 = 2.0 * l_i * l_i
        d2_thres = -two_l2 * jnp.log(sp / sigma2)
        ok &= d2 < d2_thres
        a = a * sigma2 * jnp.exp(-d2 / two_l2)

    if params.is_using_intensity:
        xf, yf = x.features, yb.features
        c_ell2 = f32(params.c_ell) ** 2
        c_sigma2 = f32(params.c_sigma) ** 2
        d2c = (
            jnp.sum(xf * xf, -1)[:, None]
            + jnp.sum(yf * yf, -1)[None, :]
            - 2.0 * _mm(xf, yf.T)
        )
        d2c = jnp.maximum(d2c, 0.0)
        d2c_thres = -2.0 * c_ell2 * jnp.log(sp / c_sigma2)
        ok &= d2c < d2c_thres
        a = a * c_sigma2 * jnp.exp(-d2c / (2.0 * c_ell2))

    if params.is_using_semantics:
        xl, yl = x.labels, yb.labels
        s_ell2 = f32(params.s_ell) ** 2
        s_sigma2 = f32(params.s_sigma) ** 2
        d2s = (
            jnp.sum(xl * xl, -1)[:, None]
            + jnp.sum(yl * yl, -1)[None, :]
            - 2.0 * _mm(xl, yl.T)
        )
        d2s = jnp.maximum(d2s, 0.0)
        d2s_thres = -2.0 * s_ell2 * jnp.log(sp / s_sigma2)
        ok &= d2s < d2s_thres
        a = a * s_sigma2 * jnp.exp(-d2s / (2.0 * s_ell2))

    # materialize the tile once: every caller feeds it to several
    # reductions/matmuls, and without the barrier XLA re-fuses this whole
    # exp-heavy chain into each consumer (same effect as in
    # neighbors.flow_stats_ell)
    return lax.optimization_barrier(jnp.where(ok & (a > sp), a, 0.0))


def kernel_block_dense(params, kernel_inv, x: PointCloud, yb: PointCloud):
    """Non-isotropic (Mahalanobis) kernel tile
    (fill_in_A_mat_gpu_dense_mat_kernel, CvoGPU.cu:217-327):
    k = sigma^2 exp(-(x-y)^T K^{-1} (x-y) / 2), no geometric distance gate;
    color/semantic/geometric-type channels identical to the isotropic path."""
    f32 = jnp.float32
    xp, yp = x.xyz, yb.xyz
    I, J = xp.shape[0], yp.shape[0]
    a = jnp.ones((I, J), f32)
    ok = (x.mask[:, None] > 0) & (yb.mask[None, :] > 0)
    sp = f32(params.sp_thres)

    if params.is_using_geometric_type:
        xg, yg = x.geometric_types, yb.geometric_types
        dot = _mm(xg, yg.T)
        n2 = jnp.sum(xg * xg, -1)[:, None] * jnp.sum(yg * yg, -1)[None, :]
        geo = dot * dot / jnp.maximum(n2, 1e-12)
        ok &= geo >= 0.01
        a = a * geo

    if params.is_using_geometry:
        sigma2 = f32(params.sigma) ** 2
        K = jnp.asarray(kernel_inv, f32)
        # d2 = sum_ab K[a,b] (x_a - y_a)(x_b - y_b), expanded into x/y terms
        d2 = jnp.zeros((I, J), f32)
        for p in range(3):
            for q in range(3):
                d2 = d2 + K[p, q] * (
                    (xp[:, p : p + 1] - yp[None, :, p])
                    * (xp[:, q : q + 1] - yp[None, :, q])
                )
        a = a * sigma2 * jnp.exp(-d2 / 2.0)

    if params.is_using_intensity:
        xf, yf = x.features, yb.features
        c_ell2 = f32(params.c_ell) ** 2
        c_sigma2 = f32(params.c_sigma) ** 2
        d2c = jnp.maximum(
            jnp.sum(xf * xf, -1)[:, None] + jnp.sum(yf * yf, -1)[None, :]
            - 2.0 * _mm(xf, yf.T),
            0.0,
        )
        ok &= d2c < -2.0 * c_ell2 * jnp.log(sp / c_sigma2)
        a = a * c_sigma2 * jnp.exp(-d2c / (2.0 * c_ell2))

    if params.is_using_semantics:
        xl, yl = x.labels, yb.labels
        s_ell2 = f32(params.s_ell) ** 2
        s_sigma2 = f32(params.s_sigma) ** 2
        d2s = jnp.maximum(
            jnp.sum(xl * xl, -1)[:, None] + jnp.sum(yl * yl, -1)[None, :]
            - 2.0 * _mm(xl, yl.T),
            0.0,
        )
        ok &= d2s < -2.0 * s_ell2 * jnp.log(sp / s_sigma2)
        a = a * s_sigma2 * jnp.exp(-d2s / (2.0 * s_ell2))

    # materialize the tile once: every caller feeds it to several
    # reductions/matmuls, and without the barrier XLA re-fuses this whole
    # exp-heavy chain into each consumer (same effect as in
    # neighbors.flow_stats_ell)
    return lax.optimization_barrier(jnp.where(ok & (a > sp), a, 0.0))


def association_topk_dense(params, kernel_inv, x: PointCloud, y_t: PointCloud,
                           k: int, chunk: int = DEFAULT_CHUNK):
    """Top-k association under the non-isotropic kernel
    (compute_association_gpu 3x3-kernel overload, CvoGPU.cu:1908-1995)."""
    chunk = min(chunk, y_t.capacity)
    y_t = pad_cloud_to_multiple(y_t, chunk)
    M = y_t.capacity
    nchunks = M // chunk
    N = x.capacity

    def body(c, carry):
        vals, idx = carry
        lo = c * chunk
        yb = _slice_cloud(y_t, lo, chunk)
        a = kernel_block_dense(params, kernel_inv, x, yb)
        cols = lo + jax.lax.broadcasted_iota(jnp.int32, (N, chunk), 1)
        cand_vals = jnp.concatenate([vals, a], axis=1)
        cand_idx = jnp.concatenate([idx, cols], axis=1)
        vals, sel = lax.top_k(cand_vals, k)
        idx = jnp.take_along_axis(cand_idx, sel, axis=1)
        return vals, idx

    init = (jnp.zeros((N, k), jnp.float32), jnp.full((N, k), -1, jnp.int32))
    vals, idx = lax.fori_loop(0, nchunks, body, init)
    return vals, jnp.where(vals > 0, idx, -1)


def least_square_flow(params, ell, x: PointCloud, y_t: PointCloud,
                      chunk: int = DEFAULT_CHUNK, dist_gate: float = 0.2):
    """Gauss-Newton 6x6 flow (the is_using_least_square alternative path,
    fill_in_residual_and_jacobian + compute_flow_least_square,
    CvoGPU.cu:851-951): weighted point-to-point residuals r = (x-y)/ell with
    J = [-y^x I]/ell, pairs gated at ||x-y|| < dist_gate. Reduced via
    kernel-weighted moments; returns (omega, v) = -H^{-1} b.

    (The reference kernel aborts a whole row at the first far pair — an
    evident bug; we gate per pair.)"""
    chunk = min(chunk, y_t.capacity)
    y_t = pad_cloud_to_multiple(y_t, chunk)
    M = y_t.capacity
    nchunks = M // chunk

    def body(c, carry):
        S, m_y, M_yy, cr, dsum = carry
        yb = _slice_cloud(y_t, c * chunk, chunk)
        a = kernel_block(params, ell, x, yb)
        d2 = jnp.zeros_like(a)
        for k in range(3):
            diff = x.xyz[:, k : k + 1] - yb.xyz[None, :, k]
            d2 = d2 + diff * diff
        a = jnp.where(d2 < dist_gate * dist_gate, a, 0.0)
        S = S + jnp.sum(a)
        col_w = jnp.sum(a, axis=0)          # per-target total weight
        row_w = jnp.sum(a, axis=1)
        m_y = m_y + _mm(col_w[None, :], yb.xyz)[0]
        M_yy = M_yy + _mm((yb.xyz * col_w[:, None]).T, yb.xyz)
        # cross terms: sum_ij a x_i y_j^T and sum_ij a x_i
        Ay = _mm(a, yb.xyz)                      # [N,3]
        cr = cr + _mm(x.xyz.T, Ay)               # sum a x y^T
        dsum = dsum + jnp.stack(
            [jnp.sum(row_w * x.xyz[:, k]) for k in range(3)]
        )
        return S, m_y, M_yy, cr, dsum

    z = jnp.zeros
    S, m_y, M_yy, M_xy, m_x = lax.fori_loop(
        0, nchunks, body,
        (z((), jnp.float32), z((3,), jnp.float32), z((3, 3), jnp.float32),
         z((3, 3), jnp.float32), z((3,), jnp.float32)),
    )
    inv_l2 = 1.0 / (ell * ell)
    I3 = jnp.eye(3, dtype=jnp.float32)
    # H = 1/l^2 [ sum a (|y|^2 I - y y^T), sum a y^x ; -sum a y^x, S I ]
    H_tl = (jnp.trace(M_yy) * I3 - M_yy) * inv_l2
    my_hat = lie.skew(m_y) * inv_l2
    H = jnp.block([[H_tl, my_hat], [-my_hat, S * I3 * inv_l2]])
    # b = 1/l^2 [ sum a y x (x - y) -> y cross x ; sum a (x - y) ]
    cross = jnp.stack(
        [M_xy[2, 1] - M_xy[1, 2], M_xy[0, 2] - M_xy[2, 0], M_xy[1, 0] - M_xy[0, 1]]
    )  # sum a (y cross x)
    b = jnp.concatenate([cross, m_x - m_y]) * inv_l2
    eps = jnp.linalg.solve(H + 1e-8 * jnp.eye(6), -b)
    return eps[:3], eps[3:]


def weighted_d2_sum(params, ell, x: PointCloud, y: PointCloud, chunk: int = DEFAULT_CHUNK):
    """(sum_ij A_ij * d2_ij, nonzeros) over the kernel support — the
    ingredients of the adaptive-ell gradient (reference AdaptiveCvoGPU.cu
    compute_flow_gpu_no_eigen dl accumulation, :548-720). d2 is the
    geometric squared distance (sum_diff_*_2 in the reference)."""
    chunk = min(chunk, y.capacity)
    y = pad_cloud_to_multiple(y, chunk)
    M = y.capacity
    nchunks = M // chunk

    def body(c, carry):
        acc, cnt = carry
        yb = _slice_cloud(y, c * chunk, chunk)
        a = kernel_block(params, ell, x, yb)
        d2 = jnp.zeros_like(a)
        for k in range(3):
            diff = x.xyz[:, k : k + 1] - yb.xyz[None, :, k]
            d2 = d2 + diff * diff
        acc = acc + jnp.sum(a * d2)
        cnt = cnt + jnp.sum(a > 0)
        return acc, cnt

    return lax.fori_loop(
        0, nchunks, body, (jnp.zeros((), jnp.float32), jnp.zeros((), jnp.int32))
    )


class FlowStats(NamedTuple):
    row_sum: jax.Array    # [N]   s_i = sum_j A_ij
    row_wy: jax.Array     # [N,3] w_i = sum_j A_ij y_j
    nonzeros: jax.Array   # scalar count of A_ij > sp_thres
    a_sum: jax.Array      # scalar sum of A (the RKHS inner product value)


def flow_stats(params, ell, x: PointCloud, y_t: PointCloud, chunk: int = DEFAULT_CHUNK) -> FlowStats:
    """Streaming pass 1: kernel row statistics over target chunks."""
    chunk = min(chunk, y_t.capacity)
    y_t = pad_cloud_to_multiple(y_t, chunk)
    M = y_t.capacity
    nchunks = M // chunk
    N = x.capacity

    def body(c, carry):
        s, w, cnt, asum = carry
        yb = _slice_cloud(y_t, c * chunk, chunk)
        a = kernel_block(params, ell, x, yb)
        s = s + jnp.sum(a, axis=1)
        w = w + _mm(a, yb.xyz)
        cnt = cnt + jnp.sum(a > 0)
        asum = asum + jnp.sum(a)
        return s, w, cnt, asum

    init = (
        jnp.zeros((N,), jnp.float32),
        jnp.zeros((N, 3), jnp.float32),
        jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.float32),
    )
    s, w, cnt, asum = lax.fori_loop(0, nchunks, body, init)
    return FlowStats(s, w, cnt, asum)


def flow_from_stats(params, x: PointCloud, stats: FlowStats, psum_axis=None):
    """se(3) gradient flow (reference compute_flow, CvoGPU.cu:729-848).

    Returns (unit_twist [6], joint_norm) where unit_twist = [omega, v]
    jointly normalized; joint_norm is the pre-normalization magnitude used
    for the degeneracy test.

    psum_axis: when x is a source-point SHARD (ring-sharded full align),
    the row reduction covers only the local rows; the joint 6-vector is
    psum'd over the axis before normalization.
    """
    omega = jnp.sum(jnp.cross(x.xyz, stats.row_wy), axis=0) / params.c
    v = jnp.sum(stats.row_wy - stats.row_sum[:, None] * x.xyz, axis=0) / params.d
    joint = jnp.concatenate([omega, v])
    if psum_axis is not None:
        joint = lax.psum(joint, psum_axis)
    jn = jnp.linalg.norm(joint)
    unit = joint / jnp.where(jn < 1e-30, 1.0, jn)
    return unit, jn


def step_coeffs(
    params, ell, x: PointCloud, y_t: PointCloud, twist, chunk: int = DEFAULT_CHUNK
):
    """Streaming pass 2: quartic Taylor coefficients B, C, D, E.

    Transcribes compute_step_size_xi + compute_step_size_poly_coeff
    (CvoGPU.cu:953-1082). The per-pair dot products xi{1..4}z_j . (x_i - y_j)
    decompose as X @ xi{k}z^T - diag-broadcast, so each tile is four thin
    matmuls plus VPU polynomial evaluation, reduced in place.
    """
    chunk = min(chunk, y_t.capacity)
    y_t = pad_cloud_to_multiple(y_t, chunk)
    omega, v = twist[:3], twist[3:]
    W = lie.skew(omega)
    W2, W3 = W @ W, W @ W @ W
    W4 = W2 @ W2
    y = y_t.xyz
    # per-target-point flow derivatives (compute_step_size_xi)
    xiz = y @ W.T + v
    xi2z = y @ W2.T + W @ v
    xi3z = y @ W3.T + W2 @ v
    xi4z = y @ W4.T + W3 @ v
    normxiz2 = jnp.sum(xiz * xiz, -1)
    xdx2 = -jnp.sum(xiz * xi2z, -1)
    epsc = jnp.sum(xi2z * xi2z, -1) + 2.0 * jnp.sum(xiz * xi3z, -1)
    # per-j dots with y_j (the "- y_j part" of the pair dot)
    ydot1 = jnp.sum(y * xiz, -1)
    ydot2 = jnp.sum(y * xi2z, -1)
    ydot3 = jnp.sum(y * xi3z, -1)
    ydot4 = jnp.sum(y * xi4z, -1)

    xp = x.xyz
    if params.is_using_range_ell:
        l_i = range_ell(ell, jnp.linalg.norm(xp, axis=-1))
    else:
        l_i = jnp.full((x.capacity,), ell, jnp.float32)
    coef = (1.0 / (2.0 * l_i * l_i))[:, None]  # 1/(2 l^2), [N,1]

    M = y_t.capacity
    nchunks = M // chunk

    def body(c, carry):
        B, C, D, E = carry
        lo = c * chunk
        yb = _slice_cloud(y_t, lo, chunk)
        a = kernel_block(params, ell, x, yb)
        sl = lambda arr: lax.dynamic_slice_in_dim(arr, lo, chunk, axis=0)
        d1 = _mm(xp, sl(xiz).T) - sl(ydot1)[None, :]
        d2_ = _mm(xp, sl(xi2z).T) - sl(ydot2)[None, :]
        d3 = _mm(xp, sl(xi3z).T) - sl(ydot3)[None, :]
        d4 = _mm(xp, sl(xi4z).T) - sl(ydot4)[None, :]
        beta = -2.0 * coef * d1
        gamma = -coef * (sl(normxiz2)[None, :] + 2.0 * d2_)
        delta = 2.0 * coef * (sl(xdx2)[None, :] - d3)
        epsil = -coef * (sl(epsc)[None, :] + 2.0 * d4)
        b2 = beta * beta
        B = B + jnp.sum(a * beta)
        C = C + jnp.sum(a * (gamma + 0.5 * b2))
        D = D + jnp.sum(a * (delta + beta * gamma + b2 * beta / 6.0))
        E = E + jnp.sum(
            a
            * (
                epsil
                + beta * delta
                + 0.5 * b2 * gamma
                + 0.5 * gamma * gamma
                + b2 * b2 / 24.0
            )
        )
        return B, C, D, E

    zero = jnp.zeros((), jnp.float32)
    return lax.fori_loop(0, nchunks, body, (zero, zero, zero, zero))


def association_topk(
    params, ell, x: PointCloud, y_t: PointCloud, k: int, chunk: int = DEFAULT_CHUNK
):
    """Per-source-row top-k kernel entries: (values [N,k], target idx [N,k]).

    Static-shape replacement for the reference's sparse Association export
    (compute_association_gpu, CvoGPU.cu:1876-1995): fixed-width rows with
    value 0 / index -1 padding instead of an Eigen sparse matrix.
    """
    chunk = min(chunk, y_t.capacity)
    y_t = pad_cloud_to_multiple(y_t, chunk)
    M = y_t.capacity
    nchunks = M // chunk
    N = x.capacity

    def body(c, carry):
        vals, idx = carry
        lo = c * chunk
        yb = _slice_cloud(y_t, lo, chunk)
        a = kernel_block(params, ell, x, yb)
        cols = lo + jax.lax.broadcasted_iota(jnp.int32, (N, chunk), 1)
        cand_vals = jnp.concatenate([vals, a], axis=1)
        cand_idx = jnp.concatenate([idx, cols], axis=1)
        vals, sel = lax.top_k(cand_vals, k)
        idx = jnp.take_along_axis(cand_idx, sel, axis=1)
        return vals, idx

    init = (
        jnp.zeros((N, k), jnp.float32),
        jnp.full((N, k), -1, jnp.int32),
    )
    vals, idx = lax.fori_loop(0, nchunks, body, init)
    idx = jnp.where(vals > 0, idx, -1)
    return vals, idx
