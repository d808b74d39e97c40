"""Multiframe IRLS bundle adjustment — the CvoBatchIRLS twin, on device.

Reference architecture (src/cvo/IRLS.cpp:77-215): an outer IRLS loop
re-evaluates every edge's kernel matrix A (the "weights") at the current
poses, freezes it, then Ceres-solves the weighted point-to-point problem
  J(T) = sum_edges sum_pairs A_ij || T1 p1_i - T2 p2_j ||^2
with one residual object per nonzero pair (IRLS_State_GPU.cpp:10-51,
IRLS_Cost_CPU.hpp:77-182) and SPARSE_SCHUR on 24 CPU threads.

Redesign: the cost is quadratic in the *homogeneous second
moments* of each edge,
  P11 = sum A_ij h1_i h1_i^T,  P12 = sum A_ij h1_i h2_j^T,
  P22 = sum A_ij h2_j h2_j^T          (h = [p; 1], all 4x4),
because q = T h is linear in the points. One streaming kernel pass per edge
per outer iteration produces these 48 floats; every Gauss-Newton inner
iteration then builds the exact 6x6 pose-block Hessian/gradient from
{T_a P T_b^T} contractions — no per-pair residuals, no ELL device->host
copy (the reference's copy_internal_SparseKernelMat_gpu_to_cpu,
IRLS_State_GPU.cu:68, is eliminated), no Ceres. The reduced 6F x 6F system
is dense-Cholesky-solved on-device (F = #frames is small); gauge freedom is
fixed by zeroing pivot-frame rows/columns.

The outer schedule replicates IRLS.cpp:118-206: edges gated by
multiframe_min_nonzeros, ell decayed by multiframe_ell_decay_rate when
total nonzeros stop growing, convergence at multiframe_ell_min.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from unified_cvo_tpu.config import CvoParams
from unified_cvo_tpu.ops import kernels, lie
from unified_cvo_tpu.utils.pointcloud import PointCloud


class EdgeMoments(NamedTuple):
    P11: jax.Array       # [E,4,4]
    P12: jax.Array       # [E,4,4]
    P22: jax.Array       # [E,4,4]
    nonzeros: jax.Array  # [E] int32
    overflow: jax.Array  # [E] int32: ELL candidate drops (0 on the dense path)


def _homog(xyz):
    return jnp.concatenate([xyz, jnp.ones_like(xyz[..., :1])], axis=-1)


def _edge_moments_single(params, ell, c1: PointCloud, c2: PointCloud,
                         T1, T2, chunk: int) -> EdgeMoments:
    """Streaming kernel pass between two *transformed* clouds -> moments.

    T1, T2 are [3,4] row-major pose blocks (reference CvoFrame::pose_vec
    layout, CvoFrame.hpp:12-36). The kernel is evaluated at the transformed
    points, as BinaryStateGPU::update_inner_product does
    (IRLS_State_GPU.cu:43-79); the moments are over the *original* points so
    the GN can re-linearize at any pose without touching points again.
    """
    R1, t1 = T1[:, :3], T1[:, 3]
    R2, t2 = T2[:, :3], T2[:, 3]
    c1_t = c1.transformed(R1, t1)
    c2_t = c2.transformed(R2, t2)

    chunk = min(chunk, c2.capacity)
    c2_t = kernels.pad_cloud_to_multiple(c2_t, chunk)
    c2_pad = kernels.pad_cloud_to_multiple(c2, chunk)
    M = c2_t.capacity
    nchunks = M // chunk
    N = c1.capacity
    h1 = _homog(c1.xyz)                      # [N,4] original coords

    def body(c, carry):
        rs, ah2, cs, cnt = carry
        yb_t = kernels._slice_cloud(c2_t, c * chunk, chunk)
        yb = kernels._slice_cloud(c2_pad, c * chunk, chunk)
        a = kernels.kernel_block(params, ell, c1_t, yb_t)
        rs = rs + jnp.sum(a, axis=1)
        ah2 = ah2 + kernels._mm(a, _homog(yb.xyz))
        cs = cs.at[c].set(jnp.sum(a, axis=0))
        cnt = cnt + jnp.sum(a > 0)
        return rs, ah2, cs, cnt

    init = (
        jnp.zeros((N,), jnp.float32),
        jnp.zeros((N, 4), jnp.float32),
        jnp.zeros((nchunks, chunk), jnp.float32),
        jnp.zeros((), jnp.int32),
    )
    row_sum, a_h2, col_chunks, cnt = lax.fori_loop(0, nchunks, body, init)
    col_sum = col_chunks.reshape(M)
    h2 = _homog(c2_pad.xyz)
    P12 = kernels._mm(h1.T, a_h2)
    P11 = kernels._mm((h1 * row_sum[:, None]).T, h1)
    P22 = kernels._mm((h2 * col_sum[:, None]).T, h2)
    return EdgeMoments(P11, P12, P22, cnt, jnp.zeros((), jnp.int32))


def _edge_moments_single_ell(params, ell, c1: PointCloud, c2: PointCloud,
                             T1, T2, nl_k: int, nl_per_cell: int) -> EdgeMoments:
    """ELL-neighbor-list edge moments — same contract as
    _edge_moments_single, ~10x cheaper at BA sparsity.

    The candidate list is built fresh per outer iteration (the reference
    recomputes each edge's kernel matrix then too, IRLS_State_GPU.cu:43-79),
    between the TRANSFORMED clouds; the moments are over ORIGINAL
    coordinates, recovered from the list's raw gathered slots — P22 needs no
    scatter back to target indices because sum_j colsum_j h2_j h2_j^T ==
    sum_slots a * h2 h2^T evaluated slotwise."""
    from unified_cvo_tpu.ops import neighbors as nbr

    R1, t1 = T1[:, :3], T1[:, 3]
    R2, t2 = T2[:, :3], T2[:, 3]
    c1_t = c1.transformed(R1, t1)
    nl = nbr.build_neighbor_list(
        params, ell, c1_t, c2, R2, t2, k=nl_k, skin=0.0,
        per_cell_cap=nl_per_cell)
    stats, a, y_t_slots = nbr.flow_stats_ell(params, ell, c1_t, nl, R2, t2)

    h1 = _homog(c1.xyz)                                     # [N,4] original
    rs = stats.row_sum
    P11 = kernels._mm((h1 * rs[:, None]).T, h1)
    # a_h2[:, p] = sum_k a * h2_p (h2 = [raw y; 1]) — K-major [K,N] sums
    ah2 = jnp.stack(
        [jnp.sum(a * nl.y_xyz[c], axis=0) for c in range(3)] + [rs], axis=-1)
    P12 = kernels._mm(h1.T, ah2)
    # P22[p,q] = sum_slots a * h2_p h2_q, 10 unique entries
    h2 = (nl.y_xyz[0], nl.y_xyz[1], nl.y_xyz[2], None)      # None = the 1 row
    ent = {}
    for p in range(4):
        for q in range(p, 4):
            if p == 3 and q == 3:
                ent[(p, q)] = jnp.sum(a)
            elif q == 3:
                ent[(p, q)] = jnp.sum(a * h2[p])
            else:
                ent[(p, q)] = jnp.sum(a * h2[p] * h2[q])
    P22 = jnp.asarray(
        [[ent[(min(p, q), max(p, q))] for q in range(4)] for p in range(4)])
    return EdgeMoments(P11, P12, P22, stats.nonzeros, nl.overflow)


def _skew(v):
    return lie.skew(v)


def _cross_from(M):
    """vee of the antisymmetric part: sum_pairs w (q1 x q2) from M = sum w q1 q2^T."""
    return jnp.stack(
        [M[..., 1, 2] - M[..., 2, 1],
         M[..., 2, 0] - M[..., 0, 2],
         M[..., 0, 1] - M[..., 1, 0]],
        axis=-1,
    )


def _edge_blocks(P11, P12, P22, T1, T2):
    """Per-edge GN blocks under left-multiplicative updates T <- exp(xi) T.

    With q1 = T1 h1, q2 = T2 h2, residual r = q1 - q2 and jacobians
    J1 = [-q1^x I], J2 = -[-q2^x I], all weighted pair sums reduce to
    contractions of Mt_ab = T_a P_ab T_b^T (3x3), m_a = T_a P12 e4-type
    vectors, and S = P12[3,3].
    """
    M11 = T1 @ P11 @ T1.T                    # sum w q1 q1^T
    M12 = T1 @ P12 @ T2.T                    # sum w q1 q2^T
    M22 = T2 @ P22 @ T2.T
    m1 = T1 @ P12[:, 3]                      # sum w q1  (pair-summed)
    m2 = T2 @ P12[3, :]                      # sum w q2
    S = P12[3, 3]
    I3 = jnp.eye(3, dtype=P11.dtype)

    def hat(v):
        return _skew(v)

    H_aa = jnp.block(
        [[jnp.trace(M11) * I3 - M11, hat(m1)], [-hat(m1), S * I3]]
    )
    H_bb = jnp.block(
        [[jnp.trace(M22) * I3 - M22, hat(m2)], [-hat(m2), S * I3]]
    )
    H_ab = jnp.block(
        [[M12.T - jnp.trace(M12) * I3, -hat(m1)], [hat(m2), -S * I3]]
    )
    cr = _cross_from(M12)
    b_a = jnp.concatenate([-cr, m1 - m2])
    b_b = -b_a
    cost = jnp.trace(M11) - 2.0 * jnp.trace(M12) + jnp.trace(M22)
    return H_aa, H_bb, H_ab, b_a, b_b, cost


def _assemble_system(poses, edge_i, edge_j, moments: EdgeMoments, edge_active):
    """Build the (partial) 6F x 6F GN system from an edge (sub)set.

    Returns (H [F,6,F,6], b [F,6], cost). This half is psum-safe: in the
    distributed solver each device assembles its local edge shard's partial
    system, a single psum reduces (H, b, cost), and _solve_and_update runs
    replicated (parallel/sharded_irls.py)."""
    F = poses.shape[0]
    T1 = poses[edge_i]                       # [E,3,4]
    T2 = poses[edge_j]
    blocks = jax.vmap(_edge_blocks)(moments.P11, moments.P12, moments.P22, T1, T2)
    H_aa, H_bb, H_ab, b_a, b_b, costs = blocks
    w = edge_active.astype(poses.dtype)
    H_aa = H_aa * w[:, None, None]
    H_bb = H_bb * w[:, None, None]
    H_ab = H_ab * w[:, None, None]
    b_a = b_a * w[:, None]
    b_b = b_b * w[:, None]

    H = jnp.zeros((F, 6, F, 6), poses.dtype)
    H = H.at[edge_i, :, edge_i, :].add(H_aa)
    H = H.at[edge_j, :, edge_j, :].add(H_bb)
    H = H.at[edge_i, :, edge_j, :].add(H_ab)
    H = H.at[edge_j, :, edge_i, :].add(jnp.swapaxes(H_ab, -1, -2))
    b = jnp.zeros((F, 6), poses.dtype)
    b = b.at[edge_i].add(b_a)
    b = b.at[edge_j].add(b_b)
    return H, b, jnp.sum(costs * w)


def _solve_and_update(poses, H, b, pivot_mask, damping, dof_mask=None):
    """Gauge-fix the assembled system, Cholesky-solve, left-update poses.
    Returns (poses_new, |delta|)."""
    F = poses.shape[0]
    free = 1.0 - pivot_mask.astype(poses.dtype)          # [F]
    free6 = jnp.repeat(free, 6)
    if dof_mask is not None:
        free6 = free6 * jnp.tile(jnp.asarray(dof_mask, poses.dtype), F)
    Hd = H.reshape(6 * F, 6 * F)
    # gauge fix: zero pivot rows/cols, unit diagonal there (delta_pivot = 0)
    Hd = Hd * free6[:, None] * free6[None, :]
    Hd = Hd + jnp.diag(jnp.where(free6 > 0, damping, 1.0))
    bd = b.reshape(6 * F) * free6

    delta = jnp.linalg.solve(Hd, -bd).reshape(F, 6)
    delta = delta * free[:, None]

    dR, dt = lie.se3_exp(delta, 1.0)                     # [F,3,3], [F,3]
    R_new = dR @ poses[:, :, :3]
    t_new = jnp.einsum("fij,fj->fi", dR, poses[:, :, 3]) + dt
    poses_new = jnp.concatenate([R_new, t_new[:, :, None]], axis=-1)
    return poses_new, jnp.linalg.norm(delta)


def _solve_cg_blocks(F, edge_i, edge_j, H_aa, H_bb, H_ab, b, free6f,
                     damping, cg_iters, tol=1e-8):
    """Matrix-free block-sparse PCG on the GN normal equations.

    The on-device replacement for Ceres SPARSE_SCHUR at covis-graph scale
    (reference IRLS.cpp:146-159): the 6F x 6F Hessian is never
    materialized — its matvec is three batched [E,6,6]x[E,6] contractions
    plus two scatter-adds (O(E) memory), preconditioned by the inverted
    6x6 block diagonal. Solves H delta = -b with gauge/dof dims masked.

    free6f: [F,6] 1.0 on free tangent dims (pivot/dof masking).
    Returns delta [F,6]."""
    f32 = b.dtype

    def matvec(x):
        x = x * free6f
        xa = x[edge_i]
        xb = x[edge_j]
        ya = jnp.einsum("eij,ej->ei", H_aa, xa) + jnp.einsum(
            "eij,ej->ei", H_ab, xb)
        yb = jnp.einsum("eji,ej->ei", H_ab, xa) + jnp.einsum(
            "eij,ej->ei", H_bb, xb)
        y = (jnp.zeros((F, 6), f32).at[edge_i].add(ya).at[edge_j].add(yb))
        return y * free6f + damping * x

    # block-Jacobi preconditioner from the 6x6 diagonal blocks
    D = (jnp.zeros((F, 6, 6), f32).at[edge_i].add(H_aa).at[edge_j].add(H_bb))
    D = D * free6f[:, :, None] * free6f[:, None, :]
    D = D + jnp.eye(6, dtype=f32)[None] * jnp.maximum(damping, 1e-8)
    D_inv = jnp.linalg.inv(D)

    def precond(r):
        return jnp.einsum("fij,fj->fi", D_inv, r) * free6f

    rhs = -b * free6f
    x0 = jnp.zeros((F, 6), f32)
    r0 = rhs
    z0 = precond(r0)
    rz0 = jnp.sum(r0 * z0)
    thresh = tol * jnp.maximum(rz0, 1e-30)

    def cond(c):
        x, r, z, p, rz, it = c
        return (rz > thresh) & (it < cg_iters)

    def body(c):
        x, r, z, p, rz, it = c
        Ap = matvec(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return (x, r, z, p, rz_new, it + 1)

    x, *_ = lax.while_loop(cond, body, (x0, r0, z0, z0, rz0,
                                        jnp.zeros((), jnp.int32)))
    return x


def _assemble_and_solve(poses, edge_i, edge_j, moments: EdgeMoments,
                        edge_active, pivot_mask, damping, dof_mask=None,
                        solver: str = "dense", cg_iters: int = 100):
    """One GN iteration: build the 6F x 6F system from edge blocks, fix the
    gauge at pivot frames, solve, left-update the poses.

    solver: 'dense' Cholesky-solves the materialized 6F x 6F system (exact;
    right up to a few hundred frames); 'cg' runs matrix-free block-sparse
    PCG over the edge blocks (O(E) memory — the SPARSE_SCHUR-scale path
    for 100+-frame covis graphs, IRLS.cpp:146-159).

    dof_mask: optional [6] 0/1 mask over the (rot, trans) tangent dims;
    zeroed dims are frozen (the translation-only BA variant,
    main_multi_frame_irls_translation_only_tartan.cpp)."""
    if solver == "dense":
        H, b, total_cost = _assemble_system(poses, edge_i, edge_j, moments,
                                            edge_active)
        poses_new, dnorm = _solve_and_update(poses, H, b, pivot_mask, damping,
                                             dof_mask=dof_mask)
        return poses_new, total_cost, dnorm

    F = poses.shape[0]
    T1 = poses[edge_i]
    T2 = poses[edge_j]
    blocks = jax.vmap(_edge_blocks)(moments.P11, moments.P12, moments.P22,
                                    T1, T2)
    H_aa, H_bb, H_ab, b_a, b_b, costs = blocks
    w = edge_active.astype(poses.dtype)
    H_aa = H_aa * w[:, None, None]
    H_bb = H_bb * w[:, None, None]
    H_ab = H_ab * w[:, None, None]
    b = (jnp.zeros((F, 6), poses.dtype)
         .at[edge_i].add(b_a * w[:, None])
         .at[edge_j].add(b_b * w[:, None]))
    free = 1.0 - pivot_mask.astype(poses.dtype)
    free6f = jnp.tile(
        jnp.ones((6,), poses.dtype) if dof_mask is None
        else jnp.asarray(dof_mask, poses.dtype), (F, 1)) * free[:, None]
    delta = _solve_cg_blocks(F, edge_i, edge_j, H_aa, H_bb, H_ab, b, free6f,
                             damping, cg_iters)
    dR, dt = lie.se3_exp(delta, 1.0)
    R_new = dR @ poses[:, :, :3]
    t_new = jnp.einsum("fij,fj->fi", dR, poses[:, :, 3]) + dt
    poses_new = jnp.concatenate([R_new, t_new[:, :, None]], axis=-1)
    return poses_new, jnp.sum(costs * w), jnp.linalg.norm(delta)


@functools.lru_cache(maxsize=32)
def make_irls_kernels(params: CvoParams, chunk: int = 1024,
                      backend: str = "auto", nl_k: int = 128,
                      nl_per_cell: int = 32, cloud_capacity: int = 0,
                      solver: str = "dense", cg_iters: int = 100):
    """Jitted (moments, gn_iterations) closures for a fixed params object.

    Cached on the full argument tuple (params is a hashable frozen
    dataclass): rebuilding the closures per irls_solve call would give
    every solve fresh jit identities and force a full recompile.

    backend: 'auto', 'ell', or 'dense'. Unlike the pairwise align loop —
    where ONE candidate-list build amortizes over ~100 gather-free
    iterations — each BA outer iteration uses its kernel pass once, so the
    list build outweighs the vmapped dense streaming pass until clouds are
    very large. 'auto' therefore stays dense below 32k points."""
    if backend == "auto":
        from unified_cvo_tpu.ops import neighbors as nbr

        est = nbr.static_support_radius(
            params.replace(ell_init=params.multiframe_ell_init))
        backend = (
            "ell"
            if bool(params.is_using_geometry) and est <= 2.0
            and cloud_capacity >= 32768
            else "dense"
        )

    @functools.partial(jax.jit, static_argnames=())
    def moments_fn(clouds: PointCloud, poses, edge_i, edge_j, ell):
        def one(args):
            ei, ej = args
            c1 = jax.tree.map(lambda a: a[ei] if a is not None else None, clouds)
            c2 = jax.tree.map(lambda a: a[ej] if a is not None else None, clouds)
            if backend == "ell":
                return _edge_moments_single_ell(
                    params, ell, c1, c2, poses[ei], poses[ej], nl_k, nl_per_cell)
            return _edge_moments_single(params, ell, c1, c2, poses[ei], poses[ej], chunk)

        if backend == "ell":
            # sequential over edges: the per-edge grid tables are large, and
            # each edge already saturates the chip
            return lax.map(one, (edge_i, edge_j))
        return jax.vmap(one)((edge_i, edge_j))

    @functools.partial(jax.jit, static_argnames=("n_iters",))
    def gn_fn(poses, edge_i, edge_j, moments, edge_active, pivot_mask,
              n_iters: int, damping=1e-6, dof_mask=None):
        def body(carry, _):
            poses, _, _ = carry
            poses_new, cost, dnorm = _assemble_and_solve(
                poses, edge_i, edge_j, moments, edge_active, pivot_mask, damping,
                dof_mask=dof_mask, solver=solver, cg_iters=cg_iters,
            )
            return (poses_new, cost, dnorm), None

        (poses, cost, dnorm), _ = lax.scan(
            body, (poses, jnp.zeros((), poses.dtype), jnp.zeros((), poses.dtype)),
            None, length=n_iters,
        )
        return poses, cost, dnorm

    return moments_fn, gn_fn


@functools.lru_cache(maxsize=32)
def make_irls_solver(
    params: CvoParams,
    chunk: int = 1024,
    backend: str = "auto",
    cloud_capacity: int = 0,
    translation_only: bool = False,
    solver: str = "dense",
):
    """Fully on-device IRLS solve — the whole CvoBatchIRLS outer loop
    (IRLS.cpp:77-215 schedule: min-nonzeros edge gating, solve while total
    nonzeros grow, else decay ell, stop below multiframe_ell_min) inside ONE
    jitted lax.while_loop. The host-driven irls_solve keeps per-iteration
    logging/checkpointing; this variant eliminates every host round-trip
    (one sync per BA solve), for production serving.

    Returns solve(clouds, init_poses [F,3,4], edge_i [E], edge_j [E],
    pivot_mask [F]) -> (poses [F,3,4], info dict of scalars).
    """
    moments_fn, gn_fn = make_irls_kernels(
        params, chunk, backend=backend, cloud_capacity=cloud_capacity,
        solver=solver)
    dof_mask = (
        jnp.asarray([0, 0, 0, 1, 1, 1], jnp.float32) if translation_only else None
    )
    f32 = jnp.float32
    n_solve = int(params.multiframe_iterations_per_solve)

    @functools.partial(jax.jit, static_argnames=())
    def solve(clouds: PointCloud, init_poses, edge_i, edge_j, pivot_mask):
        poses0 = jnp.asarray(init_poses, f32)
        world_center = jnp.mean(poses0[:, :, 3], axis=0)
        poses0 = poses0.at[:, :, 3].add(-world_center)

        def cond(c):
            return jnp.logical_not(c["done"])

        def body(c):
            mom = moments_fn(clouds, c["poses"], edge_i, edge_j, c["ell"])
            nz = mom.nonzeros
            edge_active = nz > params.multiframe_min_nonzeros
            total = jnp.sum(nz)
            any_active = jnp.any(edge_active)
            stop_now = (~any_active) | (c["it"] >= params.multiframe_max_iters)
            do_solve = (total > c["last_nz"]) | (
                c["it"] < params.multiframe_iterations_per_ell)

            def run_solve(poses):
                p, cost, dn = gn_fn(
                    poses, edge_i, edge_j, mom, edge_active, pivot_mask,
                    n_solve, dof_mask=dof_mask)
                return p, cost

            poses_new, cost = lax.cond(
                do_solve & ~stop_now, run_solve,
                lambda p: (p, c["cost"]), c["poses"])
            can_decay = c["ell"] >= params.multiframe_ell_min
            decay_now = ~stop_now & ~do_solve & can_decay
            ell_new = jnp.where(
                decay_now, c["ell"] * params.multiframe_ell_decay_rate,
                c["ell"])
            last_new = jnp.where(
                ~stop_now & do_solve, total.astype(jnp.int32),
                jnp.where(decay_now, 0, c["last_nz"]))
            done = stop_now | (~do_solve & ~can_decay)
            return {
                "poses": poses_new, "ell": ell_new,
                "last_nz": last_new, "it": c["it"] + 1,
                "done": done, "cost": cost,
                "nonzeros": total.astype(jnp.int32),
                "overflow": c["overflow"] + jnp.sum(mom.overflow),
            }

        init = {
            "poses": poses0, "ell": jnp.asarray(params.multiframe_ell_init, f32),
            "last_nz": jnp.zeros((), jnp.int32), "it": jnp.zeros((), jnp.int32),
            "done": jnp.zeros((), bool), "cost": jnp.zeros((), f32),
            "nonzeros": jnp.zeros((), jnp.int32),
            "overflow": jnp.zeros((), jnp.int32),
        }
        final = lax.while_loop(cond, body, init)
        poses = final["poses"].at[:, :, 3].add(world_center)
        info = {k: final[k] for k in
                ("ell", "it", "cost", "nonzeros", "overflow")}
        return poses, info

    return solve


def irls_solve(
    clouds: PointCloud,
    init_poses: np.ndarray,
    edges: Sequence[Tuple[int, int]],
    pivot_flags: Sequence[bool],
    params: CvoParams,
    chunk: int = 1024,
    log=lambda *a: None,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    translation_only: bool = False,
    backend: str = "auto",
    engine: str = "auto",
    solver: str = "auto",
):
    """Outer IRLS loop (the CvoBatchIRLS::solve twin).

    clouds: stacked PointCloud pytree with leading frame axis [F, N, ...].
    init_poses: [F,3,4] float32 row-major (CvoFrame::pose_vec layout).
    Returns (poses [F,3,4], history list).

    engine: 'device' runs the whole schedule inside one jitted while_loop
    (make_irls_solver) with a single host sync per solve; 'host' drives the
    loop from Python with per-iteration logging and checkpoint snapshots.
    'auto' picks 'device' unless checkpoint_path or resume asks for
    per-iteration snapshots — the host loop makes ~3 host syncs per
    iteration, each of which drains the device queue (the log callback
    still receives a one-line summary on the device engine).

    History schema: the host engine returns one dict per solved outer
    iteration with keys {iter, ell, nonzeros, cost, delta}; the device
    engine returns ONE summary dict with the same key names where they
    exist ({iter, ell, nonzeros, cost}, plus 'overflow' — total ELL
    candidate drops over the solve; 'delta' is not observable from outside
    the fused loop). Overflow > 0 is surfaced as a WARNING through `log`
    on both engines.

    With `checkpoint_path`, outer-loop state (poses, ell, iteration,
    last_nonzeros) is snapshotted each iteration and `resume=True` restarts
    from it — the BA analogue of the reference's start-frame resumability
    (SURVEY.md §5 checkpoint/resume).
    """
    if resume and checkpoint_path is None:
        raise ValueError(
            "resume=True requires checkpoint_path — there is no snapshot to "
            "resume from otherwise")
    if solver == "auto":
        # dense Cholesky is exact and fast to a few hundred frames; the
        # matrix-free block-sparse PCG takes over at covis-graph scale
        # (the SPARSE_SCHUR analogue, IRLS.cpp:146-159)
        solver = "cg" if len(init_poses) > 64 else "dense"
    if engine == "auto":
        engine = "host" if (checkpoint_path is not None or resume) else "device"
    if engine == "device" and (checkpoint_path is not None or resume):
        raise ValueError(
            "engine='device' runs the whole schedule in one jitted loop and "
            "cannot write per-iteration checkpoints; use engine='host' (or "
            "engine='auto', which selects it) with checkpoint_path/resume")
    if engine == "device":
        solve = make_irls_solver(
            params, chunk, backend=backend,
            cloud_capacity=int(clouds.xyz.shape[1]),
            translation_only=translation_only, solver=solver)
        edge_i = jnp.asarray([e[0] for e in edges], jnp.int32)
        edge_j = jnp.asarray([e[1] for e in edges], jnp.int32)
        pivot_mask = jnp.asarray(np.asarray(pivot_flags, np.float32))
        poses, info = solve(clouds, jnp.asarray(init_poses, jnp.float32),
                            edge_i, edge_j, pivot_mask)
        hist = {k: (float(v) if jnp.issubdtype(jnp.asarray(v).dtype,
                                               jnp.floating) else int(v))
                for k, v in info.items()}
        hist["iter"] = hist.pop("it")        # host-engine key compatibility
        if hist.get("overflow", 0) > 0:
            log(f"WARNING: ELL neighbor caps dropped {hist['overflow']} "
                f"candidate pairs over the solve — raise nl_k / nl_per_cell "
                f"or use backend='dense'")
        log(f"device solve: {hist}")
        return np.asarray(poses), [hist]
    moments_fn, gn_fn = make_irls_kernels(
        params, chunk, backend=backend,
        cloud_capacity=int(clouds.xyz.shape[1]), solver=solver)
    dof_mask = (
        jnp.asarray([0, 0, 0, 1, 1, 1], jnp.float32) if translation_only else None
    )
    poses = jnp.asarray(init_poses, jnp.float32)
    # Recenter the world frame at the mean frame translation: the moment
    # contractions (M = T P T^T, cost = tr M11 - 2 tr M12 + tr M22) cancel
    # |q|^2-scale terms down to a residual-scale signal, which f32 only
    # survives when world coordinates stay tens of metres (the reference
    # runs Ceres in doubles instead, IRLS.cpp:146-159). Pure translation,
    # undone on return; kernel evaluation is translation invariant apart
    # from the reference's own range_ell(|transformed point|) quirk.
    world_center = jnp.mean(poses[:, :, 3], axis=0)
    poses = poses.at[:, :, 3].add(-world_center)
    edge_i = jnp.asarray([e[0] for e in edges], jnp.int32)
    edge_j = jnp.asarray([e[1] for e in edges], jnp.int32)
    pivot_mask = jnp.asarray(np.asarray(pivot_flags, np.float32))

    ell = params.multiframe_ell_init
    last_nonzeros = 0
    history = []
    iter_ = 0
    if resume and checkpoint_path:
        import os

        if os.path.exists(checkpoint_path):
            snap = np.load(checkpoint_path)
            poses = jnp.asarray(snap["poses"], jnp.float32)
            if "world_center" in snap:
                world_center = jnp.asarray(snap["world_center"], jnp.float32)
            ell = float(snap["ell"])
            iter_ = int(snap["iter"])
            last_nonzeros = int(snap["last_nonzeros"])
            log(f"resumed from {checkpoint_path}: iter={iter_} ell={ell:.4f}")
    while True:
        mom = moments_fn(clouds, poses, edge_i, edge_j, jnp.float32(ell))
        nz = np.asarray(mom.nonzeros)
        overflow = int(np.asarray(mom.overflow).sum())
        if overflow > 0:
            log(f"WARNING: ELL neighbor caps dropped {overflow} candidate "
                f"pairs — raise nl_k / nl_per_cell or use backend='dense'")
        edge_active = jnp.asarray(nz > params.multiframe_min_nonzeros)
        total_nonzeros = int(nz.sum())
        log(f"iter {iter_}: ell={ell:.4f} nonzeros={total_nonzeros} "
            f"active_edges={int(np.asarray(edge_active).sum())}/{len(edges)}")
        if int(np.asarray(edge_active).sum()) == 0 or iter_ >= params.multiframe_max_iters:
            break
        if total_nonzeros > last_nonzeros or iter_ < params.multiframe_iterations_per_ell:
            last_nonzeros = total_nonzeros
            poses, cost, dnorm = gn_fn(
                poses, edge_i, edge_j, mom, edge_active, pivot_mask,
                params.multiframe_iterations_per_solve, dof_mask=dof_mask,
            )
            history.append(
                {"iter": iter_, "ell": ell, "nonzeros": total_nonzeros,
                 "cost": float(cost), "delta": float(dnorm)}
            )
            log(f"  solved: cost={float(cost):.6f} |delta|={float(dnorm):.2e}")
        else:
            if ell >= params.multiframe_ell_min:
                last_nonzeros = 0
                ell = ell * params.multiframe_ell_decay_rate
                log(f"  reduce ell to {ell:.4f}")
            else:
                break
        iter_ += 1
        if checkpoint_path:
            np.savez(
                checkpoint_path,
                poses=np.asarray(poses),
                world_center=np.asarray(world_center),
                ell=ell,
                iter=iter_,
                last_nonzeros=last_nonzeros,
            )
    poses = poses.at[:, :, 3].add(world_center)
    return np.asarray(poses), history


def stack_clouds(clouds: List[PointCloud]) -> PointCloud:
    """Pad a list of clouds to a common capacity and stack on a frame axis."""
    cap = max(c.capacity for c in clouds)
    clouds = [kernels.pad_cloud_to_multiple(c, cap) for c in clouds]

    def cat(*xs):
        if any(x is None for x in xs):
            return None
        return jnp.stack(xs)

    return jax.tree.map(cat, *clouds, is_leaf=lambda x: x is None)
