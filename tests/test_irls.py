"""Multiframe IRLS BA tests: moment/GN blocks vs brute-force oracle, plus the
bunny-random fixture (reference main_multi_frame_irls_bunny_random.cpp)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from unified_cvo_tpu.config import CvoParams
from unified_cvo_tpu.models import irls
from unified_cvo_tpu.ops import lie
from unified_cvo_tpu.utils.pointcloud import make_pointcloud

from oracle import oracle_kernel_matrix


def _params():
    return CvoParams(
        sp_thres=0.002,
        multiframe_ell_init=0.6,
        multiframe_ell_min=0.05,
        multiframe_ell_decay_rate=0.7,
        multiframe_iterations_per_ell=3,
        multiframe_iterations_per_solve=6,
        multiframe_min_nonzeros=20,
        multiframe_max_iters=60,
    )


def _bunnyish(rng, n=256):
    sph = rng.normal(size=(n // 2, 3))
    sph /= np.linalg.norm(sph, axis=1, keepdims=True)
    box = rng.uniform(-1, 1, size=(n - n // 2, 3)) * np.array([1.5, 0.2, 1.0])
    return np.concatenate([sph, box]).astype(np.float32)


def brute_force_system(A, p1, p2, T1, T2):
    """Per-pair GN system for cost sum w ||T1 h1 - T2 h2||^2 with
    left-multiplicative perturbations; oracle for _edge_blocks."""
    h1 = np.concatenate([p1, np.ones((len(p1), 1))], 1)
    h2 = np.concatenate([p2, np.ones((len(p2), 1))], 1)
    q1 = h1 @ T1.T
    q2 = h2 @ T2.T
    H = np.zeros((12, 12))
    b = np.zeros(12)
    cost = 0.0

    def skew(v):
        return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])

    for i in range(len(p1)):
        for j in range(len(p2)):
            w = A[i, j]
            if w <= 0:
                continue
            J1 = np.hstack([-skew(q1[i]), np.eye(3)])
            J2 = -np.hstack([-skew(q2[j]), np.eye(3)])
            J = np.hstack([J1, J2])
            r = q1[i] - q2[j]
            H += w * J.T @ J
            b += w * J.T @ r
            cost += w * float(r @ r)
    return H, b, cost


def test_edge_blocks_match_brute_force(rng):
    p = _params()
    ell = 0.5
    p1 = _bunnyish(rng, 40)
    xi1 = np.array([0.05, -0.02, 0.04, 0.1, 0.05, -0.08], np.float32)
    xi2 = np.array([-0.03, 0.04, 0.01, -0.06, 0.02, 0.05], np.float32)
    R1, t1 = (np.asarray(v) for v in lie.se3_exp(jnp.asarray(xi1), 1.0))
    R2, t2 = (np.asarray(v) for v in lie.se3_exp(jnp.asarray(xi2), 1.0))
    T1 = np.hstack([R1, t1[:, None]]).astype(np.float32)
    T2 = np.hstack([R2, t2[:, None]]).astype(np.float32)
    p2 = p1 + rng.normal(scale=0.05, size=p1.shape).astype(np.float32)

    # weights evaluated at the *transformed* points (BinaryStateGPU semantics)
    q1 = p1 @ R1.T + t1
    q2 = p2 @ R2.T + t2
    A = oracle_kernel_matrix(p, ell, q1, q2)

    c1 = make_pointcloud(p1, bucket=8)
    c2 = make_pointcloud(p2, bucket=8)
    mom = irls._edge_moments_single(
        p, jnp.float32(ell), c1, c2, jnp.asarray(T1), jnp.asarray(T2), chunk=8
    )
    assert int(mom.nonzeros) == int((A > 0).sum())

    H_aa, H_bb, H_ab, b_a, b_b, cost = (
        np.asarray(v)
        for v in irls._edge_blocks(mom.P11, mom.P12, mom.P22,
                                   jnp.asarray(T1), jnp.asarray(T2))
    )
    H_ref, b_ref, cost_ref = brute_force_system(A, p1, p2, T1, T2)
    np.testing.assert_allclose(H_aa, H_ref[:6, :6], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(H_bb, H_ref[6:, 6:], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(H_ab, H_ref[:6, 6:], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(b_a, b_ref[:6], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(b_b, b_ref[6:], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(cost, cost_ref, rtol=1e-3)


def test_irls_bunny_random_recovers_poses(rng):
    """The bunny-random BA fixture: F frames of the same cloud with random
    pose perturbations; IRLS must pull all frames back together
    (reference main_multi_frame_irls_bunny_random.cpp)."""
    p = _params()
    base = _bunnyish(rng, 256)
    F = 4
    true_poses = [np.eye(3, 4, dtype=np.float32)]
    clouds = [make_pointcloud(base, bucket=256)]
    rngs = np.random.default_rng(7)
    for f in range(1, F):
        xi = 0.1 * rngs.normal(size=6).astype(np.float32)
        R, t = (np.asarray(v) for v in lie.se3_exp(jnp.asarray(xi), 1.0))
        # frame cloud = base expressed in a frame offset by (R,t):
        # world point x = R_f p + t_f  =>  p = R_f^T (x - t_f)
        pts = (base - t) @ R
        clouds.append(make_pointcloud(pts.astype(np.float32), bucket=256))
        true_poses.append(np.hstack([R, t[:, None]]).astype(np.float32))

    stacked = irls.stack_clouds(clouds)
    # init poses: identity everywhere (all frames start collapsed)
    init = np.tile(np.eye(3, 4, dtype=np.float32), (F, 1, 1))
    edges = [(i, j) for i in range(F) for j in range(i + 1, F)]
    poses, hist = irls.irls_solve(
        stacked, init, edges, [True] + [False] * (F - 1), p, chunk=256
    )

    assert len(hist) >= 1
    for f in range(F):
        # compare frame-f pose against truth (gauge fixed by pivot frame 0)
        R_est, t_est = poses[f, :, :3], poses[f, :, 3]
        R_true, t_true = true_poses[f][:, :3], true_poses[f][:, 3]
        dR = R_est.T @ R_true
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert ang < 0.02, (f, ang)
        assert np.linalg.norm(t_est - t_true) < 0.05, (f, t_est, t_true)


def test_gn_preserves_pivot(rng):
    p = _params()
    base = _bunnyish(rng, 128)
    clouds = irls.stack_clouds(
        [make_pointcloud(base, bucket=128), make_pointcloud(base + 0.05, bucket=128)]
    )
    init = np.tile(np.eye(3, 4, dtype=np.float32), (2, 1, 1))
    poses, hist = irls.irls_solve(
        clouds, init, [(0, 1)], [True, False], p, chunk=128
    )
    np.testing.assert_array_equal(poses[0], init[0])
    assert not np.allclose(poses[1], init[1])  # free frame moved


def test_device_solver_matches_host_loop(rng):
    """make_irls_solver (whole outer loop in one jitted while_loop) must
    reproduce the host-driven irls_solve schedule and poses."""
    p = _params()
    base = _bunnyish(rng, 256)
    F = 4
    clouds = [make_pointcloud(base, bucket=256)]
    rngs = np.random.default_rng(7)
    for f in range(1, F):
        xi = 0.1 * rngs.normal(size=6).astype(np.float32)
        R, t = (np.asarray(v) for v in lie.se3_exp(jnp.asarray(xi), 1.0))
        clouds.append(make_pointcloud(((base - t) @ R).astype(np.float32),
                                      bucket=256))
    stacked = irls.stack_clouds(clouds)
    init = np.tile(np.eye(3, 4, dtype=np.float32), (F, 1, 1))
    edges = [(i, j) for i in range(F) for j in range(i + 1, F)]
    pivots = [True] + [False] * (F - 1)

    host_poses, hist = irls.irls_solve(stacked, init, edges, pivots, p,
                                       chunk=256, engine="host")
    solve = irls.make_irls_solver(p, chunk=256,
                                  cloud_capacity=int(stacked.xyz.shape[1]))
    dev_poses, info = solve(
        stacked, jnp.asarray(init),
        jnp.asarray([e[0] for e in edges], jnp.int32),
        jnp.asarray([e[1] for e in edges], jnp.int32),
        jnp.asarray(np.asarray(pivots, np.float32)))
    assert int(info["it"]) >= len(hist)  # schedule length modulo final round
    np.testing.assert_allclose(np.asarray(dev_poses), host_poses,
                               rtol=1e-4, atol=1e-4)


def test_cg_solver_matches_dense(rng):
    """The matrix-free block-sparse PCG GN (the
    SPARSE_SCHUR-scale path) must reproduce the dense Cholesky solve on a
    chain+skip covis graph, and scale to 100+ frames without materializing
    the 6F x 6F Hessian."""
    p = _params()
    base = _bunnyish(rng)
    F = 120
    clouds, true_poses, init = [], [], []
    for f in range(F):
        xi = (0.015 * rng.normal(size=6)).astype(np.float32)
        if f == 0:
            xi *= 0.0
        R, t = (np.asarray(v) for v in lie.se3_exp(jnp.asarray(xi), 1.0))
        true_poses.append(np.concatenate([R, t[:, None]], 1))
        clouds.append(make_pointcloud(((base - t) @ R).astype(np.float32),
                                      bucket=256))
        init.append(np.eye(3, 4, dtype=np.float32))
    stacked = irls.stack_clouds(clouds)
    init = np.stack(init)
    edges = [(i, i + 1) for i in range(F - 1)] + \
            [(i, i + 3) for i in range(F - 3)]
    pivots = [True] + [False] * (F - 1)
    short = p.replace(multiframe_max_iters=6,
                      multiframe_iterations_per_ell=2,
                      multiframe_iterations_per_solve=3)
    poses_d, _ = irls.irls_solve(stacked, init, edges, pivots, short,
                                 chunk=256, engine="device", solver="dense")
    poses_c, _ = irls.irls_solve(stacked, init, edges, pivots, short,
                                 chunk=256, engine="device", solver="cg")
    np.testing.assert_allclose(poses_c, poses_d, atol=2e-4)
    # and the CG solve actually moved toward the truth
    err0 = max(np.abs(init[f] - true_poses[f]).max() for f in range(F))
    err1 = max(np.abs(poses_c[f] - true_poses[f]).max() for f in range(F))
    assert err1 < 0.7 * err0, (err0, err1)  # 6-outer-iter schedule: partial
