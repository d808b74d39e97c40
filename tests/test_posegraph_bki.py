"""Pose-graph GN and BKI mapping tests."""

import numpy as np
import pytest

import jax.numpy as jnp

from unified_cvo_tpu.models.bki import SemanticBKIMap, sparse_kernel
from unified_cvo_tpu.models.keyframe import Keyframe
from unified_cvo_tpu.models.posegraph import (
    PoseGraph,
    PoseGraphConfig,
    RelativePose,
    optimize_pose_graph,
)
from unified_cvo_tpu.ops import lie
from unified_cvo_tpu.utils.pointcloud import make_pointcloud


def _rand_se3(rng, scale=0.3):
    xi = scale * rng.normal(size=6).astype(np.float32)
    R, t = (np.asarray(v) for v in lie.se3_exp(jnp.asarray(xi), 1.0))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def test_pose_graph_gn_closes_loop(rng):
    """Chain of noisy odometry factors + one loop closure: GN must reduce
    the loop-closure residual (the GTSAM-replacement sanity check)."""
    F = 6
    true = [np.eye(4)]
    for _ in range(F - 1):
        true.append(true[-1] @ _rand_se3(rng, 0.4))
    # noisy odometry measurements
    Zs, fi, fj = [], [], []
    for k in range(F - 1):
        Z = np.linalg.inv(true[k]) @ true[k + 1] @ _rand_se3(rng, 0.02)
        Zs.append(Z)
        fi.append(k)
        fj.append(k + 1)
    # exact loop closure 0 -> F-1
    Zs.append(np.linalg.inv(true[0]) @ true[F - 1])
    fi.append(0)
    fj.append(F - 1)

    # init poses by composing noisy odometry (drift)
    init = [np.eye(4)]
    for k in range(F - 1):
        init.append(init[-1] @ Zs[k])
    init = np.stack(init).astype(np.float32)
    drift_before = np.linalg.norm(init[-1][:3, 3] - true[-1][:3, 3])

    fixed = np.zeros(F, np.float32)
    fixed[0] = 1.0
    out, _ = optimize_pose_graph(
        jnp.asarray(init), jnp.asarray(fi, jnp.int32), jnp.asarray(fj, jnp.int32),
        jnp.asarray(np.stack(Zs), jnp.float32),
        jnp.ones(len(Zs), jnp.float32), jnp.asarray(fixed), iters=10,
    )
    out = np.asarray(out)
    drift_after = np.linalg.norm(out[-1][:3, 3] - true[-1][:3, 3])
    assert drift_after < drift_before * 0.5 + 1e-3, (drift_before, drift_after)
    np.testing.assert_allclose(out[0], np.eye(4), atol=1e-6)  # gauge held


def test_pose_graph_cg_closes_200_keyframe_loop(rng):
    """The matrix-free block-PCG path (reused from the
    distributed BA) closes a 200-keyframe loop with O(E) memory, and
    matches the dense solve on the same graph."""
    F = 200
    true = [np.eye(4)]
    for _ in range(F - 1):
        true.append(true[-1] @ _rand_se3(rng, 0.2))
    Zs, fi, fj = [], [], []
    for k in range(F - 1):
        Zs.append(np.linalg.inv(true[k]) @ true[k + 1] @ _rand_se3(rng, 0.01))
        fi.append(k)
        fj.append(k + 1)
    # three exact loop closures spread along the trajectory
    for a, b in ((0, F - 1), (0, F // 2), (F // 2, F - 1)):
        Zs.append(np.linalg.inv(true[a]) @ true[b])
        fi.append(a)
        fj.append(b)
    init = [np.eye(4)]
    for k in range(F - 1):
        init.append(init[-1] @ Zs[k])
    init = np.stack(init).astype(np.float32)
    drift_before = np.linalg.norm(init[-1][:3, 3] - true[-1][:3, 3])
    fixed = np.zeros(F, np.float32)
    fixed[0] = 1.0
    args = (jnp.asarray(init), jnp.asarray(fi, jnp.int32),
            jnp.asarray(fj, jnp.int32), jnp.asarray(np.stack(Zs), jnp.float32),
            jnp.ones(len(Zs), jnp.float32), jnp.asarray(fixed))
    out_cg, _ = optimize_pose_graph(*args, iters=15, solver="cg")
    out_cg = np.asarray(out_cg)
    drift_after = np.linalg.norm(out_cg[-1][:3, 3] - true[-1][:3, 3])
    assert drift_after < drift_before * 0.2 + 1e-3, (drift_before, drift_after)
    np.testing.assert_allclose(out_cg[0], np.eye(4), atol=1e-6)
    # dense and CG agree on the solved trajectory
    out_d, _ = optimize_pose_graph(*args, iters=15, solver="dense")
    np.testing.assert_allclose(out_cg, np.asarray(out_d), atol=5e-3)


def test_online_pose_graph_keyframing():
    pg = PoseGraph(PoseGraphConfig(keyframe_function_angle_threshold=0.6))
    pg.add_first_frame(0)
    T = np.eye(4)
    T[0, 3] = 0.1
    assert not pg.add_frame(1, T, function_angle=0.9)   # good tracking
    assert pg.num_keyframes == 1
    assert pg.add_frame(2, T, function_angle=0.3)       # tracking degraded
    assert pg.num_keyframes == 2
    assert len(pg.trajectory) == 3


def test_sparse_kernel_shape():
    d = np.array([0.0, 0.15, 0.3, 0.5])
    k = sparse_kernel(d, ell=0.3, sigma0=1.0)
    assert k[0] == pytest.approx(1.0)
    assert k[0] > k[1] > k[2] >= 0
    assert k[3] == 0.0


def test_bki_empty_map_query():
    """Querying a freshly-constructed map returns unknown, not IndexError."""
    m = SemanticBKIMap(resolution=0.1, num_classes=4)
    states, sems = m.query(np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]]))
    assert (states == 0).all() and (sems == 0).all()


def test_bki_map_occupancy_and_semantics():
    m = SemanticBKIMap(resolution=0.1, num_classes=4, ell=0.2)
    rng = np.random.default_rng(0)
    # a wall at z=2 labeled class 2, sensor at origin
    pts = np.stack(
        [rng.uniform(-0.5, 0.5, 200), rng.uniform(-0.5, 0.5, 200),
         np.full(200, 2.0)], 1,
    )
    labels = np.tile(np.eye(4)[1][None, :], (200, 1))  # class index 2 overall
    m.insert_pointcloud(pts, labels, origin=np.zeros(3))
    states, sems = m.query(np.array([[0, 0, 2.0], [0, 0, 1.0], [5, 5, 5]]))
    assert states[0] == 1 and sems[0] == 2      # wall occupied, class 2
    assert states[1] == -1                      # ray midpoint free
    assert states[2] == 0                       # unseen


def _oracle_alpha(pos, ev, res, ell, sigma0, prior):
    """Brute-force per-point cube-walk oracle for the device scatter path."""
    reach = int(np.ceil(ell / res))
    offs = np.arange(-reach, reach + 1)
    cube = np.stack(np.meshgrid(offs, offs, offs, indexing="ij"), -1).reshape(-1, 3)
    acc = {}
    for p, e in zip(pos, ev):
        base = np.floor(p / res).astype(np.int64)
        for off in cube:
            v = base + off
            c = (v + 0.5) * res
            w = float(sparse_kernel(np.linalg.norm(c - p), ell, sigma0))
            if w > 0:
                k = tuple(v)
                acc[k] = acc.get(k, np.full(ev.shape[1], prior)) + w * e
    return acc


def _check_against_oracle(m, oracle, res):
    """Match map voxels to the f64 oracle. The BKI kernel's tail is ~1e-6
    near its support edge, so f32 on device can flip a borderline weight to
    exactly 0 — voxels present on only one side must carry negligible
    evidence; shared voxels must agree."""
    centers, _, alphas = m.export_occupied()
    vox = np.floor(centers / res + 1e-6).astype(np.int64)
    seen = set()
    for v, a in zip(vox, alphas):
        k = tuple(v)
        if k in oracle:
            np.testing.assert_allclose(a, oracle[k], rtol=3e-5, atol=3e-5)
            seen.add(k)
        else:
            assert (a - m.prior).max() < 1e-4, (k, a)
    for k, a in oracle.items():
        if k not in seen:
            assert (a - m.prior).max() < 1e-4, (k, a)


def test_bki_scatter_matches_bruteforce_oracle(rng):
    """The sort/segment-sum device scatter (both the wide and the rank-1
    scalar path) must reproduce the per-point cube-walk accumulation."""
    res, ell, C = 0.1, 0.2, 3
    pos = rng.uniform(-0.8, 0.8, (80, 3))
    labels = np.eye(C + 1)[rng.integers(1, C + 1, 80)][:, 1:]

    # wide path (per-point label rows)
    m = SemanticBKIMap(resolution=res, num_classes=C, ell=ell)
    m.insert_pointcloud(pos, labels)          # no origin: no free evidence
    ev = np.zeros((80, C + 1))
    ev[:, 1:] = labels
    oracle = _oracle_alpha(pos, ev, res, ell, m.sigma0, m.prior)
    _check_against_oracle(m, oracle, res)

    # scalar path (unlabeled occupied -> class 1 evidence)
    m2 = SemanticBKIMap(resolution=res, num_classes=C, ell=ell)
    m2.insert_pointcloud(pos)
    ev1 = np.zeros((80, C + 1))
    ev1[:, 1] = 1.0
    oracle1 = _oracle_alpha(pos, ev1, res, ell, m2.sigma0, m2.prior)
    _check_against_oracle(m2, oracle1, res)


def test_keyframe_local_map_roundtrip():
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-1, 1, (100, 3)).astype(np.float32) + [0, 0, 3]
    labels = np.tile(np.eye(5, dtype=np.float32)[3][None, :], (100, 1))
    kf = Keyframe(0, make_pointcloud(xyz, labels=labels, bucket=64))
    kf.construct_map(resolution=0.2, num_classes=5, ell=0.3)
    exported = kf.export_points_from_map()
    assert exported is not None
    from unified_cvo_tpu.utils.pointcloud import to_numpy_valid

    data = to_numpy_valid(exported)
    assert len(data["xyz"]) > 10
    # weakly-touched boundary voxels may stay prior-uniform; the bulk must
    # carry the inserted class
    assert (data["labels"].argmax(1) == 3).mean() > 0.9


def _run_windowed_slam(rng_seed, window, truncate=False, n_kf=14):
    """Drive PoseGraph over a noisy circular trajectory with odometry +
    skip-2 factors. truncate=True disables the marginal prior (the old
    factor-truncation behavior) for comparison."""
    rng = np.random.default_rng(rng_seed)
    # ground-truth keyframes on a circle
    true = [np.eye(4)]
    step = np.eye(4)
    th = 2 * np.pi / n_kf
    step[:3, :3] = np.array(
        [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    step[:3, 3] = [0.0, 0.0, 1.0]
    for _ in range(n_kf - 1):
        true.append(true[-1] @ step)

    def noisy_rel(i, j, sigma):
        Z = np.linalg.inv(true[i]) @ true[j]
        N = _rand_se3(rng, scale=sigma)
        return Z @ N

    pg = PoseGraph(PoseGraphConfig(
        keyframe_function_angle_threshold=0.5, window_size=window,
        optimize_iters=8))
    if truncate:
        # old behavior: slide by pruning factors, no marginal prior
        def trunc(new_lo):
            pg.factors = [f for f in pg.factors
                          if f.ref_id >= new_lo and f.curr_id >= new_lo]
            pg.prior = None
            pg.window_lo = new_lo
        pg._marginalize = trunc
    pg.add_first_frame(0)
    for k in range(1, n_kf):
        extra = []
        if k >= 2:
            extra.append(RelativePose(
                curr_id=k, ref_id=k - 2,
                transform=noisy_rel(k - 2, k, 0.01), inner_product=0.3))
        pg.add_frame(k, noisy_rel(k - 1, k, 0.03), function_angle=0.2,
                     extra_factors=extra)
    errs = [np.linalg.norm(pg.keyframe_poses[k][:3, 3] - true[k][:3, 3])
            for k in range(n_kf)]
    return float(np.mean(errs)), pg


def test_sliding_window_marginalization_keeps_information():
    """Real fixed-lag smoothing: the Schur-complement
    marginal prior must track the full-batch solution far better than
    factor truncation, across seeds."""
    prior_wins = 0
    for seed in (0, 1, 2):
        err_batch, _ = _run_windowed_slam(seed, window=0)
        err_prior, pg = _run_windowed_slam(seed, window=5)
        err_trunc, _ = _run_windowed_slam(seed, window=5, truncate=True)
        assert pg.prior is not None and len(pg.prior["ids"]) >= 1
        # windowed-with-prior stays near the batch optimum
        assert err_prior < err_batch + 0.15, (seed, err_prior, err_batch)
        if err_prior <= err_trunc + 1e-9:
            prior_wins += 1
    assert prior_wins >= 2, "marginal prior should beat truncation"


def test_marginal_prior_is_consistent_quadratic():
    """After sliding, re-optimizing with the prior from an unperturbed
    state must leave the window (numerically) unchanged — the prior's
    gradient vanishes at its own linearization point when the kept factors
    are at their optimum."""
    err, pg = _run_windowed_slam(3, window=5)
    poses_before = [p.copy() for p in pg.keyframe_poses]
    pg.optimize()
    moved = max(
        np.abs(pg.keyframe_poses[k] - poses_before[k]).max()
        for k in range(len(poses_before)))
    assert moved < 5e-3, moved


def test_incremental_flat_cost_1000_keyframes(rng):
    """iSAM2-analogue incremental mode: on a
    1000-keyframe odometry run with periodic local loop factors, the
    per-keyframe optimize() cost must stay flat with trajectory length
    (the batch path re-solves the whole graph each call), and the chain
    must remain consistent with the measurements."""
    import time

    from unified_cvo_tpu.models.posegraph import (PoseGraph, PoseGraphConfig,
                                                  RelativePose)

    pg = PoseGraph(PoseGraphConfig(incremental=True,
                                   keyframe_function_angle_threshold=1.0,
                                   optimize_iters=4))
    pg.add_first_frame(0)
    step = np.eye(4)
    step[:3, 3] = [0.0, 0.0, 0.4]
    F = 1000
    stamps = []
    for k in range(1, F):
        noisy = step.copy()
        noisy[:3, 3] += rng.normal(0, 0.01, 3)
        extra = None
        if k % 25 == 0 and k >= 2:
            # short-range loop factor two keyframes back
            rel = np.eye(4)
            rel[:3, 3] = 2 * step[:3, 3]
            extra = [RelativePose(curr_id=k, ref_id=k - 2,
                                  transform=rel, inner_product=0.5)]
        t0 = time.perf_counter()
        pg.add_frame(k, noisy, function_angle=0.5, extra_factors=extra)
        stamps.append(time.perf_counter() - t0)
    early = float(np.median(stamps[100:200]))
    late = float(np.median(stamps[-100:]))
    # flat per-keyframe cost: late keyframes may not cost more than ~2x
    # the early ones (jit caches warm by frame 100; the batch solver is
    # O(F) per call and fails this by an order of magnitude at F=1000)
    assert late < 2.0 * early + 2e-3, (early, late)
    # consistency: the optimized chain tracks the odometry measurements
    est = pg.keyframe_poses[-1][:3, 3]
    expect = (F - 1) * step[:3, 3]
    assert np.linalg.norm(est - expect) < 0.4 * np.sqrt(F), (est, expect)
