"""End-to-end pairwise alignment: synthetic pose recovery + demo fixture."""

import numpy as np
import pytest

import jax.numpy as jnp

from fixtures import write_demo_pcds
from unified_cvo_tpu.config import CvoParams, load_preset
from unified_cvo_tpu.datasets.pcd import read_pcd
from unified_cvo_tpu.models.align import align, compute_association, function_angle
from unified_cvo_tpu.ops import lie
from unified_cvo_tpu.utils.pointcloud import make_pointcloud


def _bunnyish_cloud(rng, n=400):
    """Structured synthetic cloud (sphere + plane) with intensity features."""
    sph = rng.normal(size=(n // 2, 3))
    sph /= np.linalg.norm(sph, axis=1, keepdims=True)
    plane = np.stack(
        [rng.uniform(-2, 2, n // 2), rng.uniform(-2, 2, n // 2), np.full(n // 2, -1.2)],
        axis=1,
    )
    xyz = np.concatenate([sph, plane]).astype(np.float32)
    feats = np.concatenate(
        [np.abs(xyz) / 2.0, np.zeros((n, 2), np.float32)], axis=1
    ).astype(np.float32)
    return xyz, feats


@pytest.mark.parametrize("seed", [0, 1])
def test_align_recovers_synthetic_pose(seed):
    rng = np.random.default_rng(seed)
    xyz, feats = _bunnyish_cloud(rng)
    xi = np.array([0.03, -0.05, 0.04, 0.08, -0.05, 0.06], np.float32)
    R_true, t_true = lie.se3_exp(jnp.asarray(xi), 1.0)
    R_true, t_true = np.asarray(R_true), np.asarray(t_true)
    # target = true_transform applied to source points (+ mild noise)
    y = (xyz @ R_true.T + t_true).astype(np.float32)

    p = CvoParams(
        ell_init=0.5,
        ell_decay_rate=0.9,
        ell_decay_start=10,
        indicator_window_size=10,
        indicator_stable_threshold=0.2,
        max_step=0.1,
        min_step=1e-6,
        MAX_ITER=2000,
        sp_thres=0.0006,
        is_using_geometry=1,
        is_using_intensity=1,
    )
    src = make_pointcloud(xyz, features=feats, bucket=64)
    tgt = make_pointcloud(y, features=feats, bucket=64)
    T, ret, info = align(src, tgt, jnp.eye(4), p, max_iter=2000, chunk=64)
    T = np.asarray(T)
    assert int(ret) == 0
    # T maps target-frame points into the source frame: T ~ inverse(true)
    T_err = T @ np.asarray(lie.rt_to_mat44(jnp.asarray(R_true), jnp.asarray(t_true)))
    err = np.linalg.norm(np.asarray(lie.se3_log(T_err[:3, :3], T_err[:3, 3])))
    assert err < 0.03, (err, int(info.iterations), float(info.final_ell))


def test_align_demo_fixture(tmp_path):
    """The reference demo: two colored PCDs under cvo_outdoor_params
    (README.md:58-73, main_cvo_gpu_align_two_color_pcd.cpp), on a seeded
    colored pair at the demo's sizes (~25 deg rotation, centroids ~5.8 m
    apart; tests/fixtures.py) written as ASCII PCD and read back.

    Subsampled for CPU speed, with a faster decay schedule than the
    reference's 100k-iteration first-frame preset so the test finishes in
    seconds.
    """
    from scipy.spatial import cKDTree

    src_path, tgt_path = write_demo_pcds(tmp_path)
    sx, sc = read_pcd(src_path)
    tx, tc = read_pcd(tgt_path)
    rng = np.random.default_rng(0)
    si = rng.permutation(len(sx))[:260]
    ti = rng.permutation(len(tx))[:460]

    def mk(x, c):
        feats = np.concatenate([c, np.zeros((len(c), 2), np.float32)], axis=1)
        return make_pointcloud(x, features=feats, bucket=64)

    src, tgt = mk(sx[si], sc[si]), mk(tx[ti], tc[ti])
    p = load_preset("cvo_outdoor_params")
    # the demo main sets ell_init to the cloud-mean distance (main:56-60)
    dist = float(np.linalg.norm(sx[si].mean(0) - tx[ti].mean(0)))
    p = p.replace(
        ell_init=dist,
        ell_decay_rate=0.97,
        ell_decay_start=30,
        indicator_window_size=10,
        indicator_stable_threshold=0.002,
        max_step=0.05,
    )
    T, ret, info = align(src, tgt, jnp.eye(4), p, max_iter=6000, chunk=512)
    T = np.asarray(T)
    assert int(ret) == 0
    tree = cKDTree(sx)
    d_before, _ = tree.query(tx)
    d_after, _ = tree.query(tx @ T[:3, :3].T + T[:3, 3])
    assert np.median(d_before) > 3.0  # sanity: started far apart
    assert np.median(d_after) < 0.9, np.median(d_after)
    assert (d_after < 0.3).mean() > 0.15
    cos_before = float(function_angle(src, tgt, jnp.eye(4), 0.5, p))
    # function_angle takes the source->target transform (it moves the
    # target by its inverse); align returned the target->source map
    cos_after = float(function_angle(
        src, tgt, jnp.asarray(np.linalg.inv(T), jnp.float32), 0.5, p))
    assert cos_after > cos_before


def test_association_export_shapes():
    rng = np.random.default_rng(3)
    xyz, feats = _bunnyish_cloud(rng, n=120)
    p = CvoParams(is_using_intensity=1)
    src = make_pointcloud(xyz, features=feats, bucket=64)
    vals, idx, s_in, t_in = compute_association(
        src, src, jnp.eye(4), 0.1, p, top_k=16, chunk=64
    )
    assert vals.shape == idx.shape == (src.capacity, 16)
    # self-association at identity: every valid point matches itself
    vals, idx = np.asarray(vals), np.asarray(idx)
    n = 120
    assert np.asarray(s_in)[:n].all()
    assert np.asarray(t_in)[:n].all()
    for i in range(n):
        assert i in idx[i][: 4], i  # self-pair among strongest


def test_align_history_recording():
    rng = np.random.default_rng(5)
    xyz, feats = _bunnyish_cloud(rng, n=128)
    p = CvoParams(ell_init=0.4, MAX_ITER=50, max_step=0.05)
    src = make_pointcloud(xyz, features=feats, bucket=64)
    T, ret, info = align(
        src, src, jnp.eye(4), p, record_history=True, max_iter=50, chunk=64
    )
    h = info.history
    k = int(info.iterations)
    assert h is not None and k >= 1
    assert np.all(np.asarray(h["ell"])[:k] > 0)
    assert np.all(np.asarray(h["step"])[:k] >= p.min_step)


def test_align_is_deterministic():
    """Same inputs => bitwise-identical outputs across runs (the functional
    replacement for the reference's absent race detection, SURVEY.md §5:
    no atomics, no stream races, one deterministic trace)."""
    rng = np.random.default_rng(3)
    xyz, feats = _bunnyish_cloud(rng)
    p = CvoParams(ell_init=0.5, max_step=0.1, is_using_geometry=1)
    src = make_pointcloud(xyz, bucket=64)
    tgt = make_pointcloud(xyz + np.float32([0.05, 0.0, 0.02]), bucket=64)
    outs = [align(src, tgt, jnp.eye(4), p, max_iter=50) for _ in range(2)]
    np.testing.assert_array_equal(np.asarray(outs[0][0]), np.asarray(outs[1][0]))
    assert int(outs[0][2].iterations) == int(outs[1][2].iterations)


def test_debug_nans_context():
    from unified_cvo_tpu.utils.logging import debug_nans

    with debug_nans():
        import pytest as _pytest

        with _pytest.raises(FloatingPointError):
            jnp.log(jnp.float32(-1.0)) + 1.0
