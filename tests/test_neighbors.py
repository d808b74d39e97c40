"""Verlet ELL neighbor-list backend (ops/neighbors.py).

Covers: candidate-superset property of the grid builder, exact agreement of
the ELL flow/step passes with the dense jnp oracle, full-trajectory agreement
of align(backend='ell') with align(backend='jnp') including forced mid-align
rebuilds, and overflow accounting on a pathologically dense cloud.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from unified_cvo_tpu.config import CvoParams
from unified_cvo_tpu.models.align import align
from unified_cvo_tpu.ops import kernels, lie
from unified_cvo_tpu.ops import neighbors as nbr
from unified_cvo_tpu.utils.pointcloud import make_pointcloud


def _scene(rng, n=1536, spread=12.0):
    xyz = np.stack(
        [rng.uniform(-spread, spread, n), rng.uniform(-2, 2, n),
         rng.uniform(2, 50, n)], axis=1).astype(np.float32)
    return xyz


def _params(**kw):
    base = dict(ell_init=0.4, ell_min=0.05, ell_decay_rate=0.9,
                ell_decay_start=5, indicator_window_size=5,
                indicator_stable_threshold=0.2, max_step=0.1,
                sp_thres=0.0006, is_using_geometry=1)
    base.update(kw)
    return CvoParams(**base)


def test_candidate_list_superset_of_support(rng):
    """Every pair the dense kernel keeps must be in the candidate list."""
    params = _params()
    xyz = _scene(rng)
    xyz2 = _scene(rng) + np.float32([0.1, 0.0, 0.2])
    src = make_pointcloud(xyz, bucket=512)
    tgt = make_pointcloud(xyz2, bucket=512)
    R = jnp.eye(3)
    T = jnp.zeros(3)
    ell = jnp.float32(params.ell_init)
    nl = nbr.build_neighbor_list(params, ell, src, tgt, R, T, k=192, skin=0.3, per_cell_cap=24)
    assert int(nl.overflow) == 0

    a_dense = np.asarray(kernels.kernel_block(params, ell, src, tgt))
    idx = np.asarray(nl.idx).T                               # K-major -> [N,K]
    listed = np.zeros_like(a_dense, dtype=bool)
    rows = np.repeat(np.arange(idx.shape[0]), idx.shape[1])
    cols = idx.reshape(-1)
    ok = cols >= 0
    listed[rows[ok], cols[ok]] = True
    missing = (a_dense > 0) & ~listed
    assert not missing.any(), f"{missing.sum()} support pairs missing"


def test_candidate_list_anisotropic_grid_superset(rng):
    """A (gx, 1, gz) grid collapses the y axis to one cell (no +-1 y
    offsets, 9-cell pool); the list must still be a support superset."""
    params = _params()
    xyz = _scene(rng)
    xyz2 = _scene(rng) + np.float32([0.1, 0.0, 0.2])
    src = make_pointcloud(xyz, bucket=512)
    tgt = make_pointcloud(xyz2, bucket=512)
    R = jnp.eye(3)
    T = jnp.zeros(3)
    ell = jnp.float32(params.ell_init)
    nl = nbr.build_neighbor_list(params, ell, src, tgt, R, T, k=192,
                                 skin=0.3, per_cell_cap=64,
                                 grid_dims=(16, 1, 16))
    assert int(nl.overflow) == 0
    a_dense = np.asarray(kernels.kernel_block(params, ell, src, tgt))
    idx = np.asarray(nl.idx).T
    listed = np.zeros_like(a_dense, dtype=bool)
    rows = np.repeat(np.arange(idx.shape[0]), idx.shape[1])
    cols = idx.reshape(-1)
    ok = cols >= 0
    listed[rows[ok], cols[ok]] = True
    missing = (a_dense > 0) & ~listed
    assert not missing.any(), f"{missing.sum()} support pairs missing"


def test_ell_passes_match_dense_oracle(rng):
    params = _params()
    xyz = _scene(rng)
    xi = np.array([0.002, 0.005, -0.001, 0.05, 0.02, 0.4], np.float32)
    R_m, t_m = lie.se3_exp(jnp.asarray(xi), 1.0)
    xyz2 = np.asarray(xyz @ np.asarray(R_m).T + np.asarray(t_m))
    src = make_pointcloud(xyz, bucket=512)
    tgt = make_pointcloud(xyz2, bucket=512)
    Rinv, Tinv = lie.invert_rt(jnp.asarray(R_m), jnp.asarray(t_m))
    ell = jnp.float32(params.ell_init)
    y_t = tgt.transformed(Rinv, Tinv)

    ref = kernels.flow_stats(params, ell, src, y_t, chunk=512)
    nl = nbr.build_neighbor_list(params, ell, src, tgt, Rinv, Tinv,
                                 k=192, skin=0.3, per_cell_cap=24)
    assert int(nl.overflow) == 0
    got, a, yts = nbr.flow_stats_ell(params, ell, src, nl, Rinv, Tinv)
    assert int(got.nonzeros) == int(ref.nonzeros)
    np.testing.assert_allclose(got.a_sum, ref.a_sum, rtol=1e-5)
    np.testing.assert_allclose(got.row_sum, ref.row_sum, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.row_wy, ref.row_wy, rtol=1e-4, atol=1e-5)

    twist, _ = kernels.flow_from_stats(params, src, ref)
    B0, C0, D0, E0 = kernels.step_coeffs(params, ell, src, y_t, twist, chunk=512)
    B1, C1, D1, E1 = nbr.step_coeffs_ell(params, ell, src, a, yts, twist)
    # the oracle computes the pair dots as x@xi.T - ydot (matmul form) while the
    # ELL pass uses the direct (x - y).xi broadcast; only f32 rounding differs
    for r, g in zip((B0, C0, D0, E0), (B1, C1, D1, E1)):
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=5e-3)


@pytest.mark.parametrize("skin,label", [(0.4, "no-rebuild"), (0.12, "rebuilds")])
def test_align_ell_matches_jnp_trajectory(rng, skin, label):
    params = _params()
    xyz = _scene(rng, n=1024)
    xi = np.array([0.001, 0.004, -0.002, 0.03, 0.01, 0.3], np.float32)
    R_m, t_m = lie.se3_exp(jnp.asarray(xi), 1.0)
    xyz2 = np.asarray(xyz @ np.asarray(R_m).T + np.asarray(t_m))
    src = make_pointcloud(xyz, bucket=1024)
    tgt = make_pointcloud(xyz2, bucket=1024)
    ig = lie.rt_to_mat44(*lie.se3_exp(jnp.asarray(xi * 0.2), 1.0))
    T1, r1, i1 = align(src, tgt, ig, params, backend="jnp", max_iter=400)
    T2, r2, i2 = align(src, tgt, ig, params, backend="ell", max_iter=400,
                       nl_k=160, nl_per_cell=20, nl_skin=skin,
                       nl_builder="grid")
    assert int(i2.nl_overflow) == 0
    # identical math modulo f32 summation order; trajectories track closely
    assert float(jnp.max(jnp.abs(T1 - T2))) < 2e-3, label


def test_overflow_is_reported_on_dense_cloud(rng):
    """A cloud much denser than the kernel support must report dropped
    candidates through AlignInfo.nl_overflow instead of failing silently."""
    params = _params(ell_init=1.0)
    xyz = rng.uniform(-0.5, 0.5, (512, 3)).astype(np.float32)
    src = make_pointcloud(xyz, bucket=512)
    tgt = make_pointcloud(xyz + np.float32([0.02, 0, 0]), bucket=512)
    T, ret, info = align(src, tgt, jnp.eye(4), params, backend="ell",
                         max_iter=5, nl_k=32, nl_per_cell=4)
    assert int(info.nl_overflow) > 0


def test_auto_backend_gates():
    """auto -> ell only for large clouds with local support."""
    from unified_cvo_tpu.ops.neighbors import static_support_radius

    assert static_support_radius(_params(ell_init=0.15)) < 2.0
    assert static_support_radius(_params(ell_init=5.0)) > 2.0


# -------------------------------------------------- brute-force scan builder


def test_scan_builder_matches_grid_builder(rng):
    """On a config where both builders are sound, the ELL passes driven by
    either candidate list agree with each other (and the dense oracle)."""
    params = _params()
    xyz = _scene(rng, n=4096)
    xyz2 = _scene(rng, n=4096) + np.float32([0.1, 0.0, 0.2])
    src = make_pointcloud(xyz, bucket=512)
    tgt = make_pointcloud(xyz2, bucket=512)
    R = jnp.eye(3)
    T = jnp.zeros(3)
    ell = jnp.float32(params.ell_init)
    nl_g = nbr.build_neighbor_list(params, ell, src, tgt, R, T,
                                   k=192, skin=0.3, per_cell_cap=24)
    nl_s = nbr.build_neighbor_list_scan(params, ell, src, tgt, R, T,
                                        k=192, skin=0.3, chunk=1024)
    assert int(nl_g.overflow) == 0 and int(nl_s.overflow) == 0
    fg, _, _ = nbr.flow_stats_ell(params, ell, src, nl_g, R, T)
    fs, _, _ = nbr.flow_stats_ell(params, ell, src, nl_s, R, T)
    assert int(fg.nonzeros) == int(fs.nonzeros)
    np.testing.assert_allclose(fs.a_sum, fg.a_sum, rtol=1e-5)
    np.testing.assert_allclose(fs.row_sum, fg.row_sum, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fs.row_wy, fg.row_wy, rtol=1e-4, atol=1e-5)


def test_align_scan_large_support_small_cloud(rng):
    """The scan builder covers the regimes the grid builder cannot: a
    support radius far beyond 2 m on a sub-4096 cloud. Trajectory must
    match the dense jnp backend."""
    params = _params(ell_init=3.0, ell_min=0.5, max_step=0.1)
    assert nbr.static_support_radius(params) > 2.0
    xyz = _scene(rng, n=768)
    xi = np.array([0.001, 0.004, -0.002, 0.02, 0.01, 0.1], np.float32)
    R_m, t_m = lie.se3_exp(jnp.asarray(xi), 1.0)
    xyz2 = np.asarray(xyz @ np.asarray(R_m).T + np.asarray(t_m))
    src = make_pointcloud(xyz, bucket=256)
    tgt = make_pointcloud(xyz2, bucket=256)
    ig = jnp.eye(4)
    T1, r1, i1 = align(src, tgt, ig, params, backend="jnp", max_iter=250)
    T2, r2, i2 = align(src, tgt, ig, params, backend="ell", max_iter=250,
                       nl_k=640, nl_builder="scan")
    assert int(i2.nl_overflow) == 0
    # identical math modulo f32 summation order (the K-major layout reduces
    # over sublanes); 250 gradient-flow iterations at ell=3 amplify the
    # reassociation to a few mm of translation
    assert float(jnp.max(jnp.abs(T1 - T2))) < 8e-3


def test_align_scan_no_geometry_channel(rng):
    """With the geometric channel off, the kernel is pose-independent: the
    value-ranked scan list is exact, built once, never rebuilt — and the
    align trajectory matches the dense backend."""
    params = _params(is_using_geometry=0, is_using_intensity=1,
                     c_ell=0.3, c_sigma=1.0, sp_thres=0.01,
                     max_step=0.02)
    xyz = _scene(rng, n=512, spread=4.0)
    feats = rng.uniform(0, 1, (512, 3)).astype(np.float32)
    xi = np.array([0.0, 0.002, -0.001, 0.02, 0.01, 0.05], np.float32)
    R_m, t_m = lie.se3_exp(jnp.asarray(xi), 1.0)
    xyz2 = np.asarray(xyz @ np.asarray(R_m).T + np.asarray(t_m))
    src = make_pointcloud(xyz, features=feats, bucket=512)
    tgt = make_pointcloud(xyz2, features=feats, bucket=512)
    ig = jnp.eye(4)
    T1, r1, i1 = align(src, tgt, ig, params, backend="jnp", max_iter=60)
    T2, r2, i2 = align(src, tgt, ig, params, backend="ell", max_iter=60,
                       nl_k=512)
    assert int(i2.nl_rebuilds) == 1  # pose-independent kernel: one build
    assert int(i2.nl_overflow) == 0
    assert float(jnp.max(jnp.abs(T1 - T2))) < 2e-3


# ------------------------------------ ELL consume vs the float64 oracle


@pytest.mark.parametrize("channels,tol", [
    ("geometric", 1e-3),
    # the channel factors shrink A ~1000x, so the net flow is ~1e-5 of the
    # per-row moments it is the difference of; f32 rounding of those
    # moments (~4e-7 relative, measured) then shows at ~8e-3 of the unit
    # twist and ~3e-3 of B in the dense jnp pass as well — the bound is
    # the f32 formulation's, not the ELL list's
    ("intensity+semantic", 2e-2),
])
def test_ell_consume_matches_float64_oracle(rng, channels, tol):
    """The ELL consume passes (flow stats, twist, step coefficients B..E)
    against the plain float64 NumPy transcription of the reference kernels
    (tests/oracle.py), including padded dead slots and the channel factor
    cached at build. Tolerances: f32 sums over <= N*K terms in another
    order than the oracle's float64 loops."""
    from oracle import oracle_flow, oracle_kernel_matrix, oracle_step_coeffs

    kw = {}
    if channels != "geometric":
        kw = dict(is_using_intensity=1, c_ell=0.5, c_sigma=1.0,
                  is_using_semantics=1, s_ell=0.6, s_sigma=1.0)
    params = _params(**kw)
    n = 200
    xyz = _scene(rng, n=n, spread=4.0)
    feats = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    xi = np.array([0.002, 0.005, -0.001, 0.05, 0.02, 0.2], np.float32)
    R_m, t_m = lie.se3_exp(jnp.asarray(xi), 1.0)
    xyz2 = np.asarray(xyz @ np.asarray(R_m).T + np.asarray(t_m))
    extra = {} if channels == "geometric" else dict(features=feats,
                                                    labels=labels)
    src = make_pointcloud(xyz, bucket=256, **extra)   # bucket pads -> dead
    tgt = make_pointcloud(xyz2, bucket=256, **extra)
    Rinv, Tinv = lie.invert_rt(jnp.asarray(R_m), jnp.asarray(t_m))
    ell = jnp.float32(params.ell_init)
    nl = nbr.build_neighbor_list(params, ell, src, tgt, Rinv, Tinv,
                                 k=64, skin=0.3, per_cell_cap=24)
    assert int(nl.overflow) == 0
    stats, a, yts = nbr.flow_stats_ell(params, ell, src, nl, Rinv, Tinv)
    twist, _ = kernels.flow_from_stats(params, src, stats)
    B, C, D, E = nbr.step_coeffs_ell(params, ell, src, a, yts, twist)

    x64 = xyz.astype(np.float64)
    y64 = xyz2.astype(np.float64) @ np.asarray(Rinv, np.float64).T + \
        np.asarray(Tinv, np.float64)
    ch = {} if channels == "geometric" else dict(
        xf=feats, yf=feats, xl=labels, yl=labels)
    A = oracle_kernel_matrix(params, float(ell), x64, y64, **ch)
    tw_ref, _ = oracle_flow(params, A, x64, y64)
    assert int(stats.nonzeros) == int((A > 0).sum())
    np.testing.assert_allclose(float(stats.a_sum), A.sum(), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(twist), tw_ref,
                               atol=tol * np.linalg.norm(tw_ref))
    ref = oracle_step_coeffs(params, A, float(ell), x64, y64,
                             np.asarray(twist[:3], np.float64),
                             np.asarray(twist[3:], np.float64))
    for name, g, r in zip("BCDE", (B, C, D, E), ref):
        np.testing.assert_allclose(float(g), r, rtol=tol,
                                   atol=tol * abs(ref[0]), err_msg=name)


def test_irls_edge_moments_ell_matches_dense(rng):
    """BA edge moments from the ELL list == the streaming dense pass."""
    from unified_cvo_tpu.models import irls

    params = _params(multiframe_ell_init=0.4)
    xyz1 = _scene(rng, n=2048)
    xyz2 = _scene(rng, n=2048) + np.float32([0.05, 0.0, 0.1])
    c1 = make_pointcloud(xyz1, bucket=2048)
    c2 = make_pointcloud(xyz2, bucket=2048)
    T1 = np.eye(3, 4, dtype=np.float32)
    xi = np.array([0.004, -0.002, 0.003, 0.02, 0.01, -0.03], np.float32)
    Rd, td = lie.se3_exp(jnp.asarray(xi), 1.0)
    T2 = np.concatenate([np.asarray(Rd), np.asarray(td)[:, None]], 1).astype(np.float32)
    ell = jnp.float32(0.4)

    ref = irls._edge_moments_single(params, ell, c1, c2,
                                    jnp.asarray(T1), jnp.asarray(T2), 512)
    got = irls._edge_moments_single_ell(params, ell, c1, c2,
                                        jnp.asarray(T1), jnp.asarray(T2),
                                        nl_k=192, nl_per_cell=32)
    assert int(got.nonzeros) == int(ref.nonzeros)
    for name in ("P11", "P12", "P22"):
        np.testing.assert_allclose(
            getattr(got, name), getattr(ref, name), rtol=2e-4, atol=2e-3,
            err_msg=name)
