"""Blocked kernel reductions vs the NumPy oracle transcriptions."""

import numpy as np
import pytest

import jax.numpy as jnp

from unified_cvo_tpu.config import CvoParams
from unified_cvo_tpu.ops import kernels
from unified_cvo_tpu.utils.pointcloud import make_pointcloud

from oracle import oracle_kernel_matrix, oracle_flow, oracle_step_coeffs


def _random_clouds(rng, n=40, m=56, features=False, labels=False, geo=False):
    x = rng.normal(scale=1.0, size=(n, 3)).astype(np.float32)
    y = x[: m] + rng.normal(scale=0.15, size=(min(n, m), 3)).astype(np.float32) \
        if m <= n else np.concatenate([
            x + rng.normal(scale=0.15, size=(n, 3)).astype(np.float32),
            rng.normal(scale=1.0, size=(m - n, 3)).astype(np.float32)])
    kw_x, kw_y = {}, {}
    if features:
        kw_x["features"] = rng.uniform(size=(n, 5)).astype(np.float32)
        kw_y["features"] = rng.uniform(size=(m, 5)).astype(np.float32)
    if labels:
        lx = rng.uniform(size=(n, 4)).astype(np.float32)
        ly = rng.uniform(size=(m, 4)).astype(np.float32)
        kw_x["labels"] = lx / lx.sum(1, keepdims=True)
        kw_y["labels"] = ly / ly.sum(1, keepdims=True)
    if geo:
        kw_x["geometric_types"] = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
        kw_y["geometric_types"] = np.eye(2, dtype=np.float32)[rng.integers(0, 2, m)]
    return x, y, kw_x, kw_y


@pytest.mark.parametrize(
    "flags",
    [
        dict(is_using_geometry=1),
        dict(is_using_geometry=1, is_using_intensity=1),
        dict(is_using_geometry=1, is_using_intensity=1, is_using_semantics=1),
        dict(is_using_geometry=1, is_using_geometric_type=1),
        dict(is_using_geometry=1, is_using_intensity=1, is_using_geometric_type=1),
    ],
)
def test_kernel_block_matches_oracle(flags, rng):
    p = CvoParams(sp_thres=0.002).replace(**flags)
    ell = 0.4
    x, y, kw_x, kw_y = _random_clouds(
        rng,
        features="is_using_intensity" in flags,
        labels="is_using_semantics" in flags,
        geo="is_using_geometric_type" in flags,
    )
    A_ref = oracle_kernel_matrix(
        p, ell, x, y,
        kw_x.get("features"), kw_y.get("features"),
        kw_x.get("labels"), kw_y.get("labels"),
        kw_x.get("geometric_types"), kw_y.get("geometric_types"),
    )
    # capacity == exact size so the block compares 1:1
    pcx = make_pointcloud(x, bucket=1, **kw_x)
    pcy = make_pointcloud(y, bucket=1, **kw_y)
    A = np.asarray(kernels.kernel_block(p, jnp.float32(ell), pcx, pcy))
    np.testing.assert_allclose(A, A_ref, rtol=2e-4, atol=1e-7)


def test_kernel_block_masks_padding(rng):
    p = CvoParams()
    x, y, _, _ = _random_clouds(rng)
    pcx = make_pointcloud(x, bucket=64)
    pcy = make_pointcloud(y, bucket=64)
    A = np.asarray(kernels.kernel_block(p, jnp.float32(0.5), pcx, pcy))
    assert A.shape == (64, 64)
    assert np.all(A[len(x):, :] == 0)
    assert np.all(A[:, len(y):] == 0)


def test_flow_stats_matches_oracle(rng):
    p = CvoParams(sp_thres=0.002)
    ell = 0.5
    x, y, _, _ = _random_clouds(rng, n=40, m=64)
    A_ref = oracle_kernel_matrix(p, ell, x, y)
    pcx = make_pointcloud(x, bucket=8)
    pcy = make_pointcloud(y, bucket=8)
    stats = kernels.flow_stats(p, jnp.float32(ell), pcx, pcy, chunk=16)
    n = len(x)
    np.testing.assert_allclose(np.asarray(stats.row_sum)[:n], A_ref.sum(1), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(stats.row_wy)[:n], A_ref @ y, rtol=1e-4, atol=1e-5)
    assert int(stats.nonzeros) == int((A_ref > 0).sum())
    np.testing.assert_allclose(float(stats.a_sum), A_ref.sum(), rtol=1e-4)

    twist, jn = kernels.flow_from_stats(p, pcx, stats)
    twist_ref, jn_ref = oracle_flow(p, A_ref, x, y)
    np.testing.assert_allclose(np.asarray(twist), twist_ref, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(float(jn), jn_ref, rtol=1e-3)


@pytest.mark.parametrize("use_range_ell", [0, 1])
def test_step_coeffs_match_oracle(use_range_ell, rng):
    p = CvoParams(sp_thres=0.002, is_using_range_ell=use_range_ell)
    ell = 0.5
    x, y, _, _ = _random_clouds(rng, n=32, m=48)
    A_ref = oracle_kernel_matrix(p, ell, x, y)
    twist_ref, _ = oracle_flow(p, A_ref, x, y)
    pcx = make_pointcloud(x, bucket=16)
    pcy = make_pointcloud(y, bucket=16)
    B, C, D, E = kernels.step_coeffs(
        p, jnp.float32(ell), pcx, pcy, jnp.asarray(twist_ref, jnp.float32), chunk=16
    )
    B_ref, C_ref, D_ref, E_ref = oracle_step_coeffs(
        p, A_ref, ell, x, y, twist_ref[:3], twist_ref[3:]
    )
    for got, want in zip((B, C, D, E), (B_ref, C_ref, D_ref, E_ref)):
        np.testing.assert_allclose(float(got), want, rtol=5e-3, atol=1e-5)


def test_association_topk(rng):
    p = CvoParams(sp_thres=0.002)
    ell = 0.5
    x, y, _, _ = _random_clouds(rng, n=24, m=40)
    A_ref = oracle_kernel_matrix(p, ell, x, y)
    pcx = make_pointcloud(x, bucket=8)
    pcy = make_pointcloud(y, bucket=8)
    k = 8
    vals, idx = kernels.association_topk(p, jnp.float32(ell), pcx, pcy, k, chunk=8)
    vals, idx = np.asarray(vals), np.asarray(idx)
    for i in range(len(x)):
        row = A_ref[i]
        want = np.sort(row[row > 0])[::-1][:k]
        got = vals[i][vals[i] > 0]
        np.testing.assert_allclose(np.sort(got)[::-1], want.astype(np.float32), rtol=1e-4)
        for v, j in zip(vals[i], idx[i]):
            if v > 0:
                assert j >= 0 and np.isclose(row[j], v, rtol=1e-4)
            else:
                assert j == -1


@pytest.mark.parametrize("flags", [
    dict(),
    dict(is_using_intensity=1, c_ell=0.5, c_sigma=1.0),
    dict(is_using_range_ell=1),
])
def test_row_chunked_oracle_matches_loop_oracle(flags, rng):
    """oracle_dense_moments (the float64 reference the chip smoke compares
    16k x 16k passes with) reproduces the literal loop oracles."""
    from oracle import oracle_dense_moments

    p = CvoParams(sp_thres=0.002, **flags)
    x, y, kw_x, kw_y = _random_clouds(rng, n=40, m=33,
                                      features=bool(flags))
    x, y = x.astype(np.float64), y.astype(np.float64)   # both in float64
    xf, yf = kw_x.get("features"), kw_y.get("features")
    if flags:
        xf, yf = xf.astype(np.float64), yf.astype(np.float64)
    A = oracle_kernel_matrix(p, 0.45, x, y, xf, yf)
    tw, norm = oracle_flow(p, A, x, y)
    ref = oracle_step_coeffs(p, A, 0.45, x, y, tw[:3], tw[3:])
    got = oracle_dense_moments(p, 0.45, x, y, [tw], rows=7, xf=xf, yf=yf)
    assert got["nonzeros"] == int((A > 0).sum())
    np.testing.assert_allclose(got["a_sum"], A.sum(), rtol=1e-12)
    np.testing.assert_allclose(got["twist"], tw, atol=1e-12)
    np.testing.assert_allclose(got["joint_norm"], norm, rtol=1e-12)
    np.testing.assert_allclose(got["steps"][0], ref, rtol=1e-10, atol=1e-12)
