"""Ring context-parallelism and batched DP alignment on the 8-device mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from unified_cvo_tpu.config import CvoParams
from unified_cvo_tpu.models.align import align
from unified_cvo_tpu.ops import kernels, lie
from unified_cvo_tpu.parallel.batch_align import make_batch_align, stack_pairs
from unified_cvo_tpu.parallel.ring import make_ring_align_iteration
from unified_cvo_tpu.utils.pointcloud import make_pointcloud


@pytest.fixture(scope="module")
def params():
    return CvoParams(ell_init=0.5, is_using_intensity=1, max_step=0.05)


def _pair(seed, n=256):
    import __graft_entry__ as ge

    return ge._synthetic_pair(n=n, m=n, seed=seed)


def test_ring_iteration_matches_single_device(params):
    """Both-clouds-sharded ring rotation must reproduce the single-device
    gradient-flow iteration."""
    devices = jax.devices()[:8]
    mesh = Mesh(np.asarray(devices), ("sp",))
    src, tgt = _pair(0, n=512)  # 512 points -> 64 per device
    step_fn = make_ring_align_iteration(params, mesh, chunk=64)
    R0 = jnp.eye(3, dtype=jnp.float32)
    T0 = jnp.zeros((3,), jnp.float32)
    R1, T1, m1 = step_fn(src, tgt, R0, T0, jnp.float32(0.5))

    # single-device oracle
    from unified_cvo_tpu.parallel.sharded import _align_iteration_local

    R2, T2, m2 = _align_iteration_local(params, None, src, tgt, R0, T0,
                                        jnp.float32(0.5))
    np.testing.assert_allclose(np.asarray(R1), np.asarray(R2), atol=2e-6)
    np.testing.assert_allclose(np.asarray(T1), np.asarray(T2), atol=2e-6)
    assert int(m1["nonzeros"]) == int(m2["nonzeros"])
    np.testing.assert_allclose(float(m1["a_sum"]), float(m2["inner_product"]),
                               rtol=1e-5)


def test_batch_align_matches_sequential(params):
    B = 4
    pairs = [_pair(s, n=192) for s in range(B)]
    src_b, tgt_b = stack_pairs([p[0] for p in pairs], [p[1] for p in pairs])
    init_b = jnp.tile(jnp.eye(4, dtype=jnp.float32)[None], (B, 1, 1))

    batch_fn = make_batch_align(params, mesh=None, chunk=192, max_iter=25)
    Tb, rets, iters = batch_fn(src_b, tgt_b, init_b)
    for b in range(B):
        T1, ret1, info1 = align(pairs[b][0], pairs[b][1], jnp.eye(4), params,
                                chunk=192, max_iter=25)
        # vmapped while-loop reassociates f32 reductions: small tolerance
        np.testing.assert_allclose(np.asarray(Tb[b]), np.asarray(T1), atol=2e-3)
        assert int(iters[b]) == int(info1.iterations)


def test_batch_align_sharded_over_mesh(params):
    devices = jax.devices()[:8]
    mesh = Mesh(np.asarray(devices), ("dp",))
    B = 8
    pairs = [_pair(s, n=128) for s in range(B)]
    src_b, tgt_b = stack_pairs([p[0] for p in pairs], [p[1] for p in pairs])
    init_b = jnp.tile(jnp.eye(4, dtype=jnp.float32)[None], (B, 1, 1))
    batch_fn = make_batch_align(params, mesh=mesh, chunk=128, max_iter=15)
    Tb, rets, iters = batch_fn(src_b, tgt_b, init_b)
    assert Tb.shape == (B, 4, 4)
    assert bool(jnp.all(jnp.isfinite(Tb)))
    # spot-check one lane against the unsharded path
    T0, _, info0 = align(pairs[3][0], pairs[3][1], jnp.eye(4), params,
                         chunk=128, max_iter=15)
    np.testing.assert_allclose(np.asarray(Tb[3]), np.asarray(T0), atol=2e-3)


def test_full_align_sharded_sp_matches_single_device(params):
    """The COMPLETE while-loop aligner (indicator, ell
    schedule, convergence) under sp target-sharding must match the
    single-device align trajectory."""
    from unified_cvo_tpu.parallel.sharded import make_sharded_full_align

    devices = jax.devices()[:8]
    mesh = Mesh(np.asarray(devices), ("sp",))
    src, tgt = _pair(0, n=512)
    ig = jnp.eye(4, dtype=jnp.float32)
    T_ref, ret_ref, info_ref = align(src, tgt, ig, params, backend="jnp",
                                     max_iter=120, chunk=512)
    full = make_sharded_full_align(params, mesh, chunk=64, max_iter=120)
    T_sh, ret_sh, info_sh = full(src, tgt, ig)
    # same schedule decisions (psum'd nonzeros drive the indicator), same
    # trajectory modulo f32 psum ordering
    assert int(info_sh["iterations"]) == int(info_ref.iterations)
    np.testing.assert_allclose(float(info_sh["final_ell"]),
                               float(info_ref.final_ell), rtol=1e-6)
    # per-shard chunking + psum reorder f32 sums; over ~120 iterations the
    # trajectories track to mm scale, not bitwise
    np.testing.assert_allclose(np.asarray(T_sh), np.asarray(T_ref), atol=5e-3)


def test_full_align_ring_matches_single_device(params):
    """Both-clouds-sharded ring full align to convergence == single-device
    align."""
    from unified_cvo_tpu.parallel.ring import make_ring_full_align

    devices = jax.devices()[:8]
    mesh = Mesh(np.asarray(devices), ("sp",))
    src, tgt = _pair(0, n=512)
    ig = jnp.eye(4, dtype=jnp.float32)
    T_ref, ret_ref, info_ref = align(src, tgt, ig, params, backend="jnp",
                                     max_iter=120, chunk=512)
    full = make_ring_full_align(params, mesh, chunk=64, max_iter=120)
    T_sh, ret_sh, info_sh = full(src, tgt, ig)
    assert int(info_sh["iterations"]) == int(info_ref.iterations)
    np.testing.assert_allclose(float(info_sh["final_ell"]),
                               float(info_ref.final_ell), rtol=1e-6)
    # rotating per-shard partial sums reorder every f32 reduction; over 120
    # not-yet-converged iterations the trajectories track to ~cm scale (the
    # schedule identity above is the structural assertion)
    np.testing.assert_allclose(np.asarray(T_sh)[:3, :3],
                               np.asarray(T_ref)[:3, :3], atol=1e-3)
    np.testing.assert_allclose(np.asarray(T_sh)[:3, 3],
                               np.asarray(T_ref)[:3, 3], atol=2e-2)
