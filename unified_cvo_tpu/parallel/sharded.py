"""Multi-chip sharding of the registration workload over a device Mesh.

The reference is single-process single-GPU (SURVEY.md §2.7); this module is
the multi-device scaling design:

  * **dp** — data parallel over frame *pairs*: batched frame-to-frame
    alignments, one (or more) pairs per device. Embarrassingly parallel;
    measures frames/s/chip scaling.
  * **sp** — "sequence"/point parallel: the target cloud's point dimension is
    sharded across devices; every device computes kernel-tile partials
    against the replicated source and the flow/step reductions are combined
    with `psum` over the sp axis. This is the context-parallel analogue for
    the N x M pairwise kernel (SURVEY.md §5): N x M never materializes on any
    one chip.

Both compose on a 2-D (dp, sp) mesh via `shard_map`; XLA hands the
collectives to NCCL on GPUs.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from unified_cvo_tpu.config import CvoParams
from unified_cvo_tpu.ops import kernels, lie
from unified_cvo_tpu.ops.poly import step_from_poly
from unified_cvo_tpu.utils.pointcloud import PointCloud


def make_mesh(n_devices: Optional[int] = None, sp: int = 1) -> Mesh:
    devices = jax.devices()[: n_devices or len(jax.devices())]
    n = len(devices)
    assert n % sp == 0, (n, sp)
    import numpy as np

    return Mesh(np.asarray(devices).reshape(n // sp, sp), ("dp", "sp"))


def _align_iteration_local(params, sp_axis, src: PointCloud, tgt_shard: PointCloud, R, T, ell):
    """One gradient-flow iteration for one pair; target points sharded on
    `sp_axis` (None => single-device). Returns updated (R, T) + metrics."""
    Rinv, Tinv = lie.invert_rt(R, T)
    y_t = tgt_shard.transformed(Rinv, Tinv)
    stats = kernels.flow_stats(params, ell, src, y_t, chunk=min(512, y_t.capacity))
    if sp_axis is not None:
        stats = jax.tree.map(lambda v: lax.psum(v, sp_axis), stats)
    twist, joint_norm = kernels.flow_from_stats(params, src, stats)
    B, C, D, E = kernels.step_coeffs(
        params, ell, src, y_t, twist, chunk=min(512, y_t.capacity)
    )
    if sp_axis is not None:
        B, C, D, E = (lax.psum(v, sp_axis) for v in (B, C, D, E))
    step = step_from_poly(B, C, D, E, params.min_step, params.max_step)
    dR, dT = lie.se3_exp(twist, step)
    R_new = R @ dR
    T_new = R @ dT + T
    metrics = {
        "step": step,
        "inner_product": stats.a_sum,
        "nonzeros": stats.nonzeros,
        "flow_norm": joint_norm,
    }
    return R_new, T_new, metrics


def make_sharded_full_align(params: CvoParams, mesh: Mesh, axis: str = "sp",
                            chunk: int = 512, max_iter: Optional[int] = None):
    """The COMPLETE while-loop aligner (indicator, ell schedule,
    convergence breaks — models/align.py) with the target's point dimension
    sharded over `axis`: every flow/step reduction psums across the mesh
    each iteration, so one 100k+-point registration runs end-to-end across
    devices (the sharded composition of the reference's whole align_impl
    loop, CvoGPU.cu:1340-1572).

    Returns align_fn(source, target, init_guess) ->
    (transform [4,4], ret, info dict); source replicated, target sharded
    on its point axis. Parity with single-device align(backend='jnp') is
    exact modulo psum summation order (tests/test_parallel.py).
    """
    from unified_cvo_tpu.models.align import align

    def local(src, tgt_shard, ig):
        T, ret, info = align(
            src, tgt_shard, ig, params, chunk=chunk, max_iter=max_iter,
            psum_axis=axis)
        return T, ret, {
            "iterations": info.iterations, "final_ell": info.final_ell,
            "nonzeros": info.nonzeros, "inner_product": info.inner_product,
        }

    def cloud_spec(pc: PointCloud, shard: bool):
        lead = (axis,) if shard else (None,)
        return jax.tree.map(
            lambda a: P(*(lead + (None,) * (a.ndim - 1))), pc)

    @jax.jit
    def full(src, tgt, ig):
        fn = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(cloud_spec(src, False), cloud_spec(tgt, True), P()),
            out_specs=(P(), P(), {k: P() for k in (
                "iterations", "final_ell", "nonzeros", "inner_product")}),
            check_vma=False,
        )
        return fn(src, tgt, ig)

    return full


def make_batched_align_step(params: CvoParams, mesh: Mesh):
    """Jitted (src_batch, tgt_batch, R[B,3,3], T[B,3], ell[B]) -> updated.

    Pair batch sharded over 'dp'; each pair's target points sharded over
    'sp'. The full step — kernel tiles, flow psum over sp, quartic step
    solve, pose update — is one XLA program over the mesh.
    """

    def local_step(src_b, tgt_b, R_b, T_b, ell_b):
        fn = functools.partial(_align_iteration_local, params, "sp")
        return jax.vmap(fn)(src_b, tgt_b, R_b, T_b, ell_b)

    def cloud_spec(point_axis):
        # spec pytree mirroring PointCloud structure; None fields stay None
        def leaf(ndim):
            return P(*(("dp", point_axis) + (None,) * (ndim - 2)))

        return PointCloud(
            xyz=leaf(3), mask=leaf(2), features=leaf(3), labels=None,
            geometric_types=leaf(3),
        )

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            cloud_spec(None),         # source: replicated over sp
            cloud_spec("sp"),         # target: point-sharded over sp
            P("dp", None, None),
            P("dp", None),
            P("dp"),
        ),
        out_specs=(
            P("dp", None, None),
            P("dp", None),
            {
                "step": P("dp"),
                "inner_product": P("dp"),
                "nonzeros": P("dp"),
                "flow_norm": P("dp"),
            },
        ),
        check_vma=False,
    )
    return jax.jit(sharded)
