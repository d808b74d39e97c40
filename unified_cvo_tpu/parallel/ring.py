"""Ring context-parallelism: the N x M pairwise kernel with BOTH clouds
sharded across the mesh and target blocks rotating via ppermute.

SURVEY.md §5's "long-context" analogue: the reference caps point count at
~15-30k because its O(N*M) kernel and GPU memory bound it; here source
points shard across devices (each device owns its kernel *rows*) and the
target shard rotates around the ring (ring-attention-style), so the full
N x M product is covered in P steps while no device ever holds more than
N/P + M/P points. Per-row flow statistics stay device-local (owned rows);
only the tiny scalar reductions cross the ring at the end.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from unified_cvo_tpu.config import CvoParams
from unified_cvo_tpu.ops import kernels, lie
from unified_cvo_tpu.ops.poly import step_from_poly
from unified_cvo_tpu.utils.pointcloud import PointCloud


def _rotate_cloud(pc: PointCloud, axis: str) -> PointCloud:
    """Send this device's target shard to the next ring neighbor."""
    n = lax.axis_size(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    return jax.tree.map(
        lambda a: None if a is None else lax.ppermute(a, axis, perm), pc
    )


def ring_flow_stats(params, ell, x_shard: PointCloud, y_shard: PointCloud,
                    axis: str, chunk: int = 512) -> kernels.FlowStats:
    """FlowStats for the full pair from sharded clouds. Row stats are local
    to the source shard (concatenating across devices = full rows); nonzeros
    and a_sum are psum'd."""
    n_steps = lax.axis_size(axis)

    def body(carry, _):
        (y_cur, s, w, cnt, asum) = carry
        # issue the ring rotation BEFORE the kernel math: y_next and the
        # flow stats both depend only on y_cur, so the collective permute
        # and this step's compute are dataflow-independent and XLA's async
        # collective scheduling can overlap them (communication hides
        # behind the N/P x M/P kernel block; PERF.md ring note)
        y_next = _rotate_cloud(y_cur, axis)
        st = kernels.flow_stats(params, ell, x_shard, y_cur, chunk)
        carry = (
            y_next,
            s + st.row_sum,
            w + st.row_wy,
            cnt + st.nonzeros,
            asum + st.a_sum,
        )
        return carry, None

    N = x_shard.capacity
    init = (
        y_shard,
        jnp.zeros((N,), jnp.float32),
        jnp.zeros((N, 3), jnp.float32),
        jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.float32),
    )
    (_, s, w, cnt, asum), _ = lax.scan(body, init, None, length=n_steps)
    return kernels.FlowStats(s, w, lax.psum(cnt, axis), lax.psum(asum, axis))


def ring_step_coeffs(params, ell, x_shard: PointCloud, y_shard: PointCloud,
                     twist, axis: str, chunk: int = 512):
    n_steps = lax.axis_size(axis)

    def body(carry, _):
        y_cur, B, C, D, E = carry
        y_next = _rotate_cloud(y_cur, axis)   # independent of this step's
        #   coefficients -> overlappable (see ring_flow_stats note)
        b, c, d, e = kernels.step_coeffs(params, ell, x_shard, y_cur, twist, chunk)
        return (y_next, B + b, C + c, D + d, E + e), None

    z = jnp.zeros((), jnp.float32)
    (_, B, C, D, E), _ = lax.scan(body, (y_shard, z, z, z, z), None, length=n_steps)
    return (lax.psum(B, axis), lax.psum(C, axis), lax.psum(D, axis),
            lax.psum(E, axis))


def make_ring_full_align(params: CvoParams, mesh: Mesh, axis: str = "sp",
                         chunk: int = 512, max_iter=None):
    """The COMPLETE while-loop aligner with BOTH clouds point-sharded and
    target blocks rotating through the ring every iteration — the
    full-loop composition of the context-parallel kernel above. No device
    ever holds more than N/P + M/P points while the whole align schedule
    (indicator, ell decay, convergence) runs to completion on-device.

    Returns align_fn(source, target, init_guess) ->
    (transform [4,4], ret, info dict), both clouds sharded on their point
    axis over `axis`.
    """
    from unified_cvo_tpu.models.align import align

    def local(x_shard, y_shard, ig):
        T, ret, info = align(
            x_shard, y_shard, ig, params, chunk=chunk, max_iter=max_iter,
            ring_axis=axis)
        return T, ret, {
            "iterations": info.iterations, "final_ell": info.final_ell,
            "nonzeros": info.nonzeros, "inner_product": info.inner_product,
        }

    def cloud_spec(pc: PointCloud):
        return jax.tree.map(
            lambda a: P(*((axis,) + (None,) * (a.ndim - 1))), pc)

    @functools.partial(jax.jit)
    def full(x, y, ig):
        fn = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(cloud_spec(x), cloud_spec(y), P()),
            out_specs=(P(), P(), {k: P() for k in (
                "iterations", "final_ell", "nonzeros", "inner_product")}),
            check_vma=False,
        )
        return fn(x, y, ig)

    return full


def make_ring_align_iteration(params: CvoParams, mesh: Mesh, axis: str = "sp",
                              chunk: int = 512):
    """Jitted one-iteration gradient-flow step with both clouds sharded on
    `axis` along the point dimension. Returns (R', T', metrics)."""

    def local(x_shard, y_shard, R, T, ell):
        Rinv, Tinv = lie.invert_rt(R, T)
        y_t = y_shard.transformed(Rinv, Tinv)
        stats = ring_flow_stats(params, ell, x_shard, y_t, axis, chunk)
        # flow reduction over the *local* rows, then psum the 6-vector
        omega = jnp.sum(jnp.cross(x_shard.xyz, stats.row_wy), axis=0) / params.c
        v = jnp.sum(stats.row_wy - stats.row_sum[:, None] * x_shard.xyz, axis=0) / params.d
        joint = lax.psum(jnp.concatenate([omega, v]), axis)
        jn = jnp.linalg.norm(joint)
        twist = joint / jnp.where(jn < 1e-30, 1.0, jn)
        B, C, D, E = ring_step_coeffs(params, ell, x_shard, y_t, twist, axis, chunk)
        step = step_from_poly(B, C, D, E, params.min_step, params.max_step)
        dR, dT = lie.se3_exp(twist, step)
        return R @ dR, R @ dT + T, {
            "step": step, "nonzeros": stats.nonzeros, "a_sum": stats.a_sum,
            "flow_norm": jn,
        }

    def cloud_spec(pc: PointCloud):
        return jax.tree.map(
            lambda a: P(*((axis,) + (None,) * (a.ndim - 1))), pc
        )

    @functools.partial(jax.jit)
    def step(x, y, R, T, ell):
        fn = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(cloud_spec(x), cloud_spec(y), P(), P(), P()),
            out_specs=(P(), P(), {"step": P(), "nonzeros": P(), "a_sum": P(),
                                  "flow_norm": P()}),
            check_vma=False,
        )
        return fn(x, y, R, T, ell)

    return step
