"""Pairwise RKHS registration by se(3) gradient flow — the CvoGPU::align twin.

The whole iteration loop lives inside ONE jitted `lax.while_loop`
(carrying pose, lengthscale, and the indicator windows), eliminating the
reference's per-iteration host round-trips (R,T up / omega,v,B..E down each
iteration; reference align_impl, src/cvo/CvoGPU.cu:1340-1572).

Loop structure per iteration (matching align_impl's order):
  1. y_t = (R,T)^{-1} . y0          (update_tf + transform_pointcloud_thrust)
  2. streaming kernel pass -> flow stats -> normalized twist   (se_kernel +
     compute_flow)
  3. streaming pass 2 -> B,C,D,E -> cubic step size            (compute_step_size)
  4. degenerate-flow break (ret=-1)                            (CvoGPU.cu:1454-1458)
  5. pose update R <- R dR, T <- R dT + T with (dR,dT)=exp(step*twist)
  6. step-distance break: ||log(dR,dT)|| < eps_2               (CvoGPU.cu:1505-1508)
  7. indicator update; if k > ell_decay_start and the two indicator windows
     agree: ell <- max(ell * decay, ell_min)                   (CvoGPU.cu:1509-1517)

Transform conventions follow the reference exactly: the loop state (R,T) is
initialized from init_guess and the *returned* transform is its inverse
[R^T, -R^T T], i.e. the map taking target-frame points into the source frame
(update_tf, CvoGPU.cu:94-112).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from unified_cvo_tpu.config import CvoParams
from unified_cvo_tpu.ops import indicator as indicator_ops
from unified_cvo_tpu.ops import kernels, lie
from unified_cvo_tpu.ops.poly import step_from_poly
from unified_cvo_tpu.utils.pointcloud import PointCloud


class AlignInfo(NamedTuple):
    iterations: jax.Array
    final_ell: jax.Array
    final_step: jax.Array
    final_dist: jax.Array
    nonzeros: jax.Array
    inner_product: jax.Array
    history: Optional[dict] = None  # per-iteration logs when record_history
    nl_overflow: Optional[jax.Array] = None  # ELL backend: candidates dropped
    #   by the K / per-cell caps across builds (0 = the list was exact)
    nl_rebuilds: Optional[jax.Array] = None  # ELL backend: neighbor-list
    #   builds performed (>=1; each Verlet skin-drift trigger adds one)


class _Carry(NamedTuple):
    R: jax.Array
    T: jax.Array
    ell: jax.Array
    k: jax.Array
    done: jax.Array
    ret: jax.Array
    step: jax.Array
    dist: jax.Array
    nonzeros: jax.Array
    a_sum: jax.Array
    ind: indicator_ops.IndicatorState
    history: Optional[dict]
    nl_overflow: jax.Array  # ELL: dropped candidates across builds
    nl_rebuilds: jax.Array  # ELL: number of neighbor-list builds
    fresh: jax.Array        # ELL: just rebuilt -> inner loop must run once
    #   (structural progress guarantee: without it a drift test that fires
    #   immediately after a rebuild would livelock the nested loops)


BACKENDS = ("ell", "jnp")


def resolve_backend(params, source_cap: int, target_cap: int,
                    backend: str = "auto",
                    adaptive_ell: Optional[bool] = None) -> str:
    """The auto backend policy, shared by align() and align_core().

    'ell' (Verlet candidate list) for large clouds with a ranking channel
    and a support that the list can bound; 'jnp' (blocked dense N x M
    passes) for everything else: small clouds, whose dense scans are cheap
    while the K row cap would truncate dense-support kernels, and ACVO
    without the geometric channel. The choice depends on the
    configuration and the cloud sizes only, never on the platform."""
    if backend != "auto":
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown backend={backend!r}; expected 'auto' or one of "
                f"{BACKENDS}")
        return backend
    if adaptive_ell is None:
        adaptive_ell = bool(params.is_ell_adaptive)
    has_rank_channel = bool(
        params.is_using_geometry or params.is_using_intensity
        or params.is_using_semantics or params.is_using_geometric_type)
    if (
        has_rank_channel
        and (not adaptive_ell or bool(params.is_using_geometry))
        and source_cap >= 4096
        and target_cap >= 4096
    ):
        return "ell"
    return "jnp"


def resolve_nl_builder(params, source_cap: int, target_cap: int,
                       adaptive_ell: Optional[bool] = None) -> str:
    """The auto neighbor-list builder of the 'ell' backend.

    The voxel-grid builder needs a local support (cell size >= support +
    skin with bounded per-cell occupancy) and enough points that the grid
    pays for itself; the brute-force scan builder covers everything else
    (large support, small/dense clouds, channel-ranked no-geometry
    configs). ACVO can grow ell to ell_max, so the grid is gated on the
    largest support it may have to cover."""
    from unified_cvo_tpu.ops import neighbors as nbr

    if adaptive_ell is None:
        adaptive_ell = bool(params.is_ell_adaptive)
    radius = nbr.static_support_radius(params) * (
        float(params.ell_max) / max(float(params.ell_init), 1e-6)
        if adaptive_ell else 1.0)
    return "grid" if (
        bool(params.is_using_geometry)
        and radius <= 2.0
        and source_cap >= 4096
        and target_cap >= 4096
    ) else "scan"


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "record_history", "chunk", "max_iter", "backend",
        "adaptive_ell", "nl_k", "nl_skin", "nl_per_cell", "nl_builder",
        "psum_axis", "ring_axis",
    ),
)
def align_core(
    source: PointCloud,
    target: PointCloud,
    init_guess: jax.Array,
    params: CvoParams,
    record_history: bool = False,
    chunk: int = kernels.DEFAULT_CHUNK,
    max_iter: Optional[int] = None,
    backend: str = "auto",
    adaptive_ell: Optional[bool] = None,
    nl_k: Optional[int] = None,
    nl_skin: Optional[float] = None,
    nl_per_cell: Optional[int] = None,
    nl_builder: Optional[str] = None,
    psum_axis: Optional[str] = None,
    ring_axis: Optional[str] = None,
):
    """Register target onto source. Returns (transform[4,4], ret, AlignInfo).

    `init_guess` is in the same frame convention as CvoGPU::align's
    init_guess_transform argument (callers typically pass the inverse of the
    source->target prior; see main_cvo_gpu_align_two_color_pcd.cpp:71-82).

    backend: 'auto' picks 'ell' — a Verlet candidate list rebuilt on
    drift — for large clouds with a ranking channel; the blocked dense
    'jnp' passes cover small clouds and ACVO without geometry, and serve
    as the ELL path's parity oracle (resolve_backend).
    nl_builder: 'grid' (voxel-bucketed Verlet build, needs local geometric
    support) / 'scan' (brute-force chunked top-K build, any support
    radius or cloud size; with the geometric channel off the list is
    ranked by the pose-independent channel kernel value and never
    rebuilt) / None = auto. nl_k / nl_skin / nl_per_cell tune the
    candidate list (K nearest kept per source point — the reference
    kd-tree mode's K, cukdtree.h:12; skin = Verlet rebuild margin in
    meters).

    adaptive_ell: ACVO mode (reference AdaptiveCvoGPU.cu, ENABLE_ACVO
    variant) — instead of the indicator-window decay schedule, ell follows
    its own gradient each iteration:
      dl = (sum Axx d2 + sum Ayy d2 - 2 sum Axy d2) / ell^3
           / (nz_xx + nz_yy - 2 nz_xy)
      ell <- clip(ell - dl_step * dl, ell_min, ell_max)
    (gradient assembly at AdaptiveCvoGPU.cu:612-712, 869-885; update at
    :1198). Defaults to params.is_ell_adaptive.

    psum_axis / ring_axis: run the FULL while-loop aligner inside a
    shard_map over a device mesh (SURVEY.md §5 long-context plan; the
    sharded composition of the reference's whole align_impl loop,
    CvoGPU.cu:1340-1572). With psum_axis, `target` is this device's point
    shard (source replicated): flow/step reductions are psum'd over the
    axis every iteration. With ring_axis, BOTH clouds are point shards and
    target blocks rotate via ppermute (parallel/ring.py) so N x M never
    materializes on one device. Schedule state (ell, indicator, breaks) is
    driven by psum'd totals — every device takes identical branches. Use
    parallel.sharded.make_sharded_full_align / parallel.ring.
    make_ring_full_align for the wrapped entry points.
    """
    if adaptive_ell is None:
        adaptive_ell = bool(params.is_ell_adaptive)
    shard_axis = psum_axis or ring_axis
    if shard_axis is not None:
        if psum_axis is not None and ring_axis is not None:
            raise ValueError("psum_axis and ring_axis are mutually exclusive")
        if adaptive_ell:
            raise ValueError(
                "adaptive_ell is not supported under sharded align yet")
        if backend not in ("auto", "jnp"):
            raise ValueError(
                "sharded align runs the blocked-jnp kernels per shard; "
                f"backend={backend!r} is not supported with "
                "psum_axis/ring_axis")
        backend = "jnp"
    has_rank_channel = bool(
        params.is_using_geometry or params.is_using_intensity
        or params.is_using_semantics or params.is_using_geometric_type
    )
    backend = resolve_backend(params, source.capacity, target.capacity,
                              backend, adaptive_ell)
    f32 = jnp.float32
    max_iter = params.MAX_ITER if max_iter is None else max_iter
    R0 = jnp.asarray(init_guess[:3, :3], f32)
    T0 = jnp.asarray(init_guess[:3, 3], f32)
    nx = source.num_valid
    ny = target.num_valid
    if ring_axis is not None:
        nx = lax.psum(nx, ring_axis)
    if shard_axis is not None:
        ny = lax.psum(ny, shard_axis)
    sqrt_nxny = jnp.sqrt(jnp.maximum(nx * ny, 1.0))

    use_ell = backend == "ell"
    if use_ell:
        from unified_cvo_tpu.ops import neighbors as nbr

        # soundness preconditions of the candidate list: some channel must
        # rank candidates (distance, or the channel kernel value). Under
        # adaptive_ell (ACVO) the support can GROW, so the rebuild trigger
        # adds a k_lin * (ell - ell_build) growth bound
        # (nbr.stale_bound_exceeded) on top of the pose-drift bound, and
        # the dl gradient's Axx/Ayy/Axy sums consume three candidate
        # lists instead of dense N x M scans per iteration.
        if adaptive_ell and not params.is_using_geometry:
            raise ValueError(
                "backend='ell' with adaptive_ell needs the geometric "
                "channel (the ACVO dl gradient is geometric); use 'jnp'")
        if not has_rank_channel:
            raise ValueError(
                "backend='ell' needs at least one kernel channel to rank "
                "candidates; use 'jnp'")
        if nl_builder is None or nl_builder == "auto":
            nl_builder = resolve_nl_builder(
                params, source.capacity, target.capacity, adaptive_ell)
        if nl_builder == "grid" and not params.is_using_geometry:
            raise ValueError(
                "nl_builder='grid' needs the geometric channel to bound the "
                "voxel cell size; use nl_builder='scan'")
        nl_k = nbr.DEFAULT_K if nl_k is None else nl_k
        nl_skin = nbr.DEFAULT_SKIN if nl_skin is None else nl_skin
        nl_per_cell = nbr.PER_CELL_CAP if nl_per_cell is None else nl_per_cell

    if use_ell:
        flow_fn = step_fn = None
    elif ring_axis is not None:
        from unified_cvo_tpu.parallel import ring as ring_mod

        flow_fn = lambda p, ell, x, y_t: ring_mod.ring_flow_stats(
            p, ell, x, y_t, ring_axis, chunk)
        step_fn = lambda p, ell, x, y_t, tw: ring_mod.ring_step_coeffs(
            p, ell, x, y_t, tw, ring_axis, chunk)
    else:
        flow_fn = lambda p, ell, x, y_t: kernels.flow_stats(
            p, ell, x, y_t, chunk)
        step_fn = lambda p, ell, x, y_t, tw: kernels.step_coeffs(
            p, ell, x, y_t, tw, chunk)
        if psum_axis is not None:
            _flow, _step = flow_fn, step_fn
            flow_fn = lambda p, ell, x, y_t: jax.tree.map(
                lambda v: lax.psum(v, psum_axis), _flow(p, ell, x, y_t))
            step_fn = lambda p, ell, x, y_t, tw: tuple(
                lax.psum(v, psum_axis) for v in _step(p, ell, x, y_t, tw))

    if record_history:
        hist = {
            name: jnp.zeros((max_iter,), f32)
            for name in ("ell", "step", "dist", "ip", "nonzeros", "a_sum")
        }
    else:
        hist = None

    def cond(c: _Carry):
        return jnp.logical_not(c.done) & (c.k < max_iter)

    def body(c: _Carry) -> _Carry:
        Rinv, Tinv = lie.invert_rt(c.R, c.T)

        if use_ell:
            # the neighbor list is a closure constant of this inner loop
            # (no carry copies); the inner cond exits on drift and the
            # outer loop rebuilds. The flow pass hands its kernel matrix
            # and transformed slots to the step pass, so A is evaluated
            # once per iteration.
            stats, a_ell, y_t_slots = nbr.flow_stats_ell(
                params, c.ell, source, body.nl, Rinv, Tinv)
            twist, joint_norm = kernels.flow_from_stats(
                params, source, stats)
            B, C, D, E = nbr.step_coeffs_ell(
                params, c.ell, source, a_ell, y_t_slots, twist)
        else:
            y_t = target.transformed(Rinv, Tinv)
            stats = flow_fn(params, c.ell, source, y_t)
            twist, joint_norm = kernels.flow_from_stats(
                params, source, stats, psum_axis=ring_axis)
            B, C, D, E = step_fn(params, c.ell, source, y_t, twist)
        nonzeros, a_sum = stats.nonzeros, stats.a_sum
        step = step_from_poly(B, C, D, E, params.min_step, params.max_step)

        # degenerate-flow break (reference CvoGPU.cu:1452-1458). The eps test
        # on the *normalized* twist can only fire when the flow vanished, so
        # the operative check is the 1e-8 pre-normalization magnitude.
        degenerate = (joint_norm < 1e-8) | jnp.isnan(joint_norm)
        eps_break = (jnp.linalg.norm(twist[:3]) < params.eps) & (
            jnp.linalg.norm(twist[3:]) < params.eps
        )
        break_now = degenerate | eps_break

        dR, dT = lie.se3_exp(twist, step)
        R_new = c.R @ dR
        T_new = c.R @ dT + c.T
        dist = lie.se3_distance(dR, dT)
        nan_break = jnp.isnan(dist)

        ip_curr = nonzeros.astype(f32) / sqrt_nxny
        ind_new, decrease = indicator_ops.update(
            c.ind, ip_curr, params.indicator_stable_threshold
        )
        dist_break = dist < params.eps_2

        continuing = jnp.logical_not(break_now | nan_break | dist_break)
        if adaptive_ell:
            if use_ell:
                # dl gradient sums from the three candidate lists (xy, xx,
                # yy) instead of dense N x M scans. The yy list is consumed with the CURRENT transformed
                # target as the "source" side so the range-scaled l_i
                # matches the dense formulation exactly.
                I3 = jnp.eye(3, dtype=f32)
                z3 = jnp.zeros((3,), f32)
                y_t_c = target.transformed(Rinv, Tinv)
                s_xy = nbr.weighted_d2_sum_ell(
                    params, c.ell, source, body.nl, Rinv, Tinv)
                s_xx = nbr.weighted_d2_sum_ell(
                    params, c.ell, source, body.nl_xx, I3, z3)
                s_yy = nbr.weighted_d2_sum_ell(
                    params, c.ell, y_t_c, body.nl_yy, Rinv, Tinv)
            else:
                s_xy = kernels.weighted_d2_sum(params, c.ell, source, y_t, chunk)
                s_xx = kernels.weighted_d2_sum(params, c.ell, source, source, chunk)
                s_yy = kernels.weighted_d2_sum(params, c.ell, y_t, y_t, chunk)
            denom = (
                s_xx[1] + s_yy[1] - 2 * nonzeros
            ).astype(f32)
            dl = (s_xx[0] + s_yy[0] - 2.0 * s_xy[0]) / (c.ell**3) / jnp.where(
                denom == 0, 1.0, denom
            )
            ell_new = jnp.where(
                continuing,
                jnp.clip(
                    c.ell - params.dl_step * dl, params.ell_min, params.ell_max
                ),
                c.ell,
            )
        else:
            decay = (c.k > params.ell_decay_start) & decrease & continuing
            ell_new = jnp.where(
                decay,
                jnp.maximum(c.ell * params.ell_decay_rate, params.ell_min),
                c.ell,
            )

        keep_old_pose = break_now  # reference breaks before applying the update
        R_out = jnp.where(keep_old_pose, c.R, R_new)
        T_out = jnp.where(keep_old_pose, c.T, T_new)

        if c.history is not None:
            hist_new = {
                "ell": c.history["ell"].at[c.k].set(c.ell),
                "step": c.history["step"].at[c.k].set(step),
                "dist": c.history["dist"].at[c.k].set(dist),
                "ip": c.history["ip"].at[c.k].set(ip_curr),
                "nonzeros": c.history["nonzeros"].at[c.k].set(nonzeros.astype(f32)),
                "a_sum": c.history["a_sum"].at[c.k].set(a_sum),
            }
        else:
            hist_new = None

        return _Carry(
            R=R_out,
            T=T_out,
            ell=ell_new,
            k=c.k + 1,
            done=break_now | nan_break | dist_break,
            ret=jnp.where(degenerate, -1, 0).astype(jnp.int32),
            step=step,
            dist=dist,
            nonzeros=nonzeros,
            a_sum=a_sum,
            ind=ind_new,
            history=hist_new,
            nl_overflow=c.nl_overflow,
            nl_rebuilds=c.nl_rebuilds,
            fresh=jnp.zeros((), bool),
        )

    init = _Carry(
        R=R0,
        T=T0,
        ell=jnp.asarray(params.ell_init, f32),
        k=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool),
        ret=jnp.zeros((), jnp.int32),
        step=jnp.zeros((), f32),
        dist=jnp.zeros((), f32),
        nonzeros=jnp.zeros((), jnp.int32),
        a_sum=jnp.zeros((), f32),
        ind=indicator_ops.init_state(params.indicator_window_size),
        history=hist,
        nl_overflow=jnp.zeros((), jnp.int32),
        nl_rebuilds=jnp.zeros((), jnp.int32),
        fresh=jnp.zeros((), bool),
    )

    if use_ell:
        # Verlet nested loops: the outer loop rebuilds the candidate list at
        # the current pose/ell; the inner loop iterates gather-free with the
        # list as a closure constant, exiting when any target has drifted
        # more than skin since build (while drift < skin and ell only
        # decays, the list remains a superset of the kernel support).
        def inner_cond(c: _Carry):
            if not params.is_using_geometry:
                # the kernel is pose-independent: the value-ranked list is
                # exact for the whole solve, never rebuild
                return jnp.logical_not(c.done) & (c.k < max_iter)
            Rinv, Tinv = lie.invert_rt(c.R, c.T)
            # O(1) sound drift bound from the pose delta (can fire a little
            # early, never late) — replaces a per-point [M, 3] stream in
            # the cond of EVERY iteration
            if adaptive_ell:
                # ACVO: ell can GROW — add the support-growth bound, and
                # check all three lists (xx never drifts; the yy check
                # treats the full pose delta as candidate drift, which is
                # conservative: only its range-scaled l_i actually moves)
                I3 = jnp.eye(3, dtype=jnp.float32)
                z3 = jnp.zeros((3,), jnp.float32)
                drift = (
                    nbr.stale_bound_exceeded(
                        inner_cond.nl, Rinv, Tinv, c.ell, nl_skin)
                    | nbr.stale_bound_exceeded(
                        inner_cond.nl_xx, I3, z3, c.ell, nl_skin)
                    | nbr.stale_bound_exceeded(
                        inner_cond.nl_yy, Rinv, Tinv, c.ell, nl_skin))
            else:
                drift = nbr.drift_bound_exceeded(
                    inner_cond.nl, Rinv, Tinv, nl_skin)
            return (jnp.logical_not(c.done) & (c.k < max_iter)
                    & (c.fresh | ~drift))

        def outer_body(c: _Carry) -> _Carry:
            Rinv, Tinv = lie.invert_rt(c.R, c.T)
            if nl_builder == "scan":
                nl = nbr.build_neighbor_list_scan(
                    params, c.ell, source, target, Rinv, Tinv,
                    k=nl_k, skin=nl_skin, chunk=chunk)
            else:
                nl = nbr.build_neighbor_list(
                    params, c.ell, source, target, Rinv, Tinv,
                    k=nl_k, skin=nl_skin, per_cell_cap=nl_per_cell)
            overflow = nl.overflow
            if adaptive_ell:
                I3 = jnp.eye(3, dtype=jnp.float32)
                z3 = jnp.zeros((3,), jnp.float32)
                y_t_c = target.transformed(Rinv, Tinv)
                if nl_builder == "scan":
                    nl_xx = nbr.build_neighbor_list_scan(
                        params, c.ell, source, source, I3, z3,
                        k=nl_k, skin=nl_skin, chunk=chunk)
                    nl_yy = nbr.build_neighbor_list_scan(
                        params, c.ell, y_t_c, target, Rinv, Tinv,
                        k=nl_k, skin=nl_skin, chunk=chunk)
                else:
                    nl_xx = nbr.build_neighbor_list(
                        params, c.ell, source, source, I3, z3,
                        k=nl_k, skin=nl_skin, per_cell_cap=nl_per_cell)
                    nl_yy = nbr.build_neighbor_list(
                        params, c.ell, y_t_c, target, Rinv, Tinv,
                        k=nl_k, skin=nl_skin, per_cell_cap=nl_per_cell)
                body.nl_xx = inner_cond.nl_xx = nl_xx
                body.nl_yy = inner_cond.nl_yy = nl_yy
                overflow = overflow + nl_xx.overflow + nl_yy.overflow
            c = c._replace(
                nl_overflow=jnp.maximum(c.nl_overflow, overflow),
                nl_rebuilds=c.nl_rebuilds + 1,
                fresh=jnp.ones((), bool),
            )
            body.nl = nl
            inner_cond.nl = nl
            return lax.while_loop(inner_cond, body, c)

        final = lax.while_loop(cond, outer_body, init)
    else:
        final = lax.while_loop(cond, body, init)

    Rf, Tf = lie.invert_rt(final.R, final.T)
    transform = lie.rt_to_mat44(Rf, Tf)
    info = AlignInfo(
        iterations=final.k,
        final_ell=final.ell,
        final_step=final.step,
        final_dist=final.dist,
        nonzeros=final.nonzeros,
        inner_product=final.a_sum,
        history=final.history,
        nl_overflow=final.nl_overflow if use_ell else None,
        nl_rebuilds=final.nl_rebuilds if use_ell else None,
    )
    return transform, final.ret, info


def align(
    source: PointCloud,
    target: PointCloud,
    init_guess: jax.Array,
    params: CvoParams,
    backend: str = "auto",
    adaptive_ell: Optional[bool] = None,
    psum_axis=None,
    ring_axis=None,
    **kwargs,
):
    """Public pairwise-align entry point: resolves the backend policy
    (resolve_backend) and calls the jitted core (align_core — same
    signature; use it directly inside jit/shard_map contexts if you need
    zero Python overhead)."""
    shard = psum_axis is not None or ring_axis is not None
    if shard and backend not in ("auto", "jnp"):
        # preserve align_core's explicit validation rather than silently
        # downgrading the user's backend choice
        raise ValueError(
            "sharded align runs the blocked-jnp kernels per shard; "
            f"backend={backend!r} is not supported with psum_axis/ring_axis")
    resolved = "jnp" if shard else resolve_backend(
        params, source.capacity, target.capacity, backend, adaptive_ell)
    return align_core(source, target, init_guess, params, backend=resolved,
                      adaptive_ell=adaptive_ell, psum_axis=psum_axis,
                      ring_axis=ring_axis, **kwargs)


@functools.partial(jax.jit, static_argnames=("params", "chunk"))
def inner_product(
    source: PointCloud,
    target: PointCloud,
    transform: jax.Array,
    ell,
    params: CvoParams,
    chunk: int = kernels.DEFAULT_CHUNK,
):
    """<f(X), f(Y o T^{-1})> — single kernel evaluation, summed.

    Matches inner_product_impl (CvoGPU.cu:1719-1778): the moving cloud is
    transformed by the *inverse* of the given transform before the kernel.
    """
    R, T = lie.mat44_to_rt(jnp.asarray(transform, jnp.float32))
    Rinv, Tinv = lie.invert_rt(R, T)
    y_t = target.transformed(Rinv, Tinv)
    stats = kernels.flow_stats(params, jnp.asarray(ell, jnp.float32), source, y_t, chunk)
    return stats.a_sum


def function_angle(
    source: PointCloud,
    target: PointCloud,
    transform,
    ell,
    params: CvoParams,
    approximate: bool = True,
    chunk: int = kernels.DEFAULT_CHUNK,
):
    """cos(theta) overlap indicator (CvoGPU::function_angle, CvoGPU.cu:1814-1873)."""
    fxfz = inner_product(source, target, jnp.asarray(transform), ell, params, chunk)
    eye = jnp.eye(4, dtype=jnp.float32)
    if approximate:
        fx_norm = jnp.sqrt(source.num_valid)
        fz_norm = jnp.sqrt(target.num_valid)
    else:
        fx_norm = jnp.sqrt(inner_product(source, source, eye, ell, params, chunk))
        fz_norm = jnp.sqrt(inner_product(target, target, eye, ell, params, chunk))
    return fxfz / (fx_norm * fz_norm)


@functools.partial(jax.jit, static_argnames=("params", "top_k", "chunk"))
def compute_association(
    source: PointCloud,
    target: PointCloud,
    transform: jax.Array,
    ell,
    params: CvoParams,
    top_k: int = 64,
    chunk: int = kernels.DEFAULT_CHUNK,
):
    """Soft data association export (CvoGPU::compute_association_gpu,
    CvoGPU.cu:1876-1995): per-source-row top-k (value, target-index) pairs
    with 0/-1 padding, plus source/target inlier masks."""
    R, T = lie.mat44_to_rt(jnp.asarray(transform, jnp.float32))
    Rinv, Tinv = lie.invert_rt(R, T)
    y_t = target.transformed(Rinv, Tinv)
    vals, idx = kernels.association_topk(
        params, jnp.asarray(ell, jnp.float32), source, y_t, top_k, chunk
    )
    source_inliers = jnp.any(vals > 0, axis=1)
    target_inliers = (
        jnp.zeros((target.capacity,), bool)
        .at[jnp.where(idx >= 0, idx, 0).reshape(-1)]
        .max((vals > 0).reshape(-1))
    )
    return vals, idx, source_inliers, target_inliers


@functools.partial(jax.jit, static_argnames=("params", "top_k", "chunk"))
def compute_association_non_isotropic(
    source: PointCloud,
    target: PointCloud,
    transform: jax.Array,
    non_isotropic_kernel: jax.Array,
    params: CvoParams,
    top_k: int = 64,
    chunk: int = kernels.DEFAULT_CHUNK,
):
    """Association under a 3x3 non-isotropic (Mahalanobis) kernel
    (CvoGPU::compute_association_gpu kernel-matrix overload +
    inner_product_non_isotropic_impl, CvoGPU.cu:1908-1995): the geometric
    gate becomes exp(-d^T K^{-1} d / 2) and is_using_geometric_type is
    forced off, as in the reference (:1950-1952)."""
    params = params.replace(is_using_geometric_type=0)
    R, T = lie.mat44_to_rt(jnp.asarray(transform, jnp.float32))
    Rinv, Tinv = lie.invert_rt(R, T)
    y_t = target.transformed(Rinv, Tinv)
    kernel_inv = jnp.linalg.inv(jnp.asarray(non_isotropic_kernel, jnp.float32))
    vals, idx = kernels.association_topk_dense(
        params, kernel_inv, source, y_t, top_k, chunk
    )
    source_inliers = jnp.any(vals > 0, axis=1)
    target_inliers = (
        jnp.zeros((target.capacity,), bool)
        .at[jnp.where(idx >= 0, idx, 0).reshape(-1)]
        .max((vals > 0).reshape(-1))
    )
    return vals, idx, source_inliers, target_inliers
