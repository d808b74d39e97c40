"""Verlet-style ELL neighbor lists — the static-shape kd-tree replacement.

The reference prunes the N x M pair space either brute-force (thread-per-point
scan with per-row caps, fill_in_A_mat_gpu, CvoGPU.cu:477-593) or with a GPU
kd-tree (cuKdTree K=32 nearest neighbors, thirdparty/cugicp/cukdtree/cukdtree.h:95-131,
consumed by fill_in_A_mat_cukdtree, CvoGPU.cu:329-430). Neither fits a
jitted static-shape loop: the scan's row caps are data-dependent and the
kd-tree is a pointer structure. The sparsity at KITTI scale makes the case brutal: at ell ~ 0.1 the
kernel support holds ~1 pair per source point, so even an AABB-culled tile
schedule evaluates ~4000x more pairs than survive the gates.

This module's answer: a *candidate list with a skin margin* (the molecular-
dynamics Verlet list), entirely static-shaped:

  build (rare):  bucket transformed target points into a dense voxel grid
                 (cell >= support+skin per axis), pull each source point's
                 27-cell candidate pool as whole [P,4] cell rows (one
                 gather index per cell, not per element), exact-filter by
                 || x - y_t || <= r_i + skin, keep the K nearest -> idx
                 [N, K] plus the RAW target xyz and the pose-independent
                 channel kernel factor per slot (nl.chan), so iterations
                 never gather and never re-evaluate color/semantic kernels.
  consume (hot): per-slot kernel/flow/step math on dense [N, K] blocks,
                 vectorized reductions over the K axis. The kernel matrix A
                 is only [N, K] here, so the flow pass CACHES it and the
                 step pass reuses it — the tiled path must recompute A
                 because its A never fits anywhere.
  validity:      the list built with radius r_i + skin remains a superset of
                 the true support {d(x_i, y_t) < r_i} while every target has
                 drifted < skin since build (pose updates move y_t slowly)
                 and ell has only decayed (support only shrinks). The align
                 loop checks max drift each iteration and rebuilds via
                 lax.cond when it exceeds skin.

Keeping the K *nearest* candidates mirrors the reference's kd-tree mode
(K=32 nearest, cukdtree.h:12) and its ELL row caps (num_neighbors,
SparseKernelMat.hpp:11-19): when a row has more candidates than K, both
implementations drop pairs; ours drops the farthest (weakest) ones.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from unified_cvo_tpu.ops import kernels as jnp_kernels
from unified_cvo_tpu.ops import lie
from unified_cvo_tpu.utils.pointcloud import PointCloud

DEFAULT_K = 32            # matches the reference kd-tree mode's K
#   (cukdtree.h:12). On the bench workload the per-cell cap, not K, is the
#   binding drop; consume cost scales linearly with K. nl_overflow in
#   AlignInfo reports when a workload saturates the cap — raise nl_k for
#   dense-support configs.
DEFAULT_SKIN = 0.5
# dead-slot coordinate sentinel: far enough that any gate distance is
# astronomically large (squared: 3e18, comfortably finite in f32), so the
# distance gate alone kills a dead slot; the consume passes also use
# nl.valid and multiply the sentinel by an exact-zero kernel value
# (0 * finite = 0)
DEAD_COORD = 1e9
GRID_DIMS = (64, 32, 64)      # static voxel grid (131072 cells)
PER_CELL_CAP = 8              # targets stored per cell before the exact filter
#   (cell edge >= support+skin holds ~1 candidate on average; 8 absorbs
#   ground-plane-dense cells with ~0.01% candidate drops at KITTI scale
#   while keeping the sorted pool width 27P — the dominant build cost —
#   lean.)


class NeighborList(NamedTuple):
    """Static-shape candidate list + gathered raw target fields.

    Per-candidate fields are K-MAJOR ([K, N], components leading: [3, K, N])
    — the long N axis is the minor (contiguous) one, so every elementwise
    op streams contiguous rows and the hot-loop reductions over K are
    strided sums of whole rows; a trailing size-3 axis would instead make
    every 3-vector op a short strided access."""

    idx: jax.Array                    # [K, N] int32 target index, -1 pad
    valid: jax.Array                  # [K, N] bool
    y_xyz: jax.Array                  # [3, K, N] RAW (untransformed) target xyz
    chan: Optional[jax.Array]         # [K, N] pose-INDEPENDENT kernel factor:
    #   the product of the color/semantic/geometric-type kernels with their
    #   gates folded in as exact zeros, or None when only the geometric
    #   channel is on. Features/labels/geo-types never move with the pose,
    #   so this is computed ONCE at build — the per-iteration kernel is just
    #   geometric_factor * chan (a 19-class semantic config would otherwise
    #   pay ~40 extra [N, K] ops every iteration).
    y_t_build: jax.Array              # [M, 3] transformed target at build time
    overflow: jax.Array               # [] int32: candidates dropped by the K cap
    pose_build: Optional[jax.Array] = None   # [12] (R_inv | T_inv) at build —
    #   reference pose for the O(1) drift bound (drift_bound_exceeded)
    r_max_t: Optional[jax.Array] = None      # [] max |y| over valid targets
    ell_build: Optional[jax.Array] = None    # [] ell the list was built at
    k_lin: Optional[jax.Array] = None        # [] max_i support_radius(ell=1):
    #   r_i(ell) = k_i * ell (range_ell is linear in ell), so the support
    #   GROWTH bound under adaptive-ell is k_lin * max(ell - ell_build, 0)


def support_radius(params, ell, x: PointCloud):
    """Per-source kernel support radius sqrt(d2_thres) (the geometric gate of
    fill_in_A_mat_gpu: d2 < -2 l_i^2 log(sp_thres / sigma^2), CvoGPU.cu:507-520)."""
    sigma2 = jnp.float32(params.sigma) ** 2
    l_i = jnp_kernels.range_ell(ell, jnp.linalg.norm(x.xyz, axis=-1))
    d2_thres = -2.0 * l_i * l_i * jnp.log(jnp.float32(params.sp_thres) / sigma2)
    return jnp.sqrt(jnp.maximum(d2_thres, 0.0))


def static_support_radius(params) -> float:
    """Trace-time upper estimate of the support radius at ell_init for a
    ~55 m range envelope — used by align's auto backend choice."""
    import math

    sigma2 = float(params.sigma) ** 2
    arg = max(sigma2 / float(params.sp_thres), 1.0 + 1e-6)
    return (55.0 / 500.0 + 1.0) * float(params.ell_init) * math.sqrt(
        2.0 * math.log(arg))


def _transform_cols(xyz, R_inv, T_inv):
    """Rigid transform as per-component [M] broadcasts (lane-aligned, and
    the single shared formulation for build / drift / consume)."""
    return jnp.stack(
        [xyz[:, 0] * R_inv[c, 0] + xyz[:, 1] * R_inv[c, 1]
         + xyz[:, 2] * R_inv[c, 2] + T_inv[c] for c in range(3)], axis=-1)


def build_neighbor_list(
    params,
    ell,
    x: PointCloud,
    target: PointCloud,
    R_inv,
    T_inv,
    k: int = DEFAULT_K,
    skin: float = DEFAULT_SKIN,
    per_cell_cap: int = PER_CELL_CAP,
    grid_dims: Tuple[int, int, int] = GRID_DIMS,
) -> NeighborList:
    """Grid-bucketed candidate search around each source point.

    Targets are transformed by the CURRENT pose (y_t = R_inv y + T_inv, the
    same map the align loop applies), bucketed into a dense static voxel
    grid with per-axis cell size >= max_i(r_i) + skin (so the 27-cell
    neighborhood of a source point covers its whole candidate ball), and
    each source point's pooled candidates are exact-filtered to
    d <= r_i + skin and reduced to the K nearest.
    """
    f32 = jnp.float32
    N = x.capacity
    M = target.capacity
    P = per_cell_cap
    gx, gy, gz = grid_dims
    n_cells = gx * gy * gz

    # per-component transform: EXACTLY the arithmetic drift_exceeded uses,
    # so drift right after a rebuild is bitwise zero and the skin margin is
    # never eaten by transform-formulation mismatch (the package pins
    # HIGHEST matmul precision, but identical-formula is stronger)
    y_t = _transform_cols(target.xyz, R_inv, T_inv)         # [M,3]
    r_i = support_radius(params, ell, x) + f32(skin)        # [N]
    r_max = jnp.max(jnp.where(x.mask > 0, r_i, 0.0))

    # grid geometry over the union bbox (targets clip into boundary cells —
    # conservative, the exact filter removes any false candidates)
    w = target.mask > 0
    lo = jnp.min(jnp.where(w[:, None], y_t, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(w[:, None], y_t, -jnp.inf), axis=0)
    lo = jnp.minimum(lo, jnp.min(jnp.where(x.mask[:, None] > 0, x.xyz, jnp.inf), axis=0))
    hi = jnp.maximum(hi, jnp.max(jnp.where(x.mask[:, None] > 0, x.xyz, -jnp.inf), axis=0))
    dims = jnp.asarray([gx, gy, gz], f32)
    cell = jnp.maximum((hi - lo) / dims, r_max)             # [3] per-axis size

    clip_hi = jnp.asarray([gx - 1, gy - 1, gz - 1])
    key = jnp.where(
        w,
        (lambda c: (c[..., 0] * gy + c[..., 1]) * gz + c[..., 2])(
            jnp.clip(jnp.floor((y_t - lo) / cell).astype(jnp.int32), 0, clip_hi)),
        n_cells,
    )

    # dense per-cell table [n_cells+1, 4P] built by one M-row scatter, with
    # COMPONENT-BLOCKED columns (x-slots | y-slots | z-slots | index-slots;
    # index as f32: M < 2^24 exactly). Candidates are later pulled as whole
    # 4P-float cell rows (one gather index per cell row). Keeping the table
    # 2D and slicing P-wide column blocks keeps all downstream math in
    # [N, 27P] arrays with a long contiguous minor axis, where a [., P, 4]
    # table would give every consumer a minor axis of 4.
    order = jnp.argsort(key).astype(jnp.int32)              # targets grouped by cell
    key_sorted = key[order]
    first = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), key_sorted[1:] != key_sorted[:-1]])
    segment_start = jnp.where(first, jnp.arange(M, dtype=jnp.int32), 0)
    segment_start = lax.associative_scan(jnp.maximum, segment_start)
    rank = jnp.arange(M, dtype=jnp.int32) - segment_start   # rank within cell
    tab = jnp.full((n_cells + 1, 4 * P), -1.0, f32)
    slot_ok = rank < P
    scat_cell = jnp.where(slot_ok, key_sorted, n_cells)
    scat_rank = jnp.where(slot_ok, rank, P - 1)
    xyz_sorted = target.xyz[order]
    comp_vals = [xyz_sorted[:, 0], xyz_sorted[:, 1], xyz_sorted[:, 2],
                 order.astype(f32)]
    for c, v in enumerate(comp_vals):                       # 4 scalar scatters
        tab = tab.at[scat_cell, c * P + scat_rank].set(
            jnp.where(slot_ok, v, -1.0))
    tab = tab.at[n_cells].set(-1.0)                         # sentinel bucket stays empty
    per_cell_dropped = jnp.sum((~slot_ok) & (key_sorted < n_cells))

    # 27-cell candidate pool per source point (a 2x2x2 octant pool would
    # need cell >= 2(r+skin) — 2.4x the candidate volume, inflating K and
    # the per-iteration cost; 27 cells of size r+skin is the lean cover).
    # The pool is pulled through a z-DILATED table: each dilated row holds
    # the 3 z-consecutive cells (r-1, r, r+1), built by two rolls + one
    # concatenate (z-adjacent cells are adjacent rows in the linearized
    # grid), and each source point gathers 9 (dx,dy) windows of width 12P
    # instead of 27 rows of width 4P — a third of the gather indices for
    # one 3x-width concat stream.
    cbase = jnp.clip(jnp.floor((x.xyz - lo) / cell).astype(jnp.int32), 0, clip_hi)
    # a single-cell axis (anisotropic grid) covers its whole span, so that
    # axis needs no +-1 offsets — a (gx, 1, gz) grid pulls a 9-cell pool
    # (3x fewer gather indices; gathers cost per index)
    axis_offs = [(-1, 0, 1) if d > 1 else (0,) for d in (gx, gy, gz)]
    if gz >= 3:
        # z windows clip to [1, gz-2]: the window (zc-1, zc, zc+1) stays
        # inside the (cx, cy) slab — no linear-index wrap anywhere, and the
        # window always covers {cz-1, cz, cz+1} ∩ grid. The at-most-one
        # extra cell a clipped window admits is >= one full cell away in z,
        # i.e. beyond r_i + skin, so the exact filter rejects it and no
        # duplicate slots can arise (all 9 (dx,dy) slabs are distinct).
        offs2 = jnp.asarray(
            [[dx, dy] for dx in axis_offs[0] for dy in axis_offs[1]],
            jnp.int32)                                      # [n_off,2]
        n_off = offs2.shape[0]
        cxy = cbase[:, None, :2] + offs2[None, :, :]        # [N,n_off,2]
        in_grid = jnp.all(
            (cxy >= 0) & (cxy < jnp.asarray([gx, gy])), axis=-1)
        zc = jnp.clip(cbase[:, 2], 1, gz - 2)
        cid = (cxy[..., 0] * gy + cxy[..., 1]) * gz + zc[:, None]
        cid = jnp.where(in_grid, cid, n_cells)              # all-dead sentinel
        # shift-MAJOR z-dilation: [tab(r-1) 4P | tab(r) 4P | tab(r+1) 4P]
        # built from three FULL-WIDTH rolls, so materializing the table is
        # one contiguous stream (a component-major layout would need
        # sixteen narrow column-slice rolls)
        tabz = jnp.concatenate(
            [jnp.roll(tab, 1, axis=0), tab, jnp.roll(tab, -1, axis=0)],
            axis=1)                                         # [n_cells+1, 12P]
        # roll wraps the sentinel row's blocks onto rows 0 / n_cells-1 —
        # harmless (-1 slots) — but real cells wrap INTO the sentinel row:
        # re-kill it
        tabz = tabz.at[n_cells].set(-1.0)
        # materialize before gathering: XLA otherwise fuses the whole
        # roll/concat/scatter chain INTO the gather, recomputing it per
        # gathered element
        tabz = lax.optimization_barrier(tabz)
        pool_flat = tabz[cid.reshape(-1)]                   # [N*n_off, 12P]
        pool = pool_flat.reshape(N, n_off, 12 * P)
        # component extraction from the (shift, comp)-blocked rows:
        # [N, n_off * 3P] per component, lane-aligned
        comp = [jnp.concatenate(
            [pool[:, :, s * 4 * P + c * P:s * 4 * P + (c + 1) * P]
             for s in range(3)], axis=-1).reshape(N, n_off * 3 * P)
            for c in range(4)]
    else:
        offs = jnp.asarray(
            [[dx, dy, dz] for dx in axis_offs[0] for dy in axis_offs[1]
             for dz in axis_offs[2]], jnp.int32)            # [n_off,3]
        n_off = offs.shape[0]
        cnb = cbase[:, None, :] + offs[None, :, :]          # [N,n_off,3]
        in_grid = jnp.all(
            (cnb >= 0) & (cnb < jnp.asarray([gx, gy, gz])), axis=-1)
        cid = (cnb[..., 0] * gy + cnb[..., 1]) * gz + cnb[..., 2]
        cid = jnp.where(in_grid, cid, n_cells)              # empty sentinel bucket

        pool = lax.optimization_barrier(tab)[
            cid.reshape(-1)].reshape(N, n_off, 4 * P)       # [N,n_off,4P]
        # component extraction = static column-block slices -> [N, n_off*P]
        # arrays (lane-aligned; no minor-dim-4 anywhere)
        comp = [pool[:, :, c * P:(c + 1) * P].reshape(N, n_off * P)
                for c in range(4)]
    cand = comp[3].astype(jnp.int32)                        # -1 = empty slot
    yc_raw_c = comp[:3]                                     # 3 x [N,27P]
    yc_t = [yc_raw_c[0] * R_inv[c, 0] + yc_raw_c[1] * R_inv[c, 1]
            + yc_raw_c[2] * R_inv[c, 2] + T_inv[c] for c in range(3)]

    # exact filter + K nearest (the reference kd-tree mode keeps K nearest
    # too, cukdtree.h:12; its ELL rows cap at num_neighbors). One
    # multi-operand sort carries the payload (index + raw xyz) with the
    # distance key, so the K-selection is a free static slice with no
    # take_along_axis gathers afterwards.
    d2 = sum((x.xyz[:, c, None] - yc_t[c]) ** 2 for c in range(3))
    keep = (cand >= 0) & (d2 <= (r_i[:, None] ** 2)) & (x.mask[:, None] > 0)
    d2_key = jnp.where(keep, d2, jnp.inf)
    d2_s, cand_s, yx, yy, yz = lax.sort(
        (d2_key, cand, yc_raw_c[0], yc_raw_c[1], yc_raw_c[2]),
        dimension=1, num_keys=1)
    # one transpose to the K-major consume layout (built once per frame,
    # consumed ~100 iterations)
    valid = jnp.isfinite(d2_s[:, :k]).T                      # [K, N]
    idx = jnp.where(valid, cand_s[:, :k].T, -1)
    y_xyz = jnp.where(
        valid[None],
        jnp.stack([yx[:, :k].T, yy[:, :k].T, yz[:, :k].T], axis=0),
        DEAD_COORD)
    overflow = (jnp.sum(keep) - jnp.sum(valid)).astype(jnp.int32) + \
        per_cell_dropped.astype(jnp.int32)

    chan = _build_chan(params, x, target, idx, valid)
    return NeighborList(
        idx=idx,
        valid=valid,
        y_xyz=y_xyz,
        chan=chan,
        y_t_build=y_t,
        overflow=overflow,
        pose_build=jnp.concatenate([jnp.ravel(R_inv), T_inv]).astype(f32),
        r_max_t=_r_max(target),
        ell_build=jnp.asarray(ell, f32),
        k_lin=_k_lin(params, x),
    )


def _k_lin(params, x: PointCloud):
    return jnp.max(jnp.where(
        x.mask > 0, support_radius(params, jnp.float32(1.0), x), 0.0))


def _r_max(target: PointCloud):
    return jnp.sqrt(jnp.max(jnp.where(
        target.mask > 0, jnp.sum(target.xyz * target.xyz, axis=-1), 0.0)))


def _gather_slots(a, idx):
    """Per-candidate extra fields (intensity/semantics/geo-type runs):
    one flat-index row gather of the target array in its compact
    [K*N, F] layout, then ONE transpose to component-major [F, K, N]
    (gathering straight into [K, N, F] would poison the gather with a
    minor-dim-F tiled layout; see the table-layout note above).
    `idx` is K-major [K, N]."""
    if a is None:
        return None
    flat = jnp.where(idx >= 0, idx, 0).reshape(-1)
    g = a[flat]                                             # [K*N, F] compact
    return g.T.reshape(a.shape[1], idx.shape[0], idx.shape[1])


def _build_chan(params, x: PointCloud, target: PointCloud, idx, valid):
    return _channel_kernel(
        params, x, valid,
        _gather_slots(target.features if params.is_using_intensity else None, idx),
        _gather_slots(target.labels if params.is_using_semantics else None, idx),
        _gather_slots(
            target.geometric_types if params.is_using_geometric_type else None,
            idx),
    )


def build_neighbor_list_scan(
    params,
    ell,
    x: PointCloud,
    target: PointCloud,
    R_inv,
    T_inv,
    k: int = DEFAULT_K,
    skin: float = DEFAULT_SKIN,
    chunk: int = 2048,
) -> NeighborList:
    """Brute-force chunked top-K candidate build — no voxel grid.

    The general-coverage sibling of build_neighbor_list: one dense N x M
    distance scan per (re)build, streamed in target chunks with a running
    multi-operand top-K merge, amortized over the iterations until the
    Verlet skin drift fires. Sound for ANY support radius and cloud size
    (the voxel builder's cell-cap and support<=cell preconditions do not
    exist here), which is what retires the dense-per-iteration fallback:
    one scan per rebuild instead of two scans per iteration
    (reference brute-force mode, fill_in_A_mat_gpu CvoGPU.cu:477-593,
    with its num_neighbors ELL row cap, :576-589).

    With the geometric channel OFF, the kernel is pose-independent:
    candidates are ranked by the channel kernel value itself (strongest-K
    per row — the reference's first-K-in-scan-order cap keeps arbitrary
    pairs; keeping the strongest is strictly better) and the list stays
    exact for the whole solve — the align loop never rebuilds it.
    """
    f32 = jnp.float32
    N = x.capacity
    M = target.capacity
    chunk = min(chunk, M)
    tgt = jnp_kernels.pad_cloud_to_multiple(target, chunk)
    Mp = tgt.capacity
    nchunks = Mp // chunk
    y_t_full = _transform_cols(tgt.xyz, R_inv, T_inv)       # [Mp,3]
    use_geom = bool(params.is_using_geometry)
    if use_geom:
        r2 = (support_radius(params, ell, x) + f32(skin))[:, None] ** 2

    def body(c, carry):
        key, idx, nkeep = carry
        lo = c * chunk
        if use_geom:
            d2 = jnp.zeros((N, chunk), f32)
            for ci in range(3):
                yc = lax.dynamic_slice_in_dim(y_t_full[:, ci], lo, chunk)
                diff = x.xyz[:, ci, None] - yc[None, :]
                d2 = d2 + diff * diff
            mb = lax.dynamic_slice_in_dim(tgt.mask, lo, chunk)
            keep = (d2 <= r2) & (mb[None, :] > 0) & (x.mask[:, None] > 0)
            kb = jnp.where(keep, d2, jnp.inf)
        else:
            yb = jnp_kernels._slice_cloud(tgt, lo, chunk)
            # pose-independent channel kernel (kernel_block with geometry
            # off evaluates exactly the color/semantic/geo-type product)
            a = jnp_kernels.kernel_block(params, ell, x, yb)
            kb = jnp.where(a > 0, -a, jnp.inf)              # strongest first
        cols = lo + jax.lax.broadcasted_iota(jnp.int32, (N, chunk), 1)
        ck = jnp.concatenate([key, kb], axis=1)
        ci_ = jnp.concatenate([idx, cols], axis=1)
        ck, ci_ = lax.sort((ck, ci_), dimension=1, num_keys=1)
        nkeep = nkeep + jnp.sum(jnp.isfinite(kb))
        return ck[:, :k], ci_[:, :k], nkeep

    init = (jnp.full((N, k), jnp.inf, f32), jnp.full((N, k), -1, jnp.int32),
            jnp.zeros((), jnp.int32))
    key, idx, nkeep = lax.fori_loop(0, nchunks, body, init)
    valid = jnp.isfinite(key).T                              # [K, N]
    idx = jnp.where(valid, idx.T, -1)
    overflow = nkeep - jnp.sum(valid).astype(jnp.int32)
    y_xyz = jnp.where(valid[None], _gather_slots(tgt.xyz, idx), DEAD_COORD)
    chan = _build_chan(params, x, tgt, idx, valid)
    return NeighborList(
        idx=idx,
        valid=valid,
        y_xyz=y_xyz,
        chan=chan,
        y_t_build=y_t_full[:M],
        overflow=overflow,
        pose_build=jnp.concatenate([jnp.ravel(R_inv), T_inv]).astype(f32),
        r_max_t=_r_max(tgt),
        ell_build=jnp.asarray(ell, f32),
        k_lin=_k_lin(params, x),
    )


def _channel_kernel(params, x: PointCloud, valid, y_feat, y_label, y_geo):
    """Pose-independent kernel factor per slot (build-time only): the
    color/semantic kernels and the geometric-type cosine^2 gate of
    fill_in_A_mat_gpu (CvoGPU.cu:477-593) with their distance gates folded
    in as exact zeros. Returns K-major [K, N] or None when no such channel
    is on (valid and the y_* slot arrays are K-major; x columns broadcast
    along sublanes)."""
    f32 = jnp.float32
    sp = f32(params.sp_thres)
    a = None
    ok = valid

    def col(arr, c):
        return arr[:, c][None, :]

    if params.is_using_geometric_type:
        xg = x.geometric_types
        dot = col(xg, 0) * y_geo[0] + col(xg, 1) * y_geo[1]
        n2 = (jnp.sum(xg * xg, -1)[None, :]) * (
            y_geo[0] * y_geo[0] + y_geo[1] * y_geo[1])
        geo = dot * dot / jnp.maximum(n2, 1e-12)
        ok &= geo >= 0.01
        a = geo

    if params.is_using_intensity:
        c_ell2 = f32(params.c_ell) ** 2
        c_sigma2 = f32(params.c_sigma) ** 2
        F = x.feature_dim
        d2c = sum((col(x.features, f) - y_feat[f]) ** 2 for f in range(F))
        ok &= d2c < -2.0 * c_ell2 * jnp.log(sp / c_sigma2)
        ck = c_sigma2 * jnp.exp(-d2c / (2.0 * c_ell2))
        a = ck if a is None else a * ck

    if params.is_using_semantics:
        s_ell2 = f32(params.s_ell) ** 2
        s_sigma2 = f32(params.s_sigma) ** 2
        C = x.num_classes
        d2s = sum((col(x.labels, c) - y_label[c]) ** 2 for c in range(C))
        ok &= d2s < -2.0 * s_ell2 * jnp.log(sp / s_sigma2)
        sk = s_sigma2 * jnp.exp(-d2s / (2.0 * s_ell2))
        a = sk if a is None else a * sk

    if a is None:
        return None
    return jnp.where(ok, a, 0.0)


def drift_bound_exceeded(nl: NeighborList, R_inv, T_inv, skin: float):
    """O(1) Verlet rebuild trigger: a SOUND upper bound on the max target
    displacement since build, from the pose delta alone —
      |Delta(R_inv) y + Delta(T_inv)| <= ||Delta(R_inv)||_F * r_max + |Delta(T_inv)|
    (||A y|| <= ||A||_2 |y| <= ||A||_F |y|). At most sqrt(2)x conservative
    on the rotation part, so rebuilds can fire slightly earlier than the
    exact per-point check — never later. Replaces an [M, 3] stream +
    reduction in the inner-loop cond with ~20 scalar flops."""
    f32 = jnp.float32
    dR = jnp.ravel(R_inv.astype(f32)) - nl.pose_build[:9]
    dT = T_inv.astype(f32) - nl.pose_build[9:]
    bound = (jnp.sqrt(jnp.sum(dR * dR)) * nl.r_max_t
             + jnp.sqrt(jnp.sum(dT * dT)))
    return bound > f32(skin)


def stale_bound_exceeded(nl: NeighborList, R_inv, T_inv, ell_now,
                         skin: float):
    """O(1) Verlet staleness trigger for the adaptive-ell (ACVO) regime:
    the list built with radius r_i(ell_build) + skin remains a superset of
    the support while
      drift_bound + k_lin * max(ell_now - ell_build, 0) <= skin
    (support_radius is linear in ell; shrinking ell only adds margin).
    Reduces to the pure drift bound when ell never grows."""
    f32 = jnp.float32
    dR = jnp.ravel(R_inv.astype(f32)) - nl.pose_build[:9]
    dT = T_inv.astype(f32) - nl.pose_build[9:]
    drift = (jnp.sqrt(jnp.sum(dR * dR)) * nl.r_max_t
             + jnp.sqrt(jnp.sum(dT * dT)))
    growth = nl.k_lin * jnp.maximum(
        jnp.asarray(ell_now, f32) - nl.ell_build, 0.0)
    return drift + growth > f32(skin)


def weighted_d2_sum_ell(params, ell, x: PointCloud, nl: NeighborList,
                        R_inv, T_inv):
    """(sum_ij A_ij * d2_ij, nonzeros) over the candidate list — the
    adaptive-ell gradient ingredients (reference AdaptiveCvoGPU.cu dl
    accumulation, :548-720) without the dense N x M scan. Dead slots have
    a == 0 exactly, so their (finite) sentinel d2 contributes nothing."""
    yr = nl.y_xyz
    y_t = jnp.stack(
        [yr[0] * R_inv[c, 0] + yr[1] * R_inv[c, 1]
         + yr[2] * R_inv[c, 2] + T_inv[c] for c in range(3)], axis=0)
    a = kernel_slots(params, ell, x, y_t, nl)
    d2 = sum((x.xyz[:, c][None, :] - y_t[c]) ** 2 for c in range(3))
    return jnp.sum(a * d2), jnp.sum(a > 0)


def drift_exceeded(nl: NeighborList, target: PointCloud, R_inv, T_inv,
                   skin: float):
    """True when some valid target moved more than `skin` since build — the
    Verlet rebuild trigger (exact per-point displacement, not a bound).
    Computed per axis over [M] vectors (lane-aligned)."""
    d2 = 0.0
    for c in range(3):
        y_c = (target.xyz[:, 0] * R_inv[c, 0] + target.xyz[:, 1] * R_inv[c, 1]
               + target.xyz[:, 2] * R_inv[c, 2] + T_inv[c])
        d2 = d2 + (y_c - nl.y_t_build[:, c]) ** 2
    d2 = jnp.where(target.mask > 0, d2, 0.0)
    return jnp.max(d2) > jnp.float32(skin) ** 2


def kernel_slots(params, ell, x: PointCloud, y_t_slots, nl: NeighborList):
    """[K, N] kernel values — slot-wise transcription of kernel_block
    (fill_in_A_mat_gpu, CvoGPU.cu:477-593) with identical gates; padded
    slots are exactly 0. y_t_slots is component-major [3, K, N]; every
    intermediate here is a lane-aligned [K, N] array (N on lanes).

    Only the geometric factor is evaluated here — the color/semantic/
    geometric-type factors are pose-independent and precomputed once per
    neighbor-list build (nl.chan), with their gates folded in as zeros."""
    f32 = jnp.float32
    sp = f32(params.sp_thres)
    a = None
    ok = nl.valid & (x.mask[None, :] > 0)
    if nl.chan is not None:
        ok &= nl.chan > 0
        a = nl.chan

    if params.is_using_geometry:
        sigma2 = f32(params.sigma) ** 2
        d2 = sum((x.xyz[:, c][None, :] - y_t_slots[c]) ** 2 for c in range(3))
        l_i = jnp_kernels.range_ell(ell, jnp.linalg.norm(x.xyz, axis=-1))[None, :]
        two_l2 = 2.0 * l_i * l_i
        ok &= d2 < -two_l2 * jnp.log(sp / sigma2)
        kgeo = sigma2 * jnp.exp(-d2 / two_l2)
        a = kgeo if a is None else a * kgeo

    if a is None:
        return jnp.where(ok, jnp.ones(nl.valid.shape, f32), 0.0)
    return jnp.where(ok & (a > sp), a, 0.0)


def flow_stats_ell(params, ell, x: PointCloud, nl: NeighborList, R_inv, T_inv
                   ) -> Tuple[jnp_kernels.FlowStats, jax.Array, jax.Array]:
    """ELL flow pass. Returns (FlowStats, A [K,N], y_t_slots [3,K,N]); the
    caller hands A and y_t_slots to step_coeffs_ell so the kernel matrix is
    computed ONCE per iteration (the tiled path must recompute it)."""
    yr = nl.y_xyz                                            # [3,K,N]
    y_t_slots = jnp.stack(
        [yr[0] * R_inv[c, 0] + yr[1] * R_inv[c, 1]
         + yr[2] * R_inv[c, 2] + T_inv[c] for c in range(3)], axis=0)
    a = kernel_slots(params, ell, x, y_t_slots, nl)
    # materialize the kernel matrix and transformed slots ONCE: ~10
    # reductions downstream (row sums, flow moments, B..E step sums)
    # consume them, and without the barrier XLA fuses the exp-heavy
    # kernel chain into every reduction
    a, y_t_slots = lax.optimization_barrier((a, y_t_slots))
    s = jnp.sum(a, axis=0)                                   # [N]
    wy = jnp.stack([jnp.sum(a * y_t_slots[c], axis=0) for c in range(3)],
                   axis=-1)
    stats = jnp_kernels.FlowStats(
        row_sum=s,
        row_wy=wy,
        nonzeros=jnp.sum(a > 0).astype(jnp.int32),
        a_sum=jnp.sum(s),
    )
    return stats, a, y_t_slots


def step_coeffs_ell(params, ell, x: PointCloud, a, y_t_slots, twist):
    """ELL step pass (compute_step_size_xi + compute_step_size_poly_coeff,
    CvoGPU.cu:953-1082) reusing the cached kernel matrix `a`.

    All per-slot arrays are lane-aligned K-major [K, N]; the 3-vector
    algebra is unrolled per component (a trailing 3-axis would sit in the
    lane dim, and batched [.,3]@[3,3] dot_generals lower to per-row tiny
    matmuls)."""
    f32 = jnp.float32
    omega, v = twist[:3], twist[3:]
    W = lie.skew(omega)
    W2, W3 = W @ W, W @ W @ W
    W4 = W2 @ W2
    # dead slots carry +DEAD_COORD coordinates; beta^4 of a 1e9-scale value
    # overflows to inf and 0 * inf = NaN — zero them (a == 0 there, so no
    # output changes)
    y = [jnp.where(a > 0, y_t_slots[c], 0.0) for c in range(3)]  # 3 x [K,N]

    def lin(Mm, b):
        return [y[0] * Mm[c, 0] + y[1] * Mm[c, 1] + y[2] * Mm[c, 2] + b[c]
                for c in range(3)]

    xiz = lin(W, v)
    xi2z = lin(W2, W @ v)
    xi3z = lin(W3, W2 @ v)
    xi4z = lin(W4, W3 @ v)
    diff = [x.xyz[:, c][None, :] - y[c] for c in range(3)]   # 3 x [K,N]
    dot3 = lambda p, q: p[0] * q[0] + p[1] * q[1] + p[2] * q[2]
    d1 = dot3(diff, xiz)
    d2_ = dot3(diff, xi2z)
    d3 = dot3(diff, xi3z)
    d4 = dot3(diff, xi4z)
    normxiz2 = dot3(xiz, xiz)
    xdx2 = -dot3(xiz, xi2z)
    epsc = dot3(xi2z, xi2z) + 2.0 * dot3(xiz, xi3z)

    if params.is_using_range_ell:
        l_i = jnp_kernels.range_ell(ell, jnp.linalg.norm(x.xyz, axis=-1))
    else:
        l_i = jnp.full((x.capacity,), ell, f32)
    coef = (1.0 / (2.0 * l_i * l_i))[None, :]

    beta = -2.0 * coef * d1
    gamma = -coef * (normxiz2 + 2.0 * d2_)
    delta = 2.0 * coef * (xdx2 - d3)
    epsil = -coef * (epsc + 2.0 * d4)
    # materialize the shared Taylor terms once: B..E are four separate
    # global reductions over polynomials of these, and XLA otherwise
    # re-fuses the whole xiz/diff chain into each reduction
    beta, gamma, delta, epsil = lax.optimization_barrier(
        (beta, gamma, delta, epsil))
    b2 = beta * beta
    B = jnp.sum(a * beta)
    C = jnp.sum(a * (gamma + 0.5 * b2))
    D = jnp.sum(a * (delta + beta * gamma + b2 * beta / 6.0))
    E = jnp.sum(
        a * (epsil + beta * delta + 0.5 * b2 * gamma + 0.5 * gamma * gamma
             + b2 * b2 / 24.0))
    return B, C, D, E
