"""Device census/semi-global stereo matching — the stereo frontend on device.

The reference computes left disparity on the host at image load (libelas,
src/utils/ImageStereo.cpp + StaticStereo.hpp:16-44, the 11.3k-LoC
thirdparty/libelas role); this repo's host paths are cv2.StereoSGBM and the
native AVX2 census-SGM (native/cvo_native.cpp). On a small driver host
those become the end-to-end wall, so this module moves the whole matcher
on device as one jit: census -> hamming cost volume -> 6-path SGM
aggregation (two batched lax.scans) -> WTA + uniqueness + subpixel ->
left/right consistency -> 3x3 valid-median.

Semantics transcribe native/cvo_native.cpp (the correctness oracle,
itself depth-parity-settled against cv2 SGBM in BASELINE.md):
  - 5x5 edge-clamped census, 24-bit signature (census_transform, :108-136)
  - cost(y,x,d) = popcount(cl[y,x] ^ cr[y,x-d]), 24 where x-d < 0 (:263-305)
  - per-direction recurrence Lc = c + min(Lp[d], Lp[d+-1]+P1, minprev+P2)
    - minprev over dirs {(1,0),(-1,0),(0,1),(0,-1),(1,1),(-1,-1)}
    (sgm_step_row, :35-100; aggregate_pass, :160-246)
  - WTA first-min, uniqueness test vs second-best outside |d-best|<=1,
    parabolic subpixel (:325-400)
  - right disparity from the same volume: argmin_d agg[y, x+d, d] (:402-415)
  - LR check: keep d >= 0.5 with |disp_r[x - round(d)] - d| <= 1.5 (:437-448)
  - 3x3 median over valid neighbors when self valid and n >= 5 (:452-478)

Deviation: the native speckle pass is a connected-component flood fill
(:480-520) — inherently sequential/data-dependent, no static-shape
formulation.
Device twin: a local-density test (valid neighbors within |Delta d| <= 2
in a 9x9 window >= `speckle_density`) that kills the same isolated
LR-survivors; region-scale parity is gated by the disparity-EPE tests in
tests/test_sgm.py rather than bitwise agreement.

The disparity axis D (default 128) is the minor (contiguous) axis; the
scan states are [G, lines, D] with all six directions batched into two
scans (flips + a per-step x-shift for the diagonals), so one scan step is
a handful of elementwise ops on a [4, W, 128] block.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

INF = jnp.int32(1 << 28)
MAX_COST = 24          # 24-bit census: hamming <= 24


def _edge_pad_shift(a, dy, dx):
    """a shifted so out[y, x] = a[clamp(y+dy), clamp(x+dx)] (edge clamp,
    matching the C++ census index clamping)."""
    h, w = a.shape
    p = jnp.pad(a, 2, mode="edge")
    return p[2 + dy:2 + dy + h, 2 + dx:2 + dx + w]


def census_5x5(gray):
    """[H, W] integer-valued -> uint32 24-bit census signature."""
    g = jnp.asarray(gray, jnp.int32)
    sig = jnp.zeros(g.shape, jnp.uint32)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            if dy == 0 and dx == 0:
                continue
            bit = (_edge_pad_shift(g, dy, dx) < g).astype(jnp.uint32)
            sig = (sig << 1) | bit
    return sig


def _cost_volume(cl, cr, D):
    """[H, W, D] int32 hamming costs; 24 where the right pixel is off-frame."""
    h, w = cl.shape
    planes = []
    for d in range(D):
        if d == 0:
            crd = cr
        else:
            crd = jnp.concatenate(
                [jnp.zeros((h, d), cr.dtype), cr[:, :w - d]], axis=1)
        ham = lax.population_count(cl ^ crd).astype(jnp.int32)
        x_ok = jnp.arange(w) >= d
        planes.append(jnp.where(x_ok[None, :], ham, MAX_COST))
    return jnp.stack(planes, axis=-1)


def _shift_d(L, s):
    """Shift along the disparity (last) axis with INF fill."""
    if s == 1:
        return jnp.concatenate([jnp.full(L.shape[:-1] + (1,), INF), L[..., :-1]],
                               axis=-1)
    return jnp.concatenate([L[..., 1:], jnp.full(L.shape[:-1] + (1,), INF)],
                           axis=-1)


def _sgm_scan(costs, has_prev_masks, shift_mask, P1, P2, unroll: int = 8):
    """Batched SGM recurrence.

    costs: [S, G, L, D] — S scan steps of G direction-members over L lines.
    has_prev_masks: [G, L] bool — lines whose in-step predecessor exists
    (applied for steps >= 1; step 0 is always a scanline start).
    shift_mask: [G] bool — members whose state shifts +1 along L between
    steps (the diagonal directions).
    Returns the stacked per-step Lc volume [S, G, L, D].

    `unroll` sub-steps run inside each lax.scan step: per-step work is a
    handful of elementwise ops on a [G, L, D] block, so the scan's fixed
    per-step cost dominates; unrolling amortizes it over 8 recurrences
    (the trailing partial chunk is padded with dummy steps and sliced
    off).
    """
    S, G, L, D = costs.shape
    p1 = jnp.int32(P1)
    p2 = jnp.int32(P2)
    sm = shift_mask[:, None, None]
    pad = (-S) % unroll
    if pad:
        # dummy steps only EXTEND each scanline past its true end; their
        # outputs are sliced off and forward scans never feed them back
        costs = jnp.concatenate(
            [costs, jnp.zeros((pad, G, L, D), costs.dtype)], axis=0)
    xs = costs.reshape((S + pad) // unroll, unroll, G, L, D)

    def step(carry, cU):
        Lp, minprev, k = carry
        outs = []
        for u in range(unroll):
            # diagonal members: predecessor is one line over
            Lp_s = jnp.concatenate(
                [jnp.full((G, 1, D), INF, jnp.int32), Lp[:, :-1, :]], axis=1)
            mp_s = jnp.concatenate(
                [jnp.zeros((G, 1, 1), jnp.int32), minprev[:, :-1, :]], axis=1)
            Lpu = jnp.where(sm, Lp_s, Lp)
            mpu = jnp.where(sm, mp_s, minprev)
            best = jnp.minimum(
                Lpu, jnp.minimum(
                    jnp.minimum(_shift_d(Lpu, 1), _shift_d(Lpu, -1)) + p1,
                    mpu + p2))
            Lc = cU[u] + best - mpu
            if u == 0:
                ok = (k > 0) & has_prev_masks[:, :, None]
            else:
                ok = has_prev_masks[:, :, None]
            Lc = jnp.where(ok, Lc, cU[u])
            minprev = jnp.min(Lc, axis=-1, keepdims=True)
            Lp = Lc
            outs.append(Lc)
        return (Lp, minprev, k + 1), jnp.stack(outs)

    init = (jnp.full((G, L, D), INF, jnp.int32),
            jnp.zeros((G, L, 1), jnp.int32), jnp.zeros((), jnp.int32))
    _, out = lax.scan(step, init, xs)
    return out.reshape(S + pad, G, L, D)[:S]


@functools.partial(jax.jit, static_argnames=("max_disp", "p1", "p2"))
def _aggregate(cost, max_disp, p1, p2):
    h, w, D = cost.shape
    # ---- horizontal scan over x: members (1,0) and (-1,0) (x-flipped)
    cost_h = jnp.stack([cost, cost[:, ::-1, :]], axis=0)     # [2, H, W, D]
    xs = jnp.moveaxis(cost_h, 2, 0)                          # [W, 2, H, D]
    hp = jnp.ones((2, h), bool)
    out_h = _sgm_scan(xs, hp, jnp.zeros((2,), bool), p1, p2)  # [W,2,H,D]
    agg = (jnp.moveaxis(out_h[:, 0], 0, 1)
           + jnp.moveaxis(out_h[:, 1], 0, 1)[:, ::-1, :])

    # ---- vertical/diagonal scan over y: members (0,1), (0,-1) (y-flip),
    # (1,1) (x-shift), (-1,-1) (y+x flip, x-shift)
    cost_v = jnp.stack(
        [cost, cost[::-1, :, :], cost, cost[::-1, ::-1, :]], axis=0)
    ys = jnp.moveaxis(cost_v, 1, 0)                          # [H, 4, W, D]
    xcols = jnp.arange(w)
    hp = jnp.stack([jnp.ones((w,), bool), jnp.ones((w,), bool),
                    xcols >= 1, xcols >= 1], axis=0)         # [4, W]
    shift_mask = jnp.asarray([False, False, True, True])
    out_v = _sgm_scan(ys, hp, shift_mask, p1, p2)            # [H, 4, W, D]
    agg = agg + jnp.moveaxis(out_v[:, 0], 0, 0)
    agg = agg + jnp.moveaxis(out_v[:, 1], 0, 0)[::-1, :, :]
    agg = agg + jnp.moveaxis(out_v[:, 2], 0, 0)
    agg = agg + jnp.moveaxis(out_v[:, 3], 0, 0)[::-1, ::-1, :]
    return agg


@functools.partial(
    jax.jit,
    static_argnames=("max_disp", "p1", "p2", "uniqueness", "speckle_density"))
def sgm_disparity_device(left, right, max_disp: int = 128, p1: int = 10,
                         p2: int = 120, uniqueness: float = 0.1,
                         speckle_density: int = 12):
    """Left disparity [H, W] float32 on device; <= 0 where invalid.

    left/right: [H, W] integer-valued grayscale (uint8 or float32)."""
    cl = census_5x5(left)
    cr = census_5x5(right)
    D = max_disp
    cost = _cost_volume(cl, cr, D)
    agg = _aggregate(cost, D, p1, p2)                        # [H, W, D] int32
    h, w = cl.shape

    # ---- WTA + uniqueness + subpixel (first-min index, like the C++).
    # D stays the minor axis for every [H, W, D] op; per-best values come
    # from one-hot reductions over D rather than a take_along_axis gather
    # on the minor axis
    bc = jnp.min(agg, axis=-1)
    best = jnp.argmin(agg, axis=-1)
    dd = jnp.arange(D)
    rel = dd[None, None, :] - best[..., None]
    second = jnp.min(jnp.where(jnp.abs(rel) <= 1, INF, agg), axis=-1)
    ambiguous = (second < INF) & (
        bc.astype(jnp.float32) * (1.0 + uniqueness) > second.astype(jnp.float32))

    c1 = bc.astype(jnp.float32)
    aggf = agg.astype(jnp.float32)
    c0 = jnp.sum(jnp.where(rel == -1, aggf, 0.0), axis=-1)
    c2 = jnp.sum(jnp.where(rel == 1, aggf, 0.0), axis=-1)
    denom = c0 - 2.0 * c1 + c2
    interior = (best > 0) & (best < D - 1) & (denom > 1e-6)
    disp_l = best.astype(jnp.float32) + jnp.where(
        interior, 0.5 * (c0 - c2) / jnp.where(denom > 1e-6, denom, 1.0), 0.0)
    disp_l = jnp.where(ambiguous, -1.0, disp_l)

    # ---- right disparity from the same volume: argmin_d agg[y, x+d, d].
    # ONE minor->major transpose, then the shear is D static major-plane
    # slices and the reduction runs across planes (stacking shifted [H, W]
    # planes on the MINOR axis instead was the dominant cost of the whole
    # matcher — a strided relayout per plane)
    aggT = jnp.moveaxis(agg, -1, 0)                          # [D, H, W]
    aggT = jnp.concatenate(
        [aggT, jnp.full((D, h, D), INF, jnp.int32)], axis=2)
    sheared = jnp.stack([aggT[d, :, d:d + w] for d in range(D)], axis=0)
    disp_r = jnp.argmin(sheared, axis=0).astype(jnp.float32)
    disp_r = jnp.where(jnp.min(sheared, axis=0) >= INF, -1.0, disp_r)

    # ---- LR consistency
    xr = jnp.arange(w)[None, :] - jnp.floor(disp_l + 0.5).astype(jnp.int32)
    dr = jnp.take_along_axis(disp_r, jnp.clip(xr, 0, w - 1), axis=1)
    keep = (disp_l >= 0.5) & (xr >= 0) & (dr >= 0) & (jnp.abs(dr - disp_l) <= 1.5)
    disp = jnp.where(keep, disp_l, -1.0)

    # ---- 3x3 median over valid neighbors (self valid and n >= 5).
    # Sorting NETWORK over nine [H, W] planes + a 9-way select: a
    # jnp.sort along a 9-wide minor axis is a relayout + per-element sort
    BIG = jnp.float32(1e9)
    neigh = []
    dp = jnp.pad(disp, 1, constant_values=-1.0)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            neigh.append(dp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    n = sum((v > 0).astype(jnp.int32) for v in neigh)
    vals = [jnp.where(v > 0, v, BIG) for v in neigh]
    # optimal 9-element sorting network (25 compare-exchanges)
    for a, b in [(0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8), (0, 1),
                 (3, 4), (6, 7), (0, 3), (3, 6), (0, 3), (1, 4), (4, 7),
                 (1, 4), (2, 5), (5, 8), (2, 5), (1, 3), (5, 7), (2, 6),
                 (4, 6), (2, 4), (2, 3), (5, 6)]:
        lo = jnp.minimum(vals[a], vals[b])
        hi = jnp.maximum(vals[a], vals[b])
        vals[a], vals[b] = lo, hi
    half = n // 2
    med = sum(jnp.where(half == k, vals[k], 0.0) for k in range(9))
    disp = jnp.where((disp > 0) & (n >= 5), med, disp)

    # ---- density speckle suppression (see module docstring)
    v = disp > 0
    dpad = jnp.pad(jnp.where(v, disp, 0.0), 4)
    vpad = jnp.pad(v, 4)
    cnt = jnp.zeros((h, w), jnp.int32)
    for dy in range(-4, 5):
        for dx in range(-4, 5):
            nb = dpad[4 + dy:4 + dy + h, 4 + dx:4 + dx + w]
            nv = vpad[4 + dy:4 + dy + h, 4 + dx:4 + dx + w]
            cnt = cnt + (nv & (jnp.abs(nb - disp) <= 2.0)).astype(jnp.int32)
    disp = jnp.where(v & (cnt < speckle_density), -1.0, disp)
    return disp
