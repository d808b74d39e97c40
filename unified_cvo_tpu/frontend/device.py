"""Fully on-device RGB-D / depth frontend: one jit from raw image + depth
map to a registration-ready PointCloud.

The reference's measurement pipeline is host-bound C++/OpenCV: NL-means
denoise (RawImage.cpp:22-25), gradients (:55-81), DSO pixel selection
(CvoPixelSelector.cpp), backprojection + feature fill
(CvoPointCloud.cpp:459-564, 744-768). This module keeps the whole chain on
the accelerator, producing a device-resident padded PointCloud that feeds
`models/align.py` without any host round-trip — the device production
path. The host twins in frontend/{image,selector,stereo,pipeline}.py remain
the behaviour-parity implementations (adaptive FAST thresholds and the
data-dependent DSO potential retuning need host control flow).

Differences from the host DSO selector, forced by static shapes:
- the grid potential `pot` is a static parameter (default 3, the
  reference's starting potential) instead of the count-driven retuning
  loop (CvoPixelSelector.cpp:430-463);
- the output is a fixed `capacity`: when more grid cells pass their block
  threshold than fit, the strongest-gradient winners are kept (the host
  keeps all winners and lets the count float).
Block thresholds themselves are the exact histogram-quantile math of
makeHists (CvoPixelSelector.cpp:85-147), validated against the host
implementation in tests/test_device_frontend.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from unified_cvo_tpu.frontend.calibration import Calibration
from unified_cvo_tpu.utils.pointcloud import PointCloud


def device_gray_and_gradients(image):
    """[H,W,3] BGR or [H,W] float32 -> (gray, grad [H,W,2], grad_sq).

    Central differences with zeroed borders (RawImage.cpp:55-81 /
    frontend/image.py)."""
    img = jnp.asarray(image, jnp.float32)
    if img.ndim == 3:
        # Emulate cv2.cvtColor's fixed-point BGR2GRAY exactly:
        # (1868*B + 9617*G + 4899*R + 8192) >> 14 with integer-valued
        # uint8 inputs. All intermediates stay < 2^24, so f32 arithmetic
        # is exact and the device gray bitwise-matches the host twin
        # (frontend/image.py) on uint8 frames.
        gray = jnp.floor((1868.0 * img[..., 0] + 9617.0 * img[..., 1]
                          + 4899.0 * img[..., 2] + 8192.0) * (1.0 / 16384.0))
    else:
        gray = img
    dx = jnp.zeros_like(gray)
    dy = jnp.zeros_like(gray)
    dx = dx.at[:, 1:-1].set(0.5 * (gray[:, 2:] - gray[:, :-2]))
    dy = dy.at[1:-1, :].set(0.5 * (gray[2:, :] - gray[:-2, :]))
    dx = dx.at[0, :].set(0.0).at[-1, :].set(0.0)
    dy = dy.at[0, :].set(0.0).at[-1, :].set(0.0)
    return gray, jnp.stack([dx, dy], axis=-1), dx * dx + dy * dy


def dso_block_thresholds(gs):
    """Per-32x32-block DSO thresholds (makeHists,
    CvoPixelSelector.cpp:85-147): histogram 0.5-quantile of
    int(sqrt(grad^2)) clipped to 48, +7, 3x3 block smoothing, squared.
    Matches frontend/selector.py::_dso_block_thresholds exactly."""
    h, w = gs.shape
    h32, w32 = h // 32, w // 32
    g = jnp.clip(jnp.sqrt(jnp.maximum(gs, 0.0)).astype(jnp.int32), 0, 48)
    interior = jnp.zeros((h, w), bool).at[1:h - 1, 1:w - 1].set(True)
    gb = (g[:h32 * 32, :w32 * 32]
          .reshape(h32, 32, w32, 32).transpose(0, 2, 1, 3)
          .reshape(h32 * w32, 1024))
    ib = (interior[:h32 * 32, :w32 * 32]
          .reshape(h32, 32, w32, 32).transpose(0, 2, 1, 3)
          .reshape(h32 * w32, 1024))
    total = jnp.sum(ib, axis=1)
    # histogram quantile == sorted[int(total*0.5 + 0.5)] over interior
    # values (non-interior sort to the end as +big)
    vals = jnp.where(ib, gb, 1 << 20)
    vals = jnp.sort(vals, axis=1)
    th_idx = (total.astype(jnp.float32) * 0.5 + 0.5).astype(jnp.int32)
    q = jnp.take_along_axis(vals, th_idx[:, None], axis=1)[:, 0]
    q = jnp.where(q >= (1 << 20), 90, q)   # empty block fallback (ref :78)
    ths = (q + 7.0).astype(jnp.float32).reshape(h32, w32)
    pad = jnp.pad(ths, 1)
    cnt = jnp.pad(jnp.ones_like(ths), 1)
    sm = sum(pad[1 + dy:1 + dy + h32, 1 + dx:1 + dx + w32]
             for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    n = sum(cnt[1 + dy:1 + dy + h32, 1 + dx:1 + dx + w32]
            for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    sm = sm / n
    return sm * sm


def dso_select_device(gs, ths_sm, pot: int, capacity: int,
                      th_factor: float = 1.0):
    """Grid selection (select(), CvoPixelSelector.cpp:270-426): per pot x pot
    cell keep the strongest pixel above its block threshold; strongest
    `capacity` cells win when over budget. Returns (uv [capacity,2] int32,
    valid [capacity] bool)."""
    h, w = gs.shape
    h32v = jnp.minimum(jnp.arange(h) // 32, ths_sm.shape[0] - 1)
    w32v = jnp.minimum(jnp.arange(w) // 32, ths_sm.shape[1] - 1)
    per_pix = ths_sm[h32v][:, w32v] * th_factor
    ok = gs > per_pix
    border = jnp.zeros((h, w), bool).at[4:h - 4, 4:w - 4].set(True)
    gv = jnp.where(ok & border, gs, -1.0)
    Hc, Wc = -(-h // pot), -(-w // pot)
    padded = jnp.full((Hc * pot, Wc * pot), -1.0, jnp.float32)
    padded = padded.at[:h, :w].set(gv)
    cells = (padded.reshape(Hc, pot, Wc, pot).transpose(0, 2, 1, 3)
             .reshape(Hc * Wc, pot * pot))
    best = jnp.argmax(cells, axis=1)
    score = jnp.max(cells, axis=1)                       # -1 = no hit
    # strongest `capacity` cells via argsort + index gathers (this runs
    # once per frame on [n_cells] vectors; the multi-operand-sort lesson
    # from ops/neighbors.py applies to per-iteration [N, W] selections).
    # Pad to `capacity` so the output shapes hold even when the pot grid
    # has fewer cells than the budget.
    n_cells = Hc * Wc
    if n_cells < capacity:
        score = jnp.pad(score, (0, capacity - n_cells), constant_values=-1.0)
        best = jnp.pad(best, (0, capacity - n_cells))
    order = jnp.argsort(-score)[:capacity]
    sc = score[order]
    valid = sc > 0
    cell = jnp.minimum(order, n_cells - 1)
    oy = best[cell] // pot
    ox = best[cell] % pot
    cy = cell // Wc
    cx = cell % Wc
    uv = jnp.stack([cx * pot + ox, cy * pot + oy], axis=1).astype(jnp.int32)
    return jnp.where(valid[:, None], uv, 0), valid


@functools.partial(
    jax.jit,
    static_argnames=("pot", "capacity", "max_range", "denoise"),
)
def _rgbd_impl(image, depth, Kinv, depth_scale, pot, capacity, max_range,
               denoise):
    img = jnp.asarray(image, jnp.float32)
    if denoise:
        from unified_cvo_tpu.ops.nlm import nlm_denoise

        img = nlm_denoise(img)
    gray, grad, gs = device_gray_and_gradients(img)
    ths = dso_block_thresholds(gs)
    uv, valid = dso_select_device(gs, ths, pot, capacity)
    u, v = uv[:, 0], uv[:, 1]

    d = depth[v, u].astype(jnp.float32) / depth_scale
    z_ok = d > 1e-6
    homo = jnp.stack([u.astype(jnp.float32), v.astype(jnp.float32),
                      jnp.ones_like(u, jnp.float32)], axis=1)
    xyz = (homo @ Kinv.T) * d[:, None]
    rng_ok = jnp.linalg.norm(xyz, axis=1) < max_range

    g = grad[v, u] / 500.0 + 0.5
    if img.ndim == 3:
        feats = jnp.concatenate([img[v, u] / 255.0, g], axis=-1)
    else:
        feats = jnp.concatenate([gray[v, u, None] / 255.0, g], axis=-1)

    mask = (valid & z_ok & rng_ok).astype(jnp.float32)
    gtype = jnp.tile(jnp.asarray([[0.9, 0.1]], jnp.float32), (capacity, 1))
    return PointCloud(
        xyz=jnp.where(mask[:, None] > 0, xyz, 0.0),
        mask=mask,
        features=jnp.where(mask[:, None] > 0, feats, 0.0),
        labels=None,
        geometric_types=gtype,
    )


@functools.partial(
    jax.jit,
    static_argnames=("pot", "capacity", "max_disp", "max_range", "v_min",
                     "v_bottom_margin", "denoise"),
)
def _stereo_impl(left, right_gray, Kinv, fx_baseline, pot, capacity,
                 max_disp, max_range, v_min, v_bottom_margin, denoise):
    from unified_cvo_tpu.ops.sgm import sgm_disparity_device

    img = jnp.asarray(left, jnp.float32)
    # matching runs on the RAW pair (the host twin computes disparity from
    # the raw images too — denoising only the left would change census
    # rankings asymmetrically); denoise feeds features/gradients only
    gray_raw, _, _ = device_gray_and_gradients(img)
    if denoise:
        from unified_cvo_tpu.ops.nlm import nlm_denoise

        img = nlm_denoise(img)
    gray, grad, gs = device_gray_and_gradients(img)
    rg = jnp.asarray(right_gray, jnp.float32)
    if rg.ndim == 3:
        rg, _, _ = device_gray_and_gradients(rg)
    disp = sgm_disparity_device(gray_raw, rg, max_disp=max_disp)
    ths = dso_block_thresholds(gs)
    uv, valid = dso_select_device(gs, ths, pot, capacity)
    u, v = uv[:, 0], uv[:, 1]
    h, w = gray.shape

    # pt_depth_from_disparity gates (StaticStereo.hpp:29-43): interior
    # pixel, disparity > 0.05; depth = |b| fx / disp
    d = disp[v, u]
    d_ok = ((u >= 1) & (u <= w - 2) & (v >= 1) & (v <= h - 2) & (d > 0.05))
    depth = fx_baseline / jnp.where(d_ok, d, 1.0)
    homo = jnp.stack([u.astype(jnp.float32), v.astype(jnp.float32),
                      jnp.ones_like(u, jnp.float32)], axis=1)
    xyz = (homo @ Kinv.T) * depth[:, None]
    # is_good_point (CvoPointCloud.cpp:39-57)
    good = ((u >= 2) & (u <= w - 2) & (v >= v_min)
            & (v <= h - v_bottom_margin)
            & (jnp.linalg.norm(xyz, axis=1) < max_range))

    g = grad[v, u] / 500.0 + 0.5
    if img.ndim == 3:
        feats = jnp.concatenate([img[v, u] / 255.0, g], axis=-1)
    else:
        feats = jnp.concatenate([gray[v, u, None] / 255.0, g], axis=-1)
    mask = (valid & d_ok & good).astype(jnp.float32)
    gtype = jnp.tile(jnp.asarray([[0.9, 0.1]], jnp.float32), (capacity, 1))
    return PointCloud(
        xyz=jnp.where(mask[:, None] > 0, xyz, 0.0),
        mask=mask,
        features=jnp.where(mask[:, None] > 0, feats, 0.0),
        labels=None,
        geometric_types=gtype,
    )


def device_pointcloud_from_stereo(
    left: np.ndarray,
    right_gray: np.ndarray,
    calib: Calibration,
    pot: int = 3,
    capacity: int = 8192,
    max_disp: int = 128,
    max_range: float = 55.0,
    v_min: int = 100,
    v_bottom_margin: int = 30,
    denoise: bool = False,
) -> PointCloud:
    """Whole stereo frontend in one jit: left BGR + right gray in,
    device-resident PointCloud out — disparity (ops/sgm.py census-SGM),
    DSO selection, backprojection, and the reference's good-point gates
    never leave the accelerator. The host twin is
    frontend/pipeline.py::pointcloud_from_stereo; v_min/v_bottom_margin
    are the reference's hard-coded sky/hood crop (CvoPointCloud.cpp:39-57).
    """
    Kinv = jnp.asarray(np.linalg.inv(calib.intrinsic), jnp.float32)
    # ship images in their native dtype (uint8 = 4x fewer bytes than f32
    # to copy to the device); _stereo_impl casts on device
    args = (jnp.asarray(left), jnp.asarray(right_gray),
            Kinv, jnp.float32(abs(calib.baseline) * calib.fx),
            pot, capacity, max_disp, max_range, v_min, v_bottom_margin,
            denoise)
    return _stereo_impl(*args)


def device_pointcloud_from_rgbd(
    image: np.ndarray,
    depth: np.ndarray,
    calib: Calibration,
    pot: int = 3,
    capacity: int = 8192,
    max_range: float = 55.0,
    denoise: bool = False,
) -> PointCloud:
    """One jit: image + depth map in, device-resident PointCloud out.

    `denoise=True` prepends the device NL-means (ops/nlm.py). The result's
    capacity is static, so consecutive frames share one compiled trace.
    """
    Kinv = jnp.asarray(np.linalg.inv(calib.intrinsic), jnp.float32)
    return _rgbd_impl(
        jnp.asarray(image, jnp.float32), jnp.asarray(depth),
        Kinv, jnp.float32(calib.depth_scale or 1.0),
        pot, capacity, max_range, denoise,
    )
