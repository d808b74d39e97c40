"""Non-local-means image denoising on device — the RawImage preprocessing.

The reference denoises EVERY incoming frame with OpenCV's CPU
fastNlMeansDenoising(Colored) (h=10, template 7, search 21;
src/utils/RawImage.cpp:22-25) before computing intensity/gradients — at
KITTI resolution that costs several times the registration itself on one
host CPU. This is the classic Buades NL-means with the same (h, patch,
search) parameters, restructured for an accelerator:

    for each of the 21x21 search offsets t:
        d(x)   = box_7x7((I(x) - I(x+t))^2)      # patch distance
        w(x)   = exp(-d(x) / (|P| h^2))
        num   += w * I(x+t);  den += w

One `lax.fori_loop` over the 21 search ROW offsets (the 21 column offsets
of each row are batched as static slices of a once-padded plane, and the
7x7 patch sums are static shift-adds rather than cumsum scans, with one
hoisted reflect pad) — pure elementwise streaming. For color
input the weights are computed from the luminance and applied to all three
channels (OpenCV's colored variant similarly drives weights from the L
channel in Lab space); output differs from OpenCV pixelwise but delivers
the same denoising strength (PSNR vs clean within ~1 dB, tests/test_nlm.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

TEMPLATE = 7          # patch edge (reference templateWindowSize)
SEARCH = 21           # search window edge (reference searchWindowSize)
H_STRENGTH = 10.0     # reference h


@functools.partial(jax.jit, static_argnames=("template", "search"))
def nlm_denoise(
    image: jax.Array,
    h: float = H_STRENGTH,
    template: int = TEMPLATE,
    search: int = SEARCH,
):
    """NL-means denoise. image: [H,W] or [H,W,3] float32 (0..255 scale).

    Returns the same shape, float32. Weights come from the (first-channel
    or luminance) plane; all channels are averaged with those weights.
    """
    f32 = jnp.float32
    img = jnp.asarray(image, f32)
    chans = img[..., None] if img.ndim == 2 else img
    Hh, Ww, C = chans.shape
    if C == 3:
        # BGR luminance (cv2 convention)
        lum = (0.114 * chans[..., 0] + 0.587 * chans[..., 1]
               + 0.299 * chans[..., 2])
    else:
        lum = chans[..., 0]

    m = search // 2
    r = template // 2
    M = m + r
    # pad ONCE with the combined search+patch margin; inside the loop only
    # static/dynamic slices remain (an in-loop reflect pad lowers to a
    # gather and was the dominant cost)
    pl = jnp.pad(lum, M, mode="reflect")                     # [H+2M, W+2M]
    lum_r = pl[m:m + Hh + 2 * r, m:m + Ww + 2 * r]           # center, r-margin
    # channels leading so every plane is lane-aligned 2D
    pad_ch = jnp.pad(jnp.moveaxis(chans, -1, 0), ((0, 0), (m, m), (m, m)),
                     mode="reflect")                         # [C, H+2m, W+2m]
    patch_area = f32(template * template)
    inv = 1.0 / (patch_area * f32(h) * f32(h))

    # one fori_loop over the `search` row-offsets; the `search` column
    # offsets of each row are batched as a [search, ...] stack of static
    # slices, keeping the loop short and the VPU fed
    def body(dy, carry):
        num, den = carry
        band = lax.dynamic_slice(
            pl, (dy, 0), (Hh + 2 * r, Ww + 2 * M))           # dy-shifted
        sh = jnp.stack(
            [band[:, dx:dx + Ww + 2 * r] for dx in range(search)]
        )                                                    # [S,H+2r,W+2r]
        d2raw = (lum_r[None] - sh) ** 2
        rows = sum(d2raw[:, i:i + Hh, :] for i in range(template))
        d2 = sum(rows[:, :, j:j + Ww] for j in range(template))  # [S,H,W]
        w = jnp.exp(-d2 * inv)                               # [S,H,W]
        band_ch = lax.dynamic_slice(
            pad_ch, (0, dy, 0), (C, Hh, Ww + 2 * m))
        sh_ch = jnp.stack(
            [band_ch[:, :, dx:dx + Ww] for dx in range(search)])  # [S,C,H,W]
        num = num + jnp.sum(w[:, None] * sh_ch, axis=0)
        return num, den + jnp.sum(w, axis=0)

    num, den = lax.fori_loop(
        0, search, body,
        (jnp.zeros((C, Hh, Ww), f32), jnp.zeros((Hh, Ww), f32)))
    out = jnp.moveaxis(num, 0, -1) / den[..., None]
    return out[..., 0] if img.ndim == 2 else out


def nlm_denoise_uint8(image: np.ndarray, h: float = H_STRENGTH) -> np.ndarray:
    """uint8 in / uint8 out convenience wrapper (host arrays)."""
    out = nlm_denoise(jnp.asarray(image, jnp.float32), h=h)
    return np.clip(np.asarray(out), 0, 255).astype(np.uint8)
