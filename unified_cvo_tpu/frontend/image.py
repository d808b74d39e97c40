"""RawImage: denoised intensity + central-difference gradients (+ semantics).

Reference: src/utils/RawImage.cpp. The reference denoises with
fastNlMeansDenoising (RawImage.cpp:22-25) before computing intensity and the
2-channel gradient dx = 0.5*(I[x+1]-I[x-1]), dy = 0.5*(I[y+1]-I[y-1]) with
zeroed borders (compute_image_gradient, RawImage.cpp:55-81).

Note: the reference's stereo feature fill reads `gradient()[v*w+u]` and
`[v*w+u+1]` (CvoPointCloud.cpp:747-757) against a 2-channel-interleaved
buffer indexed `gradient_[2*idx]` — an off-by-2x indexing slip that makes it
sample the (dx,dy) of pixel (v*w+u)/2. We implement the evident intent:
(dx, dy) of the selected pixel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import cv2
import numpy as np


@dataclasses.dataclass
class RawImage:
    image: np.ndarray                 # HxWx3 uint8 (BGR) or HxW uint8
    intensity: np.ndarray             # HxW float32 grayscale
    gradient: np.ndarray              # HxWx2 float32 (dx, dy)
    gradient_square: np.ndarray       # HxW float32 dx^2+dy^2
    semantics: Optional[np.ndarray] = None  # HxWxC float32 distribution

    @property
    def rows(self):
        return self.image.shape[0]

    @property
    def cols(self):
        return self.image.shape[1]

    @property
    def channels(self):
        return 1 if self.image.ndim == 2 else self.image.shape[2]

    @property
    def num_classes(self):
        return 0 if self.semantics is None else self.semantics.shape[2]


def make_raw_image(
    image: np.ndarray,
    semantics: Optional[np.ndarray] = None,
    denoise: bool = True,
    denoise_engine: str = "opencv",
) -> RawImage:
    """denoise_engine: 'opencv' = cv2.fastNlMeansDenoising(Colored), the
    reference's exact call (RawImage.cpp:22-25) on the host CPU;
    'device' = ops/nlm.py NL-means on the accelerator (equal-or-better
    PSNR, tests/test_nlm.py)."""
    image = np.asarray(image)
    if denoise:
        if denoise_engine == "device":
            from unified_cvo_tpu.ops.nlm import nlm_denoise_uint8

            image = nlm_denoise_uint8(image)
        elif image.ndim == 3:
            image = cv2.fastNlMeansDenoisingColored(image, None, 10, 10, 7, 21)
        else:
            image = cv2.fastNlMeansDenoising(image, None, 10, 7, 21)
    if image.ndim == 3:
        gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY).astype(np.float32)
    else:
        gray = image.astype(np.float32)

    dx = np.zeros_like(gray)
    dy = np.zeros_like(gray)
    dx[:, 1:-1] = 0.5 * (gray[:, 2:] - gray[:, :-2])
    dy[1:-1, :] = 0.5 * (gray[2:, :] - gray[:-2, :])
    # reference zeroes first/last rows implicitly (loop bounds) and edge cols
    dx[0, :] = dx[-1, :] = 0
    dy[0, :] = dy[-1, :] = 0
    grad = np.stack([dx, dy], axis=-1)
    return RawImage(
        image=image,
        intensity=gray,
        gradient=grad,
        gradient_square=dx * dx + dy * dy,
        semantics=None if semantics is None else np.asarray(semantics, np.float32),
    )


def pixel_features(raw: RawImage, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Per-pixel feature rows matching the reference layout
    (CvoPointCloud.cpp:744-768): 3-channel images give
    [b,g,r]/255, dx/500+0.5, dy/500+0.5 (5 dims); grayscale gives
    [i/255, dx/500+0.5, dy/500+0.5] (3 dims)."""
    g = raw.gradient[v, u] / 500.0 + 0.5
    if raw.channels == 3:
        bgr = raw.image[v, u].astype(np.float32) / 255.0
        return np.concatenate([bgr, g], axis=-1).astype(np.float32)
    inten = raw.image[v, u].astype(np.float32)[..., None] / 255.0
    return np.concatenate([inten, g], axis=-1).astype(np.float32)
