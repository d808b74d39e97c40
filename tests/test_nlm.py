"""Device NL-means denoise (ops/nlm.py) vs the reference's OpenCV call.

The reference denoises every frame with cv2.fastNlMeansDenoising(Colored)
(h=10, template 7, search 21; RawImage.cpp:22-25). Our kernel must deliver
the same denoising strength: PSNR against the clean image within 1 dB of
OpenCV's, and pixelwise agreement with OpenCV well above the noise floor.
"""

import cv2
import numpy as np
import pytest

from unified_cvo_tpu.ops.nlm import nlm_denoise, nlm_denoise_uint8


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / mse)


def _scene(h=96, w=160, color=True, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    clean = (
        120 + 60 * np.sin(xx / 30.0) * np.cos(yy / 22.0)
        + 40 * ((xx // 48 + yy // 36) % 2)
    ).astype(np.float32)
    if color:
        clean = np.stack(
            [clean, np.roll(clean, 9, 1), np.roll(clean, 5, 0)], -1)
    noisy = np.clip(clean + rng.normal(scale=12, size=clean.shape), 0, 255)
    return clean, noisy.astype(np.uint8)


@pytest.mark.parametrize("color", [True, False])
def test_nlm_matches_opencv_strength(color):
    clean, noisy = _scene(color=color)
    if color:
        cv_out = cv2.fastNlMeansDenoisingColored(noisy, None, 10, 10, 7, 21)
    else:
        cv_out = cv2.fastNlMeansDenoising(noisy, None, 10, 7, 21)
    ours = nlm_denoise_uint8(noisy)

    p_noisy = _psnr(noisy, clean)
    p_cv = _psnr(cv_out, clean)
    p_ours = _psnr(ours, clean)
    # both must actually denoise, and ours must be within 1 dB of OpenCV
    assert p_cv > p_noisy + 2, (p_cv, p_noisy)
    assert p_ours > p_cv - 1.0, (p_ours, p_cv)
    # pixelwise agreement with OpenCV clearly above the noise floor
    assert _psnr(ours, cv_out) > p_noisy + 4


def test_nlm_identity_on_constant():
    img = np.full((40, 64), 77.0, np.float32)
    out = np.asarray(nlm_denoise(img))
    np.testing.assert_allclose(out, img, atol=1e-3)


def test_nlm_shape_and_dtype():
    _, noisy = _scene(h=48, w=80, color=True)
    out = nlm_denoise_uint8(noisy)
    assert out.shape == noisy.shape and out.dtype == np.uint8
    _, gray = _scene(h=48, w=80, color=False)
    out = nlm_denoise_uint8(gray)
    assert out.shape == gray.shape
