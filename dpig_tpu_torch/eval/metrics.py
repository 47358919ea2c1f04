"""Preview SSIM: the port's own copy of `dpig_tpu/eval/metrics.py:21-51,
118-129` (score.py protocol: skimage compare_ssim defaults, 7x7 uniform
window, sample covariance, K1=.01, K2=.03, grayscale Y=.2125R+.7154G+.0721B).
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter

_GRAY_W = np.array([0.2125, 0.7154, 0.0721])


def rgb2gray(img: np.ndarray) -> np.ndarray:
    """uint8-range [H,W,3] -> [H,W] float in [0,1] (skimage convention)."""
    img = np.asarray(img, dtype=np.float64)
    if img.max() > 1.0 + 1e-6:
        img = img / 255.0
    return img @ _GRAY_W


def ssim(im1: np.ndarray, im2: np.ndarray, data_range: float,
         win_size: int = 7) -> float:
    """skimage.compare_ssim(multichannel=False) defaults."""
    im1 = np.asarray(im1, np.float64)
    im2 = np.asarray(im2, np.float64)
    np_ = win_size ** im1.ndim
    cov_norm = np_ / (np_ - 1)  # sample covariance (use_sample_covariance)
    filt = lambda x: uniform_filter(x, size=win_size)  # noqa: E731
    ux, uy = filt(im1), filt(im2)
    uxx, uyy, uxy = filt(im1 * im1), filt(im2 * im2), filt(im1 * im2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
    b1, b2 = ux ** 2 + uy ** 2 + c1, vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    pad = (win_size - 1) // 2
    return float(s[pad:-pad or None, pad:-pad or None].mean())


def ssim_images(g_batch: np.ndarray, x_batch: np.ndarray) -> np.ndarray:
    """Batched grayscale SSIM (the trainer preview metric,
    trainer.py:516-521)."""
    g_batch = np.asarray(g_batch)
    x_batch = np.asarray(x_batch)
    out = []
    for i in range(g_batch.shape[0]):
        g_gray = rgb2gray(np.clip(g_batch[i], 0, 255).astype(np.uint8))
        x_gray = rgb2gray(np.clip(x_batch[i], 0, 255).astype(np.uint8))
        dr = x_gray.max() - x_gray.min()
        out.append(ssim(g_gray, x_gray, data_range=dr if dr > 0 else 1.0))
    return np.asarray(out)
