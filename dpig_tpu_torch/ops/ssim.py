"""In-graph SSIM / MS-SSIM (port of `dpig_tpu/ops/ssim.py`; reference
models.py:19-87 tf_ssim / tf_ms_ssim).

Gaussian-window SSIM on NHWC single-channel images [B, H, W, 1], VALID
padding, L=1. Nothing in either package calls it; the *evaluation*
protocol (skimage-style uniform-window SSIM, score.py:59-64) is
`eval/metrics.py`.

Where an image is smaller than the window, JAX's VALID conv leaves an
empty map whose mean is NaN (MS-SSIM at Market 128x64 reaches 8x4 at its
fifth level); the port raises a ValueError instead, naming the smallest
size it accepts (ROADMAP §3, reference properties).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .image import avg_pool_2x

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _fspecial_gauss(size: int, sigma: float) -> np.ndarray:
    """MATLAB fspecial('gaussian') (reference models.py:19-34)."""
    coords = np.mgrid[-size // 2 + 1: size // 2 + 1,
                      -size // 2 + 1: size // 2 + 1]
    x, y = coords[0], coords[1]
    g = np.exp(-((x ** 2 + y ** 2) / (2.0 * sigma ** 2)))
    return (g / g.sum()).astype(np.float32)


def _conv_valid(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """VALID correlation of [B, H, W, 1] with a [kh, kw] window, NCHW
    [B, 1, H', W'] out."""
    return F.conv2d(img.permute(0, 3, 1, 2), window[None, None])


def ssim(img1: torch.Tensor, img2: torch.Tensor, cs_map: bool = False,
         mean_metric: bool = True, size: int = 11, sigma: float = 1.5):
    """Gaussian-window SSIM, L=1, K1=.01, K2=.03 (models.py:37-62); with
    `mean_metric=False` the maps, NHWC [B, H-size+1, W-size+1, 1]."""
    if min(img1.shape[1], img1.shape[2]) < size:
        raise ValueError(
            f"ssim needs images of at least {size}x{size} px for its "
            f"{size}x{size} window (got {tuple(img1.shape)}); JAX returns "
            "NaN there")
    window = torch.from_numpy(_fspecial_gauss(size, sigma)).to(
        device=img1.device, dtype=img1.dtype)
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    mu1 = _conv_valid(img1, window)
    mu2 = _conv_valid(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _conv_valid(img1 * img1, window) - mu1_sq
    sigma2_sq = _conv_valid(img2 * img2, window) - mu2_sq
    sigma12 = _conv_valid(img1 * img2, window) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if cs_map:
        cs = (2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
        if mean_metric:
            return ssim_map.mean(), cs.mean()
        return ssim_map.permute(0, 2, 3, 1), cs.permute(0, 2, 3, 1)
    return ssim_map.mean() if mean_metric else ssim_map.permute(0, 2, 3, 1)


def ms_ssim_min_size(level: int = 5, size: int = 11) -> int:
    """The smallest side `ms_ssim` accepts: the last of `level` scales,
    ceil(side / 2^(level-1)) after the SAME pools, must hold the window."""
    return (size - 1) * 2 ** (level - 1) + 1


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor,
            level: int = 5) -> torch.Tensor:
    """Multi-scale SSIM (models.py:65-87): the product of the first
    level-1 scales' mean cs to the MS-SSIM weights and the last scale's
    mean SSIM to its weight, halving the images between scales by
    `avg_pool_2x`."""
    need = ms_ssim_min_size(level)
    if min(img1.shape[1], img1.shape[2]) < need:
        raise ValueError(
            f"ms_ssim with level={level} needs images of at least "
            f"{need}x{need} px (got {tuple(img1.shape)}): its last scale "
            "would be smaller than the 11x11 window, where JAX returns NaN")
    mssim, mcs = [], []
    for _ in range(level):
        s, cs = ssim(img1, img2, cs_map=True, mean_metric=True)
        mssim.append(s)
        mcs.append(cs)
        img1 = avg_pool_2x(img1)
        img2 = avg_pool_2x(img2)
    weights = MS_SSIM_WEIGHTS
    return torch.stack([mcs[i] ** weights[i] for i in range(level - 1)]
                       ).prod() * mssim[level - 1] ** weights[level - 1]
