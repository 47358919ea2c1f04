"""Evaluation metrics: the port's own copy of `dpig_tpu/eval/metrics.py`
(score.py / score_mask.py protocol: skimage compare_ssim defaults, 7x7
uniform window, sample covariance, K1=.01, K2=.03, grayscale
Y=.2125R+.7154G+.0721B).

The numpy functions (`rgb2gray`, `ssim`, `ssim_images`) are the testers'
and the int8 gate's preview SSIM. The scoring protocol below them runs
batched on float64 tensors, on the card or the CPU (`eval/score.py`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
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


# ----------------------------------------------------------------------
# The scoring protocol (`dpig_tpu/eval/metrics.py:54-115`): the same
# functions, batched, on float64 tensors on any device. Each takes a batch
# of images [B,H,W,C] (masks [B,H,W] or [B,H,W,C]) in the numpy
# functions' value ranges and returns one float64 value per image ([B]).
# The 7x7 uniform window is `avg_pool2d` without padding: SSIM keeps only
# the interior where the window lies inside the image, so scipy's reflect
# padding never enters. A window holding one value has variance (and
# covariance) exactly 0 here; scipy's running sums give exactly 0 for most
# such values, a few (gray 7/255) keep ~1e-19, and where the data range is
# also 0 (a flat target) the two then read NaN against 1 or noise.

F64 = torch.float64
WIN = 7


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d correctly rounded, as numpy divides: on the card PyTorch
    multiplies by the reciprocal of a Python or CPU scalar divisor, one
    rounding more, which moves `mask / 255 * img` across a uint8
    truncation boundary; a divisor on x's device is divided by."""
    return x / torch.tensor(d, dtype=F64, device=x.device)


def rgb2gray_batch(img: torch.Tensor) -> torch.Tensor:
    """[B,H,W,3] -> [B,H,W] float64; each image divided by 255 only when
    its own max exceeds 1 (`rgb2gray`)."""
    img = img.to(F64)
    big = img.amax(dim=(1, 2, 3)) > 1.0 + 1e-6
    img = torch.where(big[:, None, None, None], _div(img, 255.0), img)
    return img @ torch.as_tensor(_GRAY_W, dtype=F64, device=img.device)


def _window(fn, x: torch.Tensor) -> torch.Tensor:
    return fn(x[:, None], WIN, stride=1)[:, 0]


def ssim_batch(im1: torch.Tensor, im2: torch.Tensor,
               data_range: torch.Tensor) -> torch.Tensor:
    """`ssim` of each pair of single-channel images [N,H,W] at its own
    data range [N] (or a scalar) -> [N] float64."""
    im1, im2 = im1.to(F64), im2.to(F64)
    dr = torch.as_tensor(data_range, dtype=F64, device=im1.device)
    dr = dr.reshape(-1, 1, 1) if dr.dim() else dr
    n = WIN ** 2
    cov_norm = n / (n - 1)
    ux, uy = _window(F.avg_pool2d, im1), _window(F.avg_pool2d, im2)
    uxx = _window(F.avg_pool2d, im1 * im1)
    uyy = _window(F.avg_pool2d, im2 * im2)
    uxy = _window(F.avg_pool2d, im1 * im2)

    def flat(x):
        return _window(F.max_pool2d, x) == -_window(F.max_pool2d, -x)

    fx, fy = flat(im1), flat(im2)
    zero = torch.zeros((), dtype=F64, device=im1.device)
    vx = torch.where(fx, zero, cov_norm * (uxx - ux * ux))
    vy = torch.where(fy, zero, cov_norm * (uyy - uy * uy))
    vxy = torch.where(fx | fy, zero, cov_norm * (uxy - ux * uy))
    c1 = (0.01 * dr) ** 2
    c2 = (0.03 * dr) ** 2
    a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
    b1, b2 = ux ** 2 + uy ** 2 + c1, vx + vy + c2
    return ((a1 * a2) / (b1 * b2)).mean(dim=(1, 2))


def ssim_multichannel(im1: torch.Tensor, im2: torch.Tensor,
                      data_range: float) -> torch.Tensor:
    """Channel-mean SSIM of [B,H,W,C] pairs (`ssim_multichannel`)."""
    b, h, w, c = im1.shape

    def planes(x):
        return x.permute(0, 3, 1, 2).reshape(b * c, h, w)

    return ssim_batch(planes(im1), planes(im2), data_range).reshape(
        b, c).mean(dim=1)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.to(F64).reshape(x.shape[0], -1)


def psnr(im_true: torch.Tensor, im_test: torch.Tensor,
         data_range) -> torch.Tensor:
    """10 log10(data_range^2 / MSE) per image, +inf where MSE is 0."""
    mse = ((_flat(im_true) - _flat(im_test)) ** 2).mean(dim=1)
    dr = torch.as_tensor(data_range, dtype=F64, device=mse.device)
    return torch.where(mse == 0, torch.inf,
                       10.0 * torch.log10(dr ** 2 / mse))


def l1_mean_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = _flat(x) - _flat(y)
    return _div(d.abs().sum(dim=1), d.shape[1])


def l2_mean_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt(sum d^2) / numel per image: not an RMS (`l2_mean_dist`)."""
    d = _flat(x) - _flat(y)
    return _div(torch.sqrt((d ** 2).sum(dim=1)), d.shape[1])


def score_pair_gray(g: torch.Tensor,
                    x_target: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The per-image protocol (`score_pair_gray`): grayscale, each
    target's own gray range as the data range (0 for a flat target: NaN
    SSIM, +-inf PSNR, as in JAX)."""
    g_gray = rgb2gray_batch(torch.clamp(g.to(F64), 0, 255))
    x_gray = rgb2gray_batch(torch.clamp(x_target.to(F64), 0, 255))
    dr = x_gray.amax(dim=(1, 2)) - x_gray.amin(dim=(1, 2))
    return {"ssim": ssim_batch(g_gray, x_gray, dr),
            "psnr": psnr(x_gray, g_gray, dr),
            "l1": l1_mean_dist(g_gray, x_gray),
            "l2": l2_mean_dist(g_gray, x_gray)}


def apply_mask_uint8(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """`uint8(mask / 255. * img)` per image: the graded mask scaled, the
    product truncated to uint8, not binarized; a [B,H,W] mask spans the
    channels."""
    m = _div(mask.to(F64), 255.0)
    if m.dim() == 3:
        m = m[..., None]
    return (m * img.to(F64)).to(torch.uint8)


def score_pair_masked(g: torch.Tensor, x_target: torch.Tensor,
                      mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The masked protocol (`score_pair_masked`): both images masked to
    uint8, multichannel SSIM and PSNR at data_range 255."""
    gm = apply_mask_uint8(g, mask)
    xm = apply_mask_uint8(x_target, mask)
    return {"ssim": ssim_multichannel(gm, xm, 255.0),
            "psnr": psnr(xm, gm, 255.0),
            "l1": l1_mean_dist(gm, xm),
            "l2": l2_mean_dist(gm, xm)}
