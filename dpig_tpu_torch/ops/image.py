"""Image normalization / resizing (port of `dpig_tpu/ops/image.py:12-66`),
the MS-SSIM pyramid's 2x average pool (`:86-90`) and the embedding slerp
(`:93-106`, numpy on the host).

Reference semantics: utils.py:102-107 (process/unprocess), utils.py:88-89
(denorm+clip), utils.py:70-72 (nearest-neighbor upscale), utils.py:91-97
(slerp). NHWC tensors.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def process_image(image: torch.Tensor, mean_pixel: float = 127.5,
                  norm: float = 127.5) -> torch.Tensor:
    """uint8-range image -> [-1, 1] floats (reference utils.py:102-103)."""
    return (image - mean_pixel) / norm


def unprocess_image(image: torch.Tensor, mean_pixel: float = 127.5,
                    norm: float = 127.5) -> torch.Tensor:
    """[-1, 1] floats -> uint8-range (reference utils.py:106-107)."""
    return image * norm + mean_pixel


def denorm_img(norm: torch.Tensor) -> torch.Tensor:
    """[-1,1] -> [0,255] clipped (reference utils.py:88-89)."""
    return torch.clamp((norm + 1.0) * 127.5, 0.0, 255.0)


def upscale_nn(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbor integer upsample of an NHWC tensor
    (tf.image.resize_nearest_neighbor, reference utils.py:61-72).
    Autograd through the expand and reshape sums each scale x scale group
    of the output gradient, the JAX package's custom VJP."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, scale, w, scale, c)
    return x.reshape(b, h * scale, w * scale, c)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 average pool of an NHWC tensor under XLA's SAME padding: an
    odd side is padded by one zero after (none before), and every cell,
    the edge's too, is its sum divided by 4 (`F.avg_pool2d`'s own
    padding is symmetric, hence the explicit pad)."""
    h, w = x.shape[1], x.shape[2]
    x = F.pad(x.permute(0, 3, 1, 2), (0, w % 2, 0, h % 2))
    return F.avg_pool2d(x, 2).permute(0, 2, 3, 1)


def slerp(val, low, high):
    """Spherical interpolation (reference utils.py:91-97). Works on 1-D
    embedding vectors; falls back to lerp for (near-)parallel inputs."""
    low = np.asarray(low)
    high = np.asarray(high)
    omega = np.arccos(np.clip(
        np.dot(low / np.linalg.norm(low), high / np.linalg.norm(high)),
        -1, 1))
    so = np.sin(omega)
    if so == 0:
        return (1.0 - val) * low + val * high
    return (np.sin((1.0 - val) * omega) / so * low
            + np.sin(val * omega) / so * high)
