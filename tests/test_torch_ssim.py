"""The port's in-graph SSIM / MS-SSIM (`dpig_tpu_torch/ops/ssim.py`) and
the pyramid's pool (`ops/image.py:avg_pool_2x`) against the JAX
package's (`dpig_tpu/ops/ssim.py`, `ops/image.py:86-90`), on the CPU in
float32: the Gaussian window bit-equal; the pool on even and odd sizes
(XLA's SAME pad: none before, one zero after, every cell / 4) within
1e-6 (the four terms summed in another order: 0 to 1.2e-7);
SSIM's mean within 1e-6 (readings at most 3.0e-7), its map and the cs
map within 1e-5 (3.2e-6: each is a ratio of variances that are
differences of conv sums, which the two sides add in other orders), its
gradient w.r.t. both images within 1e-4 of the largest; MS-SSIM at
176x176 and 256x256, batch 1, within 1e-5 (1.6e-6). And the reference
property: where an image is smaller than the window at some scale, JAX
returns NaN (MS-SSIM at Market 128x64, whose fifth scale is 8x4) and the
port raises a ValueError naming the smallest size it accepts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpig_tpu.ops import image as jimage
from dpig_tpu.ops import ssim as jssim
from dpig_tpu_torch.ops import image, ssim

torch.set_num_threads(1)


def _pair(seed, b, h, w):
    """An image in [0, 1] and a noisy copy of it, NHWC, one channel."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    noisy = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1)
    return a, noisy.astype(np.float32)


def test_gaussian_window_is_the_jax_one():
    np.testing.assert_array_equal(ssim._fspecial_gauss(11, 1.5),
                                  jssim._fspecial_gauss(11, 1.5))


@pytest.mark.parametrize("h,w", [(16, 8), (11, 7), (5, 5)])
def test_avg_pool_2x_matches_jax(h, w):
    x = np.random.default_rng(1).standard_normal((2, h, w, 3)).astype(
        np.float32)
    got = image.avg_pool_2x(torch.from_numpy(x))
    want = np.asarray(jimage.avg_pool_2x(jnp.asarray(x)))
    assert got.shape == want.shape == (2, -(-h // 2), -(-w // 2), 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    if h % 2:  # the edge row: (a + b + 0 + 0) / 4, not a mean of two
        np.testing.assert_allclose(got[:, -1, 0].numpy(),
                                   (x[:, -1, 0] + x[:, -1, 1]) / 4, atol=1e-6)


@pytest.mark.parametrize("h,w", [(32, 16), (11, 11), (23, 14)])
def test_ssim_matches_jax(h, w):
    a, b = _pair(2, 2, h, w)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(ssim.ssim(ta, tb)),
                               float(jssim.ssim(a, b)), atol=1e-6, rtol=0)
    for cs_map in (False, True):
        got = ssim.ssim(ta, tb, cs_map=cs_map, mean_metric=False)
        want = jssim.ssim(a, b, cs_map=cs_map, mean_metric=False)
        for g, j in zip(got if cs_map else [got], want if cs_map else [want]):
            assert g.shape == j.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5,
                                       rtol=0)
    s, cs = ssim.ssim(ta, tb, cs_map=True)
    js, jcs = jssim.ssim(a, b, cs_map=True)
    assert abs(float(s) - float(js)) <= 1e-6
    assert abs(float(cs) - float(jcs)) <= 1e-6
    ga, gb = jax.grad(lambda x, y: jssim.ssim(x, y), argnums=(0, 1))(a, b)
    ta.requires_grad_(True)
    tb.requires_grad_(True)
    pa, pb = torch.autograd.grad(ssim.ssim(ta, tb), [ta, tb])
    for p, j in ((pa, ga), (pb, gb)):
        j = np.asarray(j)
        assert np.abs(p.numpy() - j).max() <= 1e-4 * np.abs(j).max()


@pytest.mark.parametrize("side", [176, 256])
def test_ms_ssim_matches_jax(side):
    a, b = _pair(3, 1, side, side)
    got = float(ssim.ms_ssim(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(jssim.ms_ssim(jnp.asarray(a), jnp.asarray(b)))
    assert np.isfinite(want) and abs(got - want) <= 1e-5, (got, want)


def test_too_small_images_nan_in_jax_value_error_in_the_port():
    """MS-SSIM at level 5 needs (11 - 1) * 2^4 + 1 = 161 px a side: at 161
    its last scale is 11x11 (a 1x1 map), at 160 and at Market 128x64 it
    is smaller than the window. SSIM itself needs 11 px."""
    assert ssim.ms_ssim_min_size(5) == 161
    a, b = _pair(4, 1, 161, 161)
    got = float(ssim.ms_ssim(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(jssim.ms_ssim(jnp.asarray(a), jnp.asarray(b)))
    assert np.isfinite(want) and abs(got - want) <= 1e-5
    for h, w in ((160, 160), (128, 64)):
        a, b = _pair(5, 1, h, w)
        assert np.isnan(float(jssim.ms_ssim(jnp.asarray(a), jnp.asarray(b))))
        with pytest.raises(ValueError, match="at least 161x161 px"):
            ssim.ms_ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert ssim.ms_ssim_min_size(3) == 41
    a, b = _pair(6, 1, 10, 12)
    assert np.isnan(float(jssim.ssim(a, b)))
    with pytest.raises(ValueError, match="at least 11x11 px"):
        ssim.ssim(torch.from_numpy(a), torch.from_numpy(b))
