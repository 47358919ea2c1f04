"""Port ROI crop (gather form) == JAX crops (matmul and gather forms)."""
import numpy as np
import torch
import jax.numpy as jnp

from dpig_tpu.ops import crop as jcrop
from dpig_tpu_torch.ops import crop as tcrop
from dpig_tpu_torch.ops import image as timage

torch.set_num_threads(1)

ATOL = 1e-5  # f32 bilinear weights; the two sides sum in another order


def test_crop_body_rois_matches_jax(rng):
    b, h, w, c, p, roi = 3, 32, 16, 5, 7, 12
    feat = rng.standard_normal((b, h, w, c)).astype(np.float32)
    y1 = rng.integers(-4, h // 2, (b, p, 1))
    x1 = rng.integers(-4, w // 2, (b, p, 1))
    bbox = np.concatenate(
        [y1, x1, y1 + rng.integers(1, h, (b, p, 1)),
         x1 + rng.integers(1, w, (b, p, 1))], -1).astype(np.int32)
    port = tcrop.crop_body_rois(torch.from_numpy(feat),
                                torch.from_numpy(bbox), roi).numpy()
    ref = np.asarray(jcrop.crop_body_rois_mm(jnp.asarray(feat),
                                             jnp.asarray(bbox), roi))
    assert port.shape == (p * b, roi, roi, c)
    np.testing.assert_allclose(port, ref, atol=ATOL, rtol=0)
    # boxes reaching outside the image produce exact zeros on both sides
    assert (ref == 0).any()


def test_crop_and_resize_matches_jax(rng):
    b, h, w, c = 4, 20, 12, 3
    feat = rng.standard_normal((b, h, w, c)).astype(np.float32)
    boxes = rng.uniform(-0.2, 1.2, (b, 4)).astype(np.float32)
    for ch, cw in ((7, 5), (1, 1)):
        port = tcrop.crop_and_resize(torch.from_numpy(feat),
                                     torch.from_numpy(boxes), ch, cw).numpy()
        ref = np.asarray(jcrop.crop_and_resize(jnp.asarray(feat),
                                               jnp.asarray(boxes), ch, cw))
        np.testing.assert_allclose(port, ref, atol=ATOL, rtol=0)


def test_image_ops_match_jax(rng):
    from dpig_tpu.ops import image as jimage
    x = rng.uniform(-1.5, 1.5, (2, 4, 3, 5)).astype(np.float32)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    for tf, jf in ((timage.upscale_nn, jimage.upscale_nn),
                   (timage.denorm_img, jimage.denorm_img),
                   (timage.process_image, jimage.process_image),
                   (timage.unprocess_image, jimage.unprocess_image)):
        np.testing.assert_array_equal(tf(t).numpy(), np.asarray(jf(j)))
