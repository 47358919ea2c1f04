"""Port pose ops == JAX pose ops (jnp closed form and the Pallas kernel in
interpret mode), bit for bit; the CUDA wrapper refuses CPU tensors."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dpig_tpu.ops import pose as jpose
from dpig_tpu.ops.pose_pallas import render_pose_maps_pallas
from dpig_tpu_torch.kernels import pose_raster
from dpig_tpu_torch.ops import pose as tpose

torch.set_num_threads(1)

B, H, W, K = 2, 64, 32, 18


def _rcv(rng, normalized):
    lo_r, hi_r = (-1.2, 1.2) if normalized else (-2, H + 2)
    lo_c, hi_c = (-1.2, 1.2) if normalized else (-2, W + 2)
    return np.stack([
        rng.uniform(lo_r, hi_r, (B, K)),
        rng.uniform(lo_c, hi_c, (B, K)),
        (rng.uniform(size=(B, K)) > 0.3).astype(np.float32)],
        -1).astype(np.float32)


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("radius", [4, 0])
def test_render_pose_maps_matches_jax_and_pallas(rng, normalized, radius):
    rcv = _rcv(rng, normalized)
    flat = rcv.reshape(B, K * 3)
    port = tpose.render_pose_maps(torch.from_numpy(flat), H, W, K, radius,
                                  normalized).numpy()
    ref = np.asarray(jpose.render_pose_maps(jnp.asarray(flat), H, W, K,
                                            radius, normalized))
    pallas = np.asarray(render_pose_maps_pallas(
        jnp.asarray(rcv), H, W, K, radius, normalized, interpret=True))
    assert port.dtype == np.float32 and port.shape == (B, H, W, K)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, pallas)
    # the data must exercise both signs and dropped keypoints
    assert (port == 1).any() and (port == -1).any()


@pytest.mark.parametrize("normalized", [False, True])
def test_nan_and_huge_coords_convert_as_xla_does(rng, normalized):
    """XLA converts float32 -> int32 with NaN -> 0 and saturation, so JAX
    draws a NaN row or column at 0 and drops +-3e9 (pixel coords) or clips
    it to the border (normalized coords)."""
    rcv = _rcv(rng, normalized)
    x, y = (0.3, -0.4) if normalized else (5.0, 2.0)
    odd = [(np.nan, x), (y, np.nan), (3e9, y), (-3e9, y), (x, 3e9),
           (x, -3e9)]
    for k, (r, c) in enumerate(odd):
        rcv[0, k] = (r, c, 1.0)
    flat = rcv.reshape(B, K * 3)
    port = tpose.render_pose_maps(torch.from_numpy(flat), H, W, K, 4,
                                  normalized).numpy()
    ref = np.asarray(jpose.render_pose_maps(jnp.asarray(flat), H, W, K, 4,
                                            normalized))
    np.testing.assert_array_equal(port, ref)
    assert (port[0, 0, :, 0] == 1).any() and (port[0, :, 0, 1] == 1).any()


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("radius", range(13))
def test_radius_and_offset_sweep_matches_jax(radius, normalized):
    """Sample b holds keypoint k at pixel (b - 2, k - 2): every row and
    column offset of a 9x6 image, its borders and two pixels beyond."""
    h, w = 9, 6
    rr, cc = np.meshgrid(np.arange(-2, h + 2), np.arange(-2, w + 2),
                         indexing="ij")
    b, k = rr.shape
    rcv = np.stack([rr, cc, np.ones_like(rr)], -1).astype(np.float32)
    if normalized:
        rcv = np.array(jpose.pose_rcv_normalize(jnp.asarray(rcv), h, w))
    flat = rcv.reshape(b, k * 3)
    port = tpose.render_pose_maps(torch.from_numpy(flat), h, w, k, radius,
                                  normalized).numpy()
    ref = np.asarray(jpose.render_pose_maps(jnp.asarray(flat), h, w, k,
                                            radius, normalized))
    np.testing.assert_array_equal(port, ref)


def test_rcv_normalize_roundtrip_and_helpers(rng):
    rcv = _rcv(rng, False)
    t = torch.from_numpy(rcv)
    j = jnp.asarray(rcv)
    np.testing.assert_array_equal(tpose.pose_rcv_normalize(t, H, W).numpy(),
                                  np.asarray(jpose.pose_rcv_normalize(j, H, W)))
    np.testing.assert_array_equal(
        tpose.pose_rcv_denormalize(t / 40.0, H, W).numpy(),
        np.asarray(jpose.pose_rcv_denormalize(j / 40.0, H, W)))
    maps = tpose.render_pose_maps(t, H, W, K)
    np.testing.assert_array_equal(
        tpose.pose_maps_to_image(maps).numpy(),
        np.asarray(jpose.pose_maps_to_image(jnp.asarray(maps.numpy()))))
    np.testing.assert_array_equal(
        tpose.render_pose_points(t / 40.0, H, W, K).numpy(),
        np.asarray(jpose.render_pose_points(j / 40.0, H, W, K)))


def test_cuda_wrapper_refuses_cpu_tensors():
    launches = pose_raster.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        pose_raster.render_pose_maps_cuda(torch.zeros(1, K * 3), H, W, K)
    assert pose_raster.launches == launches
