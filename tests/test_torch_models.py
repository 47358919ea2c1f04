"""Port modules == flax modules with bridged params: the FG/BG ROI encoder,
the U-net generator (constant-embedding stem) and the DCGAN D, each on the
same numpy inputs, plus the XLA SAME padding rule the convs rely on.

Tolerance 1e-4 max abs: both sides are float32 but sum the conv products
in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpig_tpu.apps import common as jcommon
from dpig_tpu.apps.stage1_app import Stage1App as JaxStage1App
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.data.synthetic import synthetic_batch
from dpig_tpu.ops.pose import render_pose_maps
from dpig_tpu_torch.apps.common import pose_maps_from_batch, select_parts
from dpig_tpu_torch.apps.stage1_app import Stage1App
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.models.layers import conv2d_same, same_pads

torch.set_num_threads(1)

TOL = 1e-4
SMALL = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16)


def _perturb(tree, rng):
    """Random biases, BN scales and BN stats (all start at 0 or 1), so the
    bridge of every leaf is exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("bias", "stem_bias", "scale", "mean"):
            out[k] = np.asarray(v) + rng.normal(0, 0.1, v.shape).astype(
                np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(7)
    japp = JaxStage1App(JaxConfig(**SMALL))
    st = japp.init_state(jax.random.PRNGKey(3))
    tree = _perturb({"Encoder": st.g_params["Encoder"],
                     "ID_AE": st.g_params["ID_AE"],
                     "Discriminator": st.d_params["Discriminator"],
                     "Discriminator_stats": st.d_stats}, rng)
    app = Stage1App(Config(platform="cpu", **SMALL), torch.device("cpu"),
                    state=params_from_flax(tree))
    batch = synthetic_batch(rng, 4, 32, 16)
    return japp, tree, app, batch


def _t(a):
    return torch.from_numpy(np.array(a))


def test_encoder_matches_flax(nets):
    japp, tree, app, b = nets
    bbox, vis = b["part_bbox"][:, :7], b["part_vis"][:, :7].astype(np.float32)
    ref = japp.encoder.apply({"params": tree["Encoder"]}, b["x"],
                             b["mask_r6"], bbox, vis)
    port = app.encoder(_t(b["x"]), _t(b["mask_r6"]),
                       *select_parts(_t(b["part_bbox"]), _t(b["part_vis"])))
    assert port.shape == (4, 7 * 32 + 4 * 32)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_generator_matches_flax(nets, rng):
    japp, tree, app, b = nets
    embs = rng.normal(0, 1, (4, 352)).astype(np.float32)
    pose = np.asarray(render_pose_maps(jnp.asarray(b["pose_rcv"]), 32, 16))
    ref, ref_z = japp.generator.apply({"params": tree["ID_AE"]}, None, pose,
                                      embs_const=embs)
    with torch.no_grad():
        port, z = app.generator(_t(embs), _t(pose))
    assert port.shape == (4, 32, 16, 3)
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), atol=TOL, rtol=0)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("train", [True, False])
def test_discriminator_matches_flax(nets, train):
    japp, tree, app, b = nets
    img = b["x_target"]
    ref, _ = japp.disc.apply(
        {"params": tree["Discriminator"],
         "batch_stats": tree["Discriminator_stats"]},
        img, train=train, mutable=["batch_stats"])
    before = {k: v.clone() for k, v in app.disc.state_dict().items()}
    with torch.no_grad():
        port = app.disc(_t(img), train=train)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)
    for k, v in app.disc.state_dict().items():  # no running buffer moved
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_stage1_transfer_step_matches_flax(nets):
    """Stage1App.transfer_step (encode, generate under the target pose,
    [0,255]) with the target pose maps of pose_maps_from_batch."""
    japp, tree, app, b = nets
    bbox, vis = b["part_bbox"][:, :7], b["part_vis"][:, :7].astype(np.float32)
    jpose = jcommon.pose_maps_from_batch(
        {k: jnp.asarray(v) for k, v in b.items()}, japp.cfg, "pose_rcv_target")
    ref = japp.transfer_step({k: tree[k] for k in ("Encoder", "ID_AE")},
                             b["x"], jpose, b["mask_r6"], bbox, vis)
    tb = {k: _t(v) for k, v in b.items()}
    pose = pose_maps_from_batch(tb, app.cfg, "pose_rcv_target")
    port = app.transfer_step(tb["x"], pose, tb["mask_r6"],
                             *select_parts(tb["part_bbox"], tb["part_vis"]))
    np.testing.assert_array_equal(pose.numpy(), np.asarray(jpose))
    # 2e-2 on [0,255] is the 1e-4 bound on g_raw times 127.5
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=2e-2,
                               rtol=0)


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (8, 3, 2, (0, 1)), (8, 5, 2, (1, 2)), (7, 3, 2, (1, 1)),
    (8, 3, 1, (1, 1)), (8, 1, 1, (0, 0))])
def test_same_padding_matches_xla(rng, size, kernel, stride, pads):
    assert same_pads(size, kernel, stride) == pads
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    k = rng.standard_normal((kernel, kernel, 3, 4)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        x, k, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    port = conv2d_same(_t(x).permute(0, 3, 1, 2), _t(k).permute(3, 2, 0, 1),
                       None, stride).permute(0, 2, 3, 1)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL,
                               rtol=0)


def test_bridge_rejects_missing_and_extra_keys(nets):
    _, tree, _, _ = nets
    with pytest.raises(KeyError, match="missing"):
        params_from_flax({k: v for k, v in tree.items() if k != "ID_AE"})
    # a sub-tree not asked for is left out, one asked for must be there
    assert set(params_from_flax({**tree, "PoseAE": {}})) == set(tree)
    with pytest.raises(KeyError, match="missing.*PoseAE"):
        params_from_flax(tree, (*tree, "PoseAE"))
    bad = dict(tree, Encoder=dict(tree["Encoder"], extra_leaf=np.zeros(2)))
    with pytest.raises(KeyError, match="extra_leaf"):
        params_from_flax(bad)
    state = params_from_flax(tree)
    del state["ID_AE"]["to_rgb.bias"]
    with pytest.raises(RuntimeError, match="to_rgb.bias"):
        Stage1App(Config(platform="cpu", **SMALL), torch.device("cpu"),
                  state=state)
