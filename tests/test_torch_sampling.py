"""The sampling slice (models 11 and 13, factor interpolation) against the
JAX package at a tiny config: the FC trunk, the Gaussian mappers and the
pose AE with bridged flax params; `_pose_maps` in its three modes; the
testers' steps from the same bridged cold-start params and the same noise
(JAX's own threefry draws, passed to the port as tensors); the CLI
dispatch; work whose result is dead is not done.

Tolerances: 1e-5 on the FC nets' outputs (float32, other summation order);
g on [0,255] within 2e-2 (the 1e-4 g_raw bound times 127.5, as
tests/test_torch_transfer.py); D scores 1e-4; pose maps and decoded
visibility bit-equal."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dpig_tpu.apps import testers as jtesters
from dpig_tpu.apps.stage1_pose import Stage1PoseApp as JaxPoseApp
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.data.synthetic import SyntheticLoader as JaxLoader
from dpig_tpu.models import layers as jlayers
from dpig_tpu.models.mappers import GaussianMapper as JaxMapper
from dpig_tpu.models.mappers import sample_mapper_noise as jax_noise
from dpig_tpu.models.pose_ae import PoseDecoderFC as JaxPoseDecoder
from dpig_tpu.models.pose_ae import PoseEncoderFC as JaxPoseEncoder
from dpig_tpu.ops.image import slerp as jax_slerp
from dpig_tpu.ops.ste import binary_round as jax_binary_round
from dpig_tpu_torch import main as port_main
from dpig_tpu_torch.apps import testers
from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.apps.stage1_pose import POSE_Z, Stage1PoseApp
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.data.synthetic import SyntheticLoader
from dpig_tpu_torch.models.layers import FCResTrunk, leaky_relu
from dpig_tpu_torch.models.mappers import GaussianMapper, sample_mapper_noise
from dpig_tpu_torch.models.pose_ae import PoseDecoderFC, PoseEncoderFC
from dpig_tpu_torch.ops import pose as pose_ops
from dpig_tpu_torch.ops.image import slerp
from dpig_tpu_torch.ops.pose import floor_margin
from dpig_tpu_torch.ops.ste import binary_round

torch.set_num_threads(1)

SMALL = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16)
FC_TOL = 1e-5
FG_DIM, BG_DIM = 7 * 32, 4 * 32
# A decoded keypoint closer than this to a floor boundary could land on
# another pixel on another device; the fixed seeds below keep clear of it.
FLOOR_MARGIN = 1e-3
FULL = testers.FullSamplingTester


def _t(a):
    return torch.from_numpy(np.array(a))


def _perturb_biases(tree, rng):
    """Random biases (flax starts them at 0), so their bridge is used."""
    return {k: _perturb_biases(v, rng) if isinstance(v, dict) else
            (np.asarray(v) + rng.normal(0, 0.1, v.shape).astype(np.float32)
             if k == "bias" else np.asarray(v)) for k, v in tree.items()}


def _flax_init(module, x, seed=0):
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    return _perturb_biases(params, np.random.default_rng(seed))


def _port(module, params):
    state = params_from_flax({"net": params}, ("net",))["net"]
    module.load_state_dict(state, strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def jparams():
    """The JAX FullSamplingTester's cold-start params (every sub-tree of
    models 11/13 and interpolation, plus DeepFashion's `Gaussian_FC`),
    built once for the module."""
    return jtesters.FullSamplingTester(JaxConfig(**SMALL)).params


@pytest.fixture(scope="module")
def state(jparams):
    return params_from_flax(jparams, FULL.SUBTREES)


def _jax_tester(cls, monkeypatch, jparams, tmp_path, **kw):
    monkeypatch.setattr(jtesters._TesterBase, "_restore_params",
                        lambda self: jparams)
    return cls(JaxConfig(model_dir=str(tmp_path), **SMALL, **kw))


def _port_tester(cls, state, tmp_path, **kw):
    return cls(Config(platform="cpu", model_dir=str(tmp_path), **SMALL, **kw),
               params={k: state[k] for k in cls.SUBTREES})


def _batch(seed=3):
    batch = next(JaxLoader(4, 32, 16, seed=seed))
    return batch, {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_step_noise(rng, b=4):
    """The noise JAX's sample steps draw from `rng` (testers.py:339-348,
    303-305), as the port's `draw_noise` dict."""
    r_fg, r_bg, r_pose = jax.random.split(rng, 3)
    noise = {"fg": jax_noise(r_fg, b, FG_DIM), "bg": jax_noise(r_bg, b, BG_DIM),
             "pose": jax_noise(r_pose, b, POSE_Z)}
    return {k: _t(v) for k, v in noise.items()}


# ------------------------------------------------------------- the FC nets
@pytest.mark.parametrize("first", [None, "leaky"])
def test_fc_res_trunk_matches_flax(first):
    act = jlayers.leaky_relu if first else None
    x = np.random.default_rng(1).normal(size=(5, 20)).astype(np.float32)
    jnet = jlayers.FCResTrunk(4, 64, jlayers.leaky_relu, first_activation=act)
    params = _flax_init(jnet, x)
    assert sorted(params) == [f"Dense_{i}" for i in range(9)]
    net = _port(FCResTrunk(20, 4, 64, leaky_relu,
                           leaky_relu if first else None), params)
    ref = jnet.apply({"params": params}, x)
    np.testing.assert_allclose(net(_t(x)).detach().numpy(), np.asarray(ref),
                               atol=FC_TOL, rtol=0)


@pytest.mark.parametrize("dim,hidden", [(FG_DIM, 512), (BG_DIM, 256),
                                        (POSE_Z, 512)])
def test_gaussian_mapper_matches_flax(dim, hidden):
    noise = np.asarray(jax_noise(jax.random.PRNGKey(dim), 6, dim))
    jnet = JaxMapper(out_dim=dim, hidden_num=hidden)
    params = _flax_init(jnet, noise)
    net = _port(GaussianMapper(dim, dim, hidden), params)
    np.testing.assert_allclose(net(_t(noise)).detach().numpy(),
                               np.asarray(jnet.apply({"params": params},
                                                     noise)),
                               atol=FC_TOL, rtol=0)


def test_pose_encoder_matches_flax():
    rcv = np.random.default_rng(2).uniform(-1, 1, (6, 54)).astype(np.float32)
    jnet = JaxPoseEncoder(z_num=POSE_Z)
    params = _flax_init(jnet, rcv)
    net = _port(PoseEncoderFC(18, POSE_Z), params)
    np.testing.assert_allclose(net(_t(rcv)).detach().numpy(),
                               np.asarray(jnet.apply({"params": params}, rcv)),
                               atol=FC_TOL, rtol=0)


def test_pose_decoder_matches_flax():
    z = np.random.default_rng(3).normal(size=(8, POSE_Z)).astype(np.float32)
    jnet = JaxPoseDecoder(keypoint_num=18)
    params = _flax_init(jnet, z)
    net = _port(PoseDecoderFC(18, POSE_Z), params)
    coords_ref, vis_ref = jnet.apply({"params": params}, z)
    coords, vis = net(_t(z))
    np.testing.assert_allclose(coords.detach().numpy(), np.asarray(coords_ref),
                               atol=FC_TOL, rtol=0)
    np.testing.assert_array_equal(vis.detach().numpy(), np.asarray(vis_ref))
    assert set(np.unique(vis.detach().numpy())) == {0.0, 1.0}


def test_binary_round_matches_jax():
    x = np.array([0.0, 0.2, 0.5, 0.50001, 0.7, 0.99999, 1.0, 1.5, 2.5],
                 np.float32)
    np.testing.assert_array_equal(binary_round(_t(x)).numpy(),
                                  np.asarray(jax_binary_round(jnp.asarray(x))))
    xt = _t(x).requires_grad_(True)
    (grad,) = torch.autograd.grad(binary_round(xt).sum(), xt)
    np.testing.assert_array_equal(grad.numpy(), np.ones_like(x))  # identity


def test_slerp_matches_jax():
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(2, 32)).astype(np.float32)
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(slerp(t, a, b), jax_slerp(t, a, b))
    np.testing.assert_array_equal(slerp(0.4, a, 2 * a), jax_slerp(0.4, a, 2 * a))


def test_pose_app_matches_jax(jparams, tmp_path):
    """autoencode, and decode_pose with its radius-0 preview (its train
    step, model 2: tests/test_torch_stage2.py)."""
    cfg = Config(platform="cpu", model_dir=str(tmp_path), **SMALL)
    app = Stage1PoseApp(cfg, torch.device("cpu"),
                        params_from_flax(jparams, ("PoseAE",)))
    japp = JaxPoseApp(JaxConfig(**SMALL))
    rcv = np.random.default_rng(5).uniform(-1, 1, (4, 54)).astype(np.float32)
    (recon_ref, z_ref), (recon, z) = (japp.autoencode(jparams, rcv),
                                      app.autoencode(_t(rcv)))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=FC_TOL,
                               rtol=0)
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_ref),
                               atol=FC_TOL, rtol=0)
    rcv_ref, maps_ref = japp.decode_pose({"PoseAE": jparams["PoseAE"]},
                                         jnp.asarray(z_ref))
    rcv_p, maps = app.decode_pose(_t(z_ref))
    np.testing.assert_allclose(rcv_p.numpy(), np.asarray(rcv_ref),
                               atol=FC_TOL, rtol=0)
    assert floor_margin(rcv_p, 32, 16) >= FLOOR_MARGIN
    np.testing.assert_array_equal(maps.numpy(), np.asarray(maps_ref))


def test_floor_margin():
    """Distance to the integers 1 .. size-1, where the clipped floor of a
    normalized keypoint changes; invisible keypoints do not count."""
    h, w = 32, 16

    def norm(row, col, vis=1.0):
        return [row / h * 2 - 1, col / w * 2 - 1, vis]

    rcv = torch.tensor([[norm(7.5, 2.9), norm(3.25, 8.0, 0.0),
                         norm(96.0, -48.0), norm(0.0001, 15.2)]])
    # 2.9 is 0.1 from 3; 0.0001 and -48 clip to 0, 15.2 is 0.2 above 15
    assert abs(floor_margin(rcv, h, w) - 0.1) < 1e-5
    rcv[0, 1, 2] = 1.0  # col 8.0 is on a boundary
    assert floor_margin(rcv, h, w) < 1e-5


# --------------------------------------------------------- tester steps
@pytest.mark.parametrize("pose_source", ["real", "reconstructed", "sampled"])
def test_pose_maps_match_jax(jparams, state, tmp_path, monkeypatch,
                             pose_source):
    jt = _jax_tester(jtesters.FullSamplingTester, monkeypatch, jparams,
                     tmp_path)
    t = _port_tester(FULL, state, tmp_path)
    batch, jb = _batch()
    rng = jax.random.PRNGKey(11)
    maps_ref, rcv_ref = jt._pose_maps(jparams, jb, rng, pose_source)
    with torch.inference_mode():
        maps, rcv = t._pose_maps(batch_to_device(batch, t.device),
                                 _t(jax_noise(rng, 4, POSE_Z)), pose_source)
    np.testing.assert_allclose(rcv.numpy(), np.asarray(rcv_ref), atol=FC_TOL,
                               rtol=0)
    if pose_source != "real":
        assert floor_margin(rcv, 32, 16) >= FLOOR_MARGIN
        np.testing.assert_array_equal(rcv[..., 2].numpy(),
                                      np.asarray(rcv_ref)[..., 2])
    np.testing.assert_array_equal(maps.numpy(), np.asarray(maps_ref))
    assert (maps.numpy() > 0).any()


@pytest.mark.parametrize("flags", [{}, {"sample_app": True},
                                   {"sample_app": True,
                                    "one_app_per_batch": True}],
                         ids=["encoded", "sample_app", "one_app_per_batch"])
@pytest.mark.parametrize("pose_source", ["real", "reconstructed", "sampled"])
def test_full_sampling_step_matches_jax(jparams, state, tmp_path, monkeypatch,
                                        pose_source, flags):
    jt = _jax_tester(jtesters.FullSamplingTester, monkeypatch, jparams,
                     tmp_path, **flags)
    t = _port_tester(FULL, state, tmp_path, **flags)
    batch, jb = _batch()
    rng = jax.random.PRNGKey(7)
    g_ref, maps_ref, score_ref, rcv_ref = jt.sample_step(jparams, jb, rng,
                                                         pose_source)
    g, maps, score, rcv = t.sample_step(batch_to_device(batch, t.device),
                                        _jax_step_noise(rng), pose_source)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), atol=2e-2, rtol=0)
    np.testing.assert_array_equal(maps.numpy(), np.asarray(maps_ref))
    np.testing.assert_allclose(score.numpy(), np.asarray(score_ref),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(rcv.numpy(), np.asarray(rcv_ref), atol=FC_TOL,
                               rtol=0)


FACTOR_FLAGS = [(fg, bg, pose) for fg in (False, True) for bg in (False, True)
                for pose in (False, True)]


def _factor_flags(fg, bg, pose):
    return dict(sample_fg=fg, sample_bg=bg, sample_pose=pose)


@pytest.mark.parametrize("fg,bg,pose", [(False, False, False),
                                        (True, False, False),
                                        (False, True, True),
                                        (True, True, True)])
def test_factor_sampling_step_matches_jax(jparams, state, tmp_path,
                                          monkeypatch, fg, bg, pose):
    flags = _factor_flags(fg, bg, pose)
    jt = _jax_tester(jtesters.FactorSamplingTester, monkeypatch, jparams,
                     tmp_path, **flags)
    t = _port_tester(testers.FactorSamplingTester, state, tmp_path, **flags)
    batch, jb = _batch(seed=4)
    rng = jax.random.PRNGKey(9)
    g_ref, maps_ref, score_ref = jt.sample_step(jparams, jb, rng)
    g, maps, score = t.sample_step(batch_to_device(batch, t.device),
                                   _jax_step_noise(rng))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), atol=2e-2, rtol=0)
    np.testing.assert_array_equal(maps.numpy(), np.asarray(maps_ref))
    np.testing.assert_allclose(score.numpy(), np.asarray(score_ref),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("fg,bg,pose", FACTOR_FLAGS)
def test_factor_sampling_tiles_the_fixed_factors(state, tmp_path, fg, bg,
                                                 pose):
    """Every factor not sampled is sample 0's across the batch: the
    generator's FG / BG codes are the encoder's of sample 0, and without
    sample_pose every pose map is sample 0's; a sampled factor varies."""
    t = _port_tester(testers.FactorSamplingTester, state, tmp_path,
                     **_factor_flags(fg, bg, pose))
    seen = []
    t.stage1.generator.register_forward_pre_hook(
        lambda m, args: seen.append(args))
    batch = batch_to_device(next(SyntheticLoader(4, 32, 16, seed=6)),
                            t.device)
    t.sample_step(batch, t.draw_noise(torch.Generator().manual_seed(1), 4))
    (embs, pose_nchw), = seen
    with torch.inference_mode():
        real = t._encode_app(batch)
    for sampled, part in ((fg, slice(0, FG_DIM)), (bg, slice(FG_DIM, None))):
        if sampled:
            assert not torch.equal(embs[0, part], embs[1, part])
        else:
            assert torch.equal(embs[:, part], real[:1, part].expand(4, -1))
    same_pose = all(torch.equal(pose_nchw[0], pose_nchw[i]) for i in (1, 2, 3))
    assert same_pose != pose


def test_interpolation_embed_and_decode_match_jax(jparams, state, tmp_path,
                                                  monkeypatch):
    jt = _jax_tester(jtesters.InterpolationTester, monkeypatch, jparams,
                     tmp_path, interpolate_pose=True)
    t = _port_tester(testers.InterpolationTester, state, tmp_path,
                     interpolate_pose=True)
    batch, jb = _batch(seed=5)
    embs_ref, z_ref = jt._embed(jparams, jb)
    embs, z = t._embed(batch_to_device(batch, t.device))
    np.testing.assert_allclose(embs.numpy(), np.asarray(embs_ref), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=FC_TOL,
                               rtol=0)
    g_ref = jt._decode(jparams, embs_ref, z_ref)
    g = t._decode(_t(embs_ref), _t(z_ref))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), atol=2e-2, rtol=0)


@pytest.mark.parametrize("flags", [{"interpolate_pose": True},
                                   {"interpolate_fg": True,
                                    "interpolate_bg": True}],
                         ids=["pose", "fg_bg"])
def test_interpolation_run_writes_the_jax_png(jparams, state, tmp_path,
                                              monkeypatch, flags):
    """run() on the same batch writes interpolation.png as JAX does, within
    one level of 255 (the images agree within 2e-2 before the uint8
    cast)."""
    pngs = []
    for side in ("jax", "port"):
        d = tmp_path / side
        if side == "jax":
            tester = _jax_tester(jtesters.InterpolationTester, monkeypatch,
                                 jparams, d, **flags)
        else:
            tester = _port_tester(testers.InterpolationTester, state, d,
                                  **flags)
        out = tester.run(JaxLoader(4, 32, 16, seed=5), n_steps=4)
        assert out == os.path.join(str(d), "test_result_interpolate")
        pngs.append(np.asarray(Image.open(os.path.join(
            out, "interpolation.png"))).astype(np.int32))
    assert pngs[0].shape == pngs[1].shape
    assert np.abs(pngs[0] - pngs[1]).max() <= 1


# ------------------------------------------------------------- dead work
@pytest.mark.parametrize("cls,flags,encoder_calls,mapper_calls", [
    (FULL, {}, 1, 0),
    (FULL, {"one_app_per_batch": True}, 1, 0),
    (FULL, {"sample_app": True}, 0, 2),
    (FULL, {"sample_app": True, "one_app_per_batch": True}, 0, 2),
    (testers.FactorSamplingTester, {"sample_fg": True}, 1, 1),
    (testers.FactorSamplingTester, {"sample_fg": True, "sample_bg": True},
     0, 2),
], ids=["full", "full-one_app", "full-sample_app", "full-sample_app-one_app",
        "factor-fg", "factor-fg-bg"])
def test_dead_work_is_not_done(state, tmp_path, monkeypatch, cls, flags,
                               encoder_calls, mapper_calls):
    """The ROI encoder runs only when its output is used, the appearance
    mappers only when they are, and the pose AE's radius-0 preview never
    (the pose decoder's rcv is rendered once, at radius 4)."""
    t = _port_tester(cls, state, tmp_path, **flags)
    calls = {"encoder": 0, "mappers": 0}

    def count(key):
        return lambda *_: calls.__setitem__(key, calls[key] + 1)

    t.stage1.encoder.register_forward_hook(count("encoder"))
    for name in ("Gaussian_FC_Fg", "Gaussian_FC_Bg"):
        t.mappers[name].register_forward_hook(count("mappers"))
    renders = []
    plain = pose_ops.render_pose_maps_plain

    def render(rcv, h, w, k, radius, normalized):
        renders.append(radius)
        return plain(rcv, h, w, k, radius, normalized)

    monkeypatch.setattr(pose_ops, "render_pose_maps_plain", render)
    batch = batch_to_device(next(SyntheticLoader(4, 32, 16, seed=2)),
                            t.device)
    noise = t.draw_noise(torch.Generator().manual_seed(0), 4)
    if cls is FULL:
        t.sample_step(batch, noise, "sampled")
    else:
        t.sample_step(batch, noise)
    assert calls == {"encoder": encoder_calls, "mappers": mapper_calls}
    assert renders == [4]


# ----------------------------------------------------------------- run()
def test_full_sampling_run_is_reproducible(tmp_path):
    """Two cold-start run()s draw the same noise from the seed-0 CPU
    generator: the same G names (scores) and decoded rcv dumps."""
    outs = []
    for d in ("a", "b"):
        cfg = Config(platform="cpu", model_dir=str(tmp_path / d),
                     sample_app=True, **SMALL)
        out = FULL(cfg).run(SyntheticLoader(4, 32, 16, seed=1),
                            test_batch_num=2, pose_source="sampled")
        outs.append((sorted(os.listdir(os.path.join(out, "G"))),
                     np.load(os.path.join(out, "G_pose",
                                          "pose_rcv_0001.npy"))))
    assert outs[0][0] == outs[1][0] and len(outs[0][0]) == 8
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert outs[0][1].shape == (4, 18, 3)


def _cli(tmp_path, *flags):
    return port_main.test_model(port_main.get_config([
        "--platform=cpu", "--synthetic_data=true", "--test_batch_num=1",
        "--img_H=32", "--img_W=16", "--batch_size=4", "--conv_hidden_num=16",
        "--z_num=16", f"--model_dir={tmp_path}", *flags]))


TREE_11 = ["G", "G_pose", "mask", "mask_target", "pose", "pose_target", "x",
           "x_target"]


def test_cli_model11_pose_source_wiring(tmp_path):
    """--sample_pose=true decodes the real pose's AE code (tester.py:93-95,
    'reconstructed'); without it the real pose; --pose_source overrides.
    The tree and file names are the JAX package's."""
    for flags, tree in (
            (["--sample_pose=true", "--sample_app=true"],
             "test_result_SampleAppTruePose-reconstructed_1x4"),
            (["--sample_app=true"], "test_result_SampleAppTruePose-real_1x4"),
            (["--pose_source=sampled"],
             "test_result_SampleAppFalsePose-sampled_1x4")):
        out = _cli(tmp_path, "--model=11", *flags)
        assert out == os.path.join(str(tmp_path), tree)
        assert sorted(os.listdir(out)) == TREE_11
        g = sorted(os.listdir(os.path.join(out, "G")))
        assert len(g) == 4 and g[0].startswith("00000_score")
        assert "pose_rcv_0000.npy" in os.listdir(os.path.join(out, "G_pose"))


def test_cli_model13(tmp_path):
    out = _cli(tmp_path, "--model=13", "--sample_fg=true")
    assert out.endswith("test_result_ROI7_SampleFgTrueSampleBgFalse"
                        "SamplePoseFalse_pretrain_1x4")
    assert {d: len(os.listdir(os.path.join(out, d))) for d in os.listdir(out)
            } == {"x": 4, "G": 4, "pose": 4}


def test_cli_interpolation_for_any_test_model(tmp_path):
    out = _cli(tmp_path, "--model=12", "--interpolate_bg=true")
    assert os.listdir(out) == ["interpolation.png"]


# The id is the one this case had when the refusals named their ROADMAP
# item by number. --test_one_by_one and --inverse_* run now
# (tests/test_torch_demo.py, tests/test_torch_inversion.py).
@pytest.mark.parametrize("flags,match", [
    (["--model=13", "--pretrained_poseAE_path={orbax}"],
     "orbax checkpoint.*scripts/orbax_to_torch.py")],
    ids=["flags3-queue item 5"])
def test_cli_unported_options_raise(tmp_path, flags, match):
    """`{orbax}`: a JAX orbax checkpoint (its metadata file), which the
    port reads only once `scripts/orbax_to_torch.py` has imported it."""
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match=match):
        _cli(tmp_path, *(f.format(orbax=orbax) for f in flags))


def test_sample_mapper_noise_is_device_independent():
    a = sample_mapper_noise(torch.Generator().manual_seed(0), 3, 5,
                            torch.device("cpu"))
    b = torch.randn((3, 5), generator=torch.Generator().manual_seed(0)) * 0.2
    assert torch.equal(a, b)
