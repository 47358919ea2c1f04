"""The DeepFashion 256x256 family's Stage II and its chain in the port
against the JAX package on the CPU: one model-103 step (the single
appearance mapper `Gaussian_FC` against the frozen single-branch encoder,
critic `FCDis`) in both batch forms, one model-102 (pose AE) and one
model-104 (pose sampler) step at 256x256, the 103 / 104 previews, JAX
orbax checkpoints of models 101 and 103 through `scripts/orbax_to_torch.py`,
and the CLI chain 101 -> 102 -> 103 -> 104 -> 1001 / 1002.

256x256 at narrow widths (hidden 4, z 4, batch 2) as in
tests/test_torch_df256.py. The Stage-II references are JAX's own step
bodies run eagerly on JAX's own noise, recorded and synced as
tests/test_torch_stage2.py does, with its limits: losses 1e-5 relative,
the FC nets' gradients 1e-4 of each tensor's largest, each side's updated
params within 2 sqrt(10) lr + 1e-6 and at most 0.1% more than lr / 100
apart, critics clipped to +-0.01; the pose AE's updated params 2 lr +
1e-6; previews on [0,255] within 2e-2.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpig_tpu.apps.stage1_app import Stage1App as JaxStage1App
from dpig_tpu.apps.stage1_pose import Stage1PoseApp as JaxPoseApp
from dpig_tpu.apps.stage2_app_single import Stage2AppSingleApp as JaxSingle
from dpig_tpu.apps.stage2_pose import Stage2PoseApp as JaxPoseSampler
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.data.synthetic import SyntheticLoader as JaxLoader
from dpig_tpu.models.mappers import sample_mapper_noise as jax_noise
from dpig_tpu.train import checkpoint as jckpt
from dpig_tpu_torch import main as port_main
from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.apps.stage1_pose import Stage1PoseApp
from dpig_tpu_torch.apps.stage2_app_single import Stage2AppSingleApp
from dpig_tpu_torch.apps.stage2_pose import Stage2PoseApp
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.train import checkpoint as ckpt
from dpig_tpu_torch.train.parity import recorded_train_step
from scripts.orbax_to_torch import import_checkpoint
from test_torch_stage2 import (C, POSE_NETS, _assert_tree_equal,
                               _check_step, _flat, _frozen_copy, _jax_step,
                               _np, _t)

torch.set_num_threads(1)

NARROW = dict(img_H=256, img_W=256, batch_size=2, conv_hidden_num=4,
              z_num=4)
CPU = torch.device("cpu")
LR = Config().g_lr
APP, POSE_Z = 7 * 32, 32
SINGLE_NETS = ("Gaussian_FC", "FCDis")


def _cfg(**kw):
    return Config(platform="cpu", **NARROW, **kw)


def _host_batches(seed, n):
    loader = JaxLoader(2, 256, 256, seed=seed)
    return tuple(next(loader) for _ in range(n))


def _noise(rng, dim, b=2):
    """The noise JAX's Stage-II step draws: split(rng, 1 + C), one draw of
    `dim` each (stage2_app_single.py:101,108,114)."""
    rngs = jax.random.split(rng, 1 + C)
    return _t(np.stack([np.asarray(jax_noise(r, b, dim)) for r in rngs]))


@pytest.fixture(scope="module")
def jax_stage1():
    """The JAX package's model-101 cold start at 256 narrow."""
    return JaxStage1App(JaxConfig(**NARROW), fg_bg=False).init_state(
        jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def jax_model103(jax_stage1):
    japp = JaxSingle(JaxConfig(**NARROW))
    st = japp.init_state(jax.random.PRNGKey(1),
                         frozen_params=jax_stage1.g_params)
    return japp, st, _np({"g": st.g_params, "d": st.d_params,
                          "f": st.frozen_params})


@pytest.fixture(scope="module")
def jax_model104(jax_stage1):
    cfg = JaxConfig(**NARROW)
    frozen = dict(JaxPoseApp(cfg).init_state(jax.random.PRNGKey(2)).g_params)
    frozen.update(jax_stage1.g_params)
    japp = JaxPoseSampler(cfg)
    st = japp.init_state(jax.random.PRNGKey(3), frozen_params=frozen)
    return japp, st, _np({"g": st.g_params, "d": st.d_params,
                          "f": st.frozen_params})


def _port_app(cls, init, nets, frozen_names, **kw):
    app = cls(_cfg(**kw), CPU, params_from_flax(init["f"], frozen_names))
    state = params_from_flax({**init["g"], **init["d"]}, nets)
    for name, net in {**app.mappers, **app.critics}.items():
        net.load_state_dict(state[name], strict=True)
    return app


# ---------------------------------------------------------------- model 103
@pytest.mark.parametrize("mode", ["fresh", "reused"])
def test_model103_step_matches_jax(jax_model103, monkeypatch, mode):
    """`Gaussian_FC` against `FCDis` on the frozen encoder's 224-d codes:
    the two losses, the mapper's and the last critic iteration's
    gradients, each update, the clip; the frozen nets untouched; under
    `fresh` 1 + 5 batches, the encoder run on each."""
    japp, st, init = jax_model103
    host = _host_batches(6, 1 + C if mode == "fresh" else 1)
    jbs = [{k: jnp.asarray(v) for k, v in b.items()} for b in host]
    rng = jax.random.PRNGKey(8)
    ref, calls, clipped, new = _jax_step(
        japp, jax.tree_util.tree_map(jnp.array, st), jbs, rng,
        japp.real_embs, monkeypatch)
    app = _port_app(Stage2AppSingleApp, init, SINGLE_NETS,
                    ("Encoder", "ID_AE"), critic_batch_mode=mode)
    assert not app.stage1.fg_bg and app.stage1.disc is None
    assert app.batches_per_step == len(host)
    encoder_calls = []
    app.stage1.encoder.register_forward_hook(
        lambda *_: encoder_calls.append(1))
    before = _frozen_copy(app)
    rec = recorded_train_step(
        app, host if mode == "fresh" else host[0], noise=_noise(rng, APP),
        g_updated=_flat(new.g_params, SINGLE_NETS[:1]),
        d_clipped=[_flat(c, SINGLE_NETS[1:]) for c in clipped])
    assert set(rec.metrics) == {"g_loss_embs", "d_loss_embs"}
    assert len(encoder_calls) == len(host)
    _check_step(rec, ref, calls, clipped, new, SINGLE_NETS, before, app,
                1e-4)


# ---------------------------------------------------------- models 102, 104
def test_pose_ae_step_at_256_matches_jax():
    """Model 102: the pose AE normalizes and renders by cfg.img_H / img_W,
    so at 256 it is model 2's code on 256x256 coordinates: the losses
    within 1e-5, the updated params within 2 lr + 1e-6, at most 0.1% more
    than lr / 100 apart."""
    japp = JaxPoseApp(JaxConfig(**NARROW))
    st = japp.init_state(jax.random.PRNGKey(4))
    init = _np(st.g_params)
    batch = _host_batches(5, 1)[0]
    assert batch["pose_rcv"][..., :2].max() > 128  # 256x256 coordinates
    new, metrics = japp.train_step(st, {k: jnp.asarray(v) for k, v in
                                        batch.items()}, jax.random.PRNGKey(0))
    app = Stage1PoseApp(_cfg(), CPU, params_from_flax(init, ("PoseAE",)))
    state = app.init_state()
    out = app.train_step(state, batch_to_device(batch, CPU))
    for k in ("reconstruct_loss", "loss"):
        np.testing.assert_allclose(float(out[k]), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    ref = params_from_flax(_np(new.g_params), ("PoseAE",))["PoseAE"]
    got = app.nets.state_dict()
    diffs = torch.cat([(got[k] - v).abs().reshape(-1) for k, v in ref.items()])
    assert float(diffs.max()) <= 2 * LR + 1e-6
    assert float((diffs > LR / 100).float().mean()) <= 1e-3


def test_model104_step_matches_jax(jax_model104, monkeypatch):
    """Model 104 (`fresh`): the pose sampler with the single-branch Stage-I
    nets frozen beside the pose AE."""
    japp, st, init = jax_model104
    host = _host_batches(7, 1 + C)
    jbs = [{k: jnp.asarray(v) for k, v in b.items()} for b in host]
    rng = jax.random.PRNGKey(9)
    ref, calls, clipped, new = _jax_step(
        japp, jax.tree_util.tree_map(jnp.array, st), jbs, rng,
        japp.real_pose_embs, monkeypatch)
    app = _port_app(Stage2PoseApp, init, POSE_NETS,
                    ("PoseAE", "Encoder", "ID_AE"))
    assert not app.stage1.fg_bg and app.stage1.gen_repeat == 5
    before = _frozen_copy(app)
    rec = recorded_train_step(
        app, host, noise=_noise(rng, POSE_Z),
        g_updated=_flat(new.g_params, POSE_NETS[:1]),
        d_clipped=[_flat(c, POSE_NETS[1:]) for c in clipped])
    _check_step(rec, ref, calls, clipped, new, POSE_NETS, before, app, 1e-5)


@pytest.mark.parametrize("model", [103, 104])
def test_previews_at_256_match_jax(jax_model103, jax_model104, model):
    """Model 103's sampled codes and model 104's sampled poses through the
    frozen 256 generator, on the same noise: [0,255] within 2e-2."""
    host = _host_batches(2, 1)[0]
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    rng = jax.random.PRNGKey(4)
    if model == 103:
        (japp, st, init), cls = jax_model103, Stage2AppSingleApp
        nets, frozen, dim = SINGLE_NETS, ("Encoder", "ID_AE"), APP
    else:
        (japp, st, init), cls = jax_model104, Stage2PoseApp
        nets, frozen, dim = POSE_NETS, ("PoseAE", "Encoder", "ID_AE"), POSE_Z
    ref = np.asarray(japp.preview_step(st, jb, rng))
    app = _port_app(cls, init, nets, frozen)
    got = app.preview_step(batch_to_device(host, CPU),
                           _t(jax_noise(rng, 2, dim)))
    assert got.shape == (2, 256, 256, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2, rtol=0)


# -------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("model", [101, 103])
def test_jax_checkpoints_import_unchanged(jax_stage1, jax_model103,
                                          tmp_path, model):
    """A JAX orbax checkpoint of model 101 (`RoiEncoder`, the 5-stage D,
    Adam) or 103 (`Gaussian_FC`, `FCDis`, RMSProp, frozen nets) through
    `scripts/orbax_to_torch.py` as it is: every tensor the bridge's map of
    JAX's, and the port's app of that model resumes it strictly."""
    st = jax_stage1 if model == 101 else jax_model103[1]
    jckpt.save_checkpoint(str(tmp_path / "jax"), 3, st)
    port_dir = import_checkpoint(str(tmp_path / "jax"), str(tmp_path / "p"))
    tree = ckpt.load_tree(port_dir)
    want = params_from_flax(_np(st.g_params), list(st.g_params))
    _assert_tree_equal(tree["g_params"], want)
    if model == 101:
        from dpig_tpu_torch.apps.stage1_app import Stage1App
        app = Stage1App(_cfg(), CPU, fg_bg=False)
        assert set(tree["g_params"]["Encoder"]) == set(
            app.encoder.state_dict())
    else:
        app = Stage2AppSingleApp(_cfg(), CPU)
        _assert_tree_equal(tree["frozen_params"], params_from_flax(
            _np(st.frozen_params), ["Encoder", "ID_AE"]))
    state = ckpt.restore_into_state(port_dir, app.init_state())
    assert state.step == tree["step"] == int(st.step)
    for name, net in state.g_nets.items():
        _assert_tree_equal(dict(net.named_parameters()),
                           tree["g_params"][name])


# ---------------------------------------------------------------- the chain
TINY = ["--platform=cpu", "--synthetic_data=true", "--img_H=256",
        "--img_W=256", "--batch_size=2", "--conv_hidden_num=4",
        "--z_num=4"]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Models 101 -> 102 -> 103 -> 104 through the CLI, 2 steps each, each
    on the port checkpoints of the stages before it -> {model: dir}."""
    root = tmp_path_factory.mktemp("df_chain")
    dirs = {m: str(root / f"s{m}") for m in (101, 102, 103, 104)}
    pre = {103: [f"--pretrained_path={dirs[101]}"],
           104: [f"--pretrained_path={dirs[101]}",
                 f"--pretrained_poseAE_path={dirs[102]}"]}
    for m, d in dirs.items():
        port_main.main([f"--model={m}", "--max_step=2", "--log_step=1",
                        f"--model_dir={d}", *TINY, *pre.get(m, [])])
    return dirs


def test_cli_trains_models_101_to_104_and_resumes(chain):
    for m in (101, 102, 103, 104):
        d = chain[m]
        with open(os.path.join(d, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        assert [r["step"] for r in recs] == [0, 1], m
        assert all(np.isfinite(v) for r in recs for v in r.values()), m
        previews = sorted(f for f in os.listdir(d) if "_G_ssim" in f)
        assert len(previews) == (0 if m == 102 else 1), m
        assert ckpt.latest_checkpoint(d).endswith("step_00000002"), m
    s1 = ckpt.load_tree(chain[101])
    assert set(s1["g_params"]["Encoder"]) == set(params_from_flax(
        {"E": JaxSingle(JaxConfig(**NARROW)).stage1.encoder.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)),
            jnp.zeros((1, 7, 4), jnp.int32), jnp.ones((1, 7)))["params"]},
        ["E"])["E"])
    s3 = ckpt.load_tree(chain[103])
    assert set(s3["g_params"]) == {"Gaussian_FC"}
    assert set(s3["d_params"]) == {"FCDis"}
    _assert_tree_equal(s3["frozen_params"], {k: s1["g_params"][k]
                                             for k in ("Encoder", "ID_AE")})
    assert float(max(t.abs().max() for t in
                     s3["d_params"]["FCDis"].values())) <= 0.01
    s4 = ckpt.load_tree(chain[104])
    _assert_tree_equal(s4["frozen_params"]["PoseAE"],
                       ckpt.load_tree(chain[102])["g_params"]["PoseAE"])
    port_main.main(["--model=103", "--max_step=3", "--log_step=1",
                    f"--model_dir={chain[103]}", *TINY])
    assert ckpt.load_tree(chain[103])["step"] == 3


@pytest.mark.parametrize("model,flags,trees", [
    (1001, [], {"x": 4, "x_target": 4, "G": 4, "pose": 4, "pose_target": 4,
                "mask": 4, "mask_target": 4}),
    (1002, ["--sample_fg=true"], {"x": 4, "G": 4, "pose": 4}),
    (1002, ["--sample_fg=true", "--inference_dtype=int8"],
     {"x": 4, "G": 4, "pose": 4})],
    ids=["1001", "1002-sample_fg", "1002-int8"])
def test_cli_testers_on_the_chain(chain, capsys, tmp_path, model, flags,
                                  trees):
    """Models 1001 and 1002 with all four --pretrained_* flags on the
    chain: no RANDOM-init line, the tree written (2 batches of 2), and
    the trained `Gaussian_FC` read through compose_pretrained's fallback
    (as the JAX package's); int8 prints its self-check."""
    capsys.readouterr()
    out = port_main.test_model(port_main.get_config([
        f"--model={model}", "--is_train=false", "--test_batch_num=2",
        f"--model_dir={tmp_path}", *TINY, *flags,
        f"--pretrained_path={chain[101]}",
        f"--pretrained_poseAE_path={chain[102]}",
        f"--pretrained_appSample_path={chain[103]}",
        f"--pretrained_poseSample_path={chain[104]}"]))
    text = capsys.readouterr().out
    assert "RANDOM" not in text
    assert ("int8 self-check" in text) == ("--inference_dtype=int8" in flags)
    assert {d: len(os.listdir(os.path.join(out, d)))
            for d in os.listdir(out)} == trees
    cfg = _cfg(pretrained_appSample_path=chain[103])
    merged = ckpt.compose_pretrained(cfg)
    _assert_tree_equal(merged["Gaussian_FC"], ckpt.load_tree(
        chain[103])["g_params"]["Gaussian_FC"])
