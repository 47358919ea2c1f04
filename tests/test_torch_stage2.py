"""Stage-II training in the port against the JAX package at a tiny config:
the FC critic; one model-2 (pose AE) step; one model-3 (appearance
samplers) and one model-4 (pose sampler) step in both batch forms; the
batches the harness feeds; checkpoints with frozen nets and without a D;
`restore_subtrees` / `compose_pretrained` on port checkpoints; the CLI
chain 1 -> 2 -> 3 -> 4 -> 11.

The Stage-II references are JAX's own step bodies (`_step_impl`) run
eagerly on JAX's own noise (the same `split` / `sample_mapper_noise`
calls, handed to the port as tensors), recording each `value_and_grad`
and each clip. The port's step is recorded with its G parameters set to
JAX's after the G update and its critics to JAX's after each clip
(`train.parity.recorded_train_step`), so that RMSProp's sign-like first
step (lr * g / sqrt(0.1 g^2 + 1e-10) ~ +-sqrt(10) lr) on a near-zero
gradient does not carry one side's rounding into the next phase.

Tolerances: losses 1e-5 relative (float32 sums in other orders); the FC
nets' gradients 1e-4 of each tensor's largest (measured at most 2e-6);
mapper and critic outputs 1e-5 absolute, the frozen encoder's embeddings
1e-4 (tests/test_torch_sampling.py); each side's own updated parameters
within 2 sqrt(10) lr + 1e-6 (a flipped sign on RMSProp's first step), and
at most 0.1% of them more than lr / 100 apart; clipped critics in
[-0.01, 0.01] exactly.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpig_tpu.apps import common as jcommon
from dpig_tpu.apps.stage1_pose import Stage1PoseApp as JaxPoseApp
from dpig_tpu.apps.stage2_app import Stage2AppApp as JaxAppApp
from dpig_tpu.apps.stage2_pose import Stage2PoseApp as JaxPoseSampler
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.data.synthetic import SyntheticLoader as JaxLoader
from dpig_tpu.losses import gan as jgan
from dpig_tpu.models.discriminators import FCDiscriminator as JaxFCDis
from dpig_tpu.models.mappers import sample_mapper_noise as jax_noise
from dpig_tpu_torch import main as port_main
from dpig_tpu_torch.apps import testers
from dpig_tpu_torch.apps.common import batch_to_device, critic_batches_per_step
from dpig_tpu_torch.apps.stage1_pose import Stage1PoseApp
from dpig_tpu_torch.apps.stage2_app import Stage2AppApp
from dpig_tpu_torch.apps.stage2_pose import Stage2PoseApp
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.data.synthetic import SyntheticLoader
from dpig_tpu_torch.models.discriminators import FCDiscriminator
from dpig_tpu_torch.train import checkpoint as ckpt
from dpig_tpu_torch.train.harness import Trainer
from dpig_tpu_torch.train.parity import recorded_train_step

torch.set_num_threads(1)

SMALL = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16)
CPU = torch.device("cpu")
LR = Config().g_lr  # 8e-5, mappers and critics
RMS_FLIP = 2 * np.sqrt(10) * LR + 1e-6
C = jgan.CRITIC_ITERS
FG, BG, POSE_Z = 7 * 32, 4 * 32, 32
APP_NETS = ("Gaussian_FC_Fg", "Gaussian_FC_Bg", "Fg_FCDis", "Bg_FCDis")
POSE_NETS = ("PoseGaussian", "Pose_emb_FCDis")


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, names):
    """flax sub-trees -> the port's 'name/param' keys (optimizer params)."""
    state = params_from_flax(tree, names)
    return {f"{k}/{n}": v for k in names for n, v in state[k].items()}


def _cfg(tmp_path=None, **kw):
    return Config(platform="cpu", model_dir=str(tmp_path) if tmp_path else
                  None, **SMALL, **kw)


def _host_batches(seed, n):
    loader = JaxLoader(4, 32, 16, seed=seed)
    return tuple(next(loader) for _ in range(n))


# --------------------------------------------------------------- the nets
def test_fc_discriminator_matches_flax():
    x = np.random.default_rng(1).normal(size=(5, FG)).astype(np.float32)
    jnet = JaxFCDis(fc_dim=512, n_layers=3)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + np.float32(0.01), params)  # nonzero biases
    assert sorted(params) == ["h0", "h1", "h2", "input", "out"]
    net = FCDiscriminator(FG)
    net.load_state_dict(params_from_flax({"D": params}, ("D",))["D"],
                        strict=True)
    with torch.no_grad():
        out = net(_t(x))
    assert out.shape == (5,)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jnet.apply({"params": params}, x)),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode,n", [("fresh", 1 + C), ("reused", 1),
                                    ("stale", None)])
def test_critic_batches_per_step(mode, n):
    cfg, jcfg = _cfg(critic_batch_mode=mode), JaxConfig(critic_batch_mode=mode)
    if n is None:
        for fn, c in ((critic_batches_per_step, cfg),
                      (jcommon.critic_batches_per_step, jcfg)):
            with pytest.raises(ValueError, match="critic_batch_mode"):
                fn(c)
        with pytest.raises(ValueError, match="critic_batch_mode"):
            Stage2PoseApp(cfg, CPU)
    else:
        assert critic_batches_per_step(cfg) == n == \
            jcommon.critic_batches_per_step(jcfg)


# ---------------------------------------------------------------- model 2
def test_pose_ae_train_step_matches_jax():
    """One Adam step of the pose AE: the loss, and the updated params
    within 2 lr + 1e-6 (Adam's first step is sign-like), at most 0.1% of
    them more than lr / 100 apart."""
    japp = JaxPoseApp(JaxConfig(**SMALL))
    st = japp.init_state(jax.random.PRNGKey(4))
    init = _np(st.g_params)
    batch = next(JaxLoader(4, 32, 16, seed=5))
    new, metrics = japp.train_step(st, {k: jnp.asarray(v) for k, v in
                                        batch.items()}, jax.random.PRNGKey(0))
    app = Stage1PoseApp(_cfg(), CPU, params_from_flax(init, ("PoseAE",)))
    state = app.init_state()
    out = app.train_step(state, batch_to_device(batch, CPU))
    assert state.step == int(new.step) == 1 and state.d_opt is None
    for k in ("reconstruct_loss", "loss"):
        np.testing.assert_allclose(float(out[k]), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    ref = params_from_flax(_np(new.g_params), ("PoseAE",))["PoseAE"]
    got = app.nets.state_dict()
    diffs = torch.cat([(got[k] - v).abs().reshape(-1) for k, v in ref.items()])
    assert float(diffs.max()) <= 2 * LR + 1e-6
    assert float((diffs > LR / 100).float().mean()) <= 1e-3


# ------------------------------------------------------------ models 3, 4
@pytest.fixture(scope="module")
def jax_model3():
    """The JAX appearance samplers' cold start (Stage-I nets included),
    as numpy."""
    japp = JaxAppApp(JaxConfig(**SMALL))
    st = japp.init_state(jax.random.PRNGKey(1))
    return japp, st, _np({"g": st.g_params, "d": st.d_params,
                          "f": st.frozen_params})


@pytest.fixture(scope="module")
def jax_model4(jax_model3):
    """The JAX pose sampler's start, with model 3's Stage-I nets."""
    frozen = dict(JaxPoseApp(JaxConfig(**SMALL)).init_state(
        jax.random.PRNGKey(2)).g_params)
    frozen.update({k: jax_model3[1].frozen_params[k]
                   for k in ("Encoder", "ID_AE")})
    japp = JaxPoseSampler(JaxConfig(**SMALL))
    st = japp.init_state(jax.random.PRNGKey(3), frozen_params=frozen)
    return japp, st, _np({"g": st.g_params, "d": st.d_params,
                          "f": st.frozen_params})


def _jax_step(japp, state, batches, rng, real_fn, monkeypatch):
    """JAX's step body, eagerly, on JAX-device batches -> (metrics, each
    value_and_grad's (value, grads), the D params after each clip, the
    final state)."""
    calls, clipped = [], []
    vag, clip = jax.value_and_grad, jgan.clip_params

    def recording_vag(fn, **kw):
        def run(*args):
            out = vag(fn, **kw)(*args)
            calls.append(_np(out))
            return out
        return run

    def recording_clip(params):
        out = clip(params)
        clipped.append(_np(out))
        return out

    with monkeypatch.context() as m:
        m.setattr(jax, "value_and_grad", recording_vag)
        m.setattr(jgan, "clip_params", recording_clip)
        reals = ([real_fn(state.frozen_params, b) for b in batches[1:]]
                 if len(batches) > 1 else None)
        new, metrics = japp._step_impl(state, batches[0], rng, reals)
    return _np(metrics), calls, clipped, new


def _app_noise(rng, b=4):
    """The noise JAX's model-3 step draws (stage2_app.py:101-107,145,163),
    as the port's [1+C, b, FG+BG] step noise."""
    rngs = jax.random.split(rng, 2 + 2 * C)
    draws = []
    for r in [rngs[0]] + [rngs[2 + i] for i in range(C)]:
        rf, rb = jax.random.split(r)
        draws.append(np.concatenate([np.asarray(jax_noise(rf, b, FG)),
                                     np.asarray(jax_noise(rb, b, BG))], -1))
    return _t(np.stack(draws))


def _pose_noise(rng, b=4):
    """The noise JAX's model-4 step draws (stage2_pose.py:116,124,130)."""
    rngs = jax.random.split(rng, 1 + C)
    return _t(np.stack([np.asarray(jax_noise(r, b, POSE_Z)) for r in rngs]))


def _port_app(cls, init, nets, frozen_names):
    app = cls(_cfg(), CPU, params_from_flax(init["f"], frozen_names))
    state = params_from_flax({**init["g"], **init["d"]}, nets)
    for name, net in {**app.mappers, **app.critics}.items():
        net.load_state_dict(state[name], strict=True)
    return app


def _frozen_copy(app):
    return {k: {n: t.clone() for n, t in m.state_dict().items()}
            for k, m in app.frozen.items()}


def _check_step(rec, ref, calls, clipped, new, nets, frozen_before, app,
                embs_tol):
    g_names, d_names = nets[:len(nets) // 2], nets[len(nets) // 2:]
    # losses (the D losses of the last iteration, from synced critics)
    for k, v in rec.metrics.items():
        np.testing.assert_allclose(v, float(ref[k]), rtol=1e-5, err_msg=k)
    # G gradients (the one G call) and the last critic iteration's
    for names, (_, grads) in ((g_names, calls[0]), (d_names, calls[-1])):
        want = _flat(grads, names)
        for n, g in want.items():
            scale = float(g.abs().max())
            assert float((rec.grads[n] - g).abs().max()) <= 1e-4 * scale, n
    # hists: batch 0's real embeddings, the last iteration's fakes
    for k, v in rec.arrays.items():
        tol = embs_tol if "real" in k else 1e-5
        np.testing.assert_allclose(v.numpy(), ref[k], atol=tol, rtol=0,
                                   err_msg=k)
    # each side's own updates, against JAX's
    updates = [(rec.g_updated, _flat(new.g_params, g_names))]
    updates += [(got, _flat(want, d_names))
                for got, want in zip(rec.d_clipped, clipped)]
    assert len(rec.d_clipped) == len(clipped) == C
    for got, want in updates:
        diffs = torch.cat([(got[n] - v).abs().reshape(-1)
                           for n, v in want.items()])
        assert float(diffs.max()) <= RMS_FLIP
        assert float((diffs > LR / 100).float().mean()) <= 1e-3
    for got, want in updates[1:]:  # clipped, and at the bound as JAX is
        w = torch.cat([got[n].reshape(-1) for n in want])
        v = torch.cat([t.reshape(-1) for t in want.values()])
        assert bool(w.abs().max() == 0.01)
        assert float(((w.abs() == 0.01) != (v.abs() == 0.01)).float()
                     .mean()) <= 1e-3
    for p in rec.state.d_params:
        assert float(p.detach().abs().max()) <= 0.01
    # the frozen nets: untouched, no gradient, in no optimizer
    for k, m in app.frozen.items():
        for n, t in m.state_dict().items():
            assert torch.equal(t, frozen_before[k][n]), (k, n)
        assert not any(p.requires_grad for p in m.parameters())
    trained = {id(p) for p in (*rec.state.g_params, *rec.state.d_params)}
    assert not trained & {id(p) for m in app.frozen.values()
                          for p in m.parameters()}
    assert rec.state.step == int(new.step) == 1


@pytest.mark.parametrize("mode", ["fresh", "reused"])
def test_appearance_sampler_step_matches_jax(jax_model3, monkeypatch, mode):
    japp, st, init = jax_model3
    host = _host_batches(6, 1 + C if mode == "fresh" else 1)
    jbs = [{k: jnp.asarray(v) for k, v in b.items()} for b in host]
    rng = jax.random.PRNGKey(8)
    ref, calls, clipped, new = _jax_step(
        japp, jax.tree_util.tree_map(jnp.array, st), jbs, rng,
        japp.real_embs, monkeypatch)
    app = _port_app(Stage2AppApp, init, APP_NETS, ("Encoder", "ID_AE"))
    before = _frozen_copy(app)
    rec = recorded_train_step(
        app, host if mode == "fresh" else host[0], noise=_app_noise(rng),
        g_updated=_flat(new.g_params, APP_NETS[:2]),
        d_clipped=[_flat(c, APP_NETS[2:]) for c in clipped])
    assert set(rec.metrics) == {"g_loss_embs_fg", "g_loss_embs_bg",
                                "d_loss_embs_fg", "d_loss_embs_bg"}
    assert rec.arrays["hist/embs_real_fg"].shape == (4, FG)
    assert rec.arrays["hist/embs_fake_bg"].shape == (4, BG)
    _check_step(rec, ref, calls, clipped, new, APP_NETS, before, app, 1e-4)


@pytest.mark.parametrize("mode", ["fresh", "reused"])
def test_pose_sampler_step_matches_jax(jax_model4, monkeypatch, mode):
    """As model 3; and JAX's `hist/embs_fake`, a seventh mapper run on
    rngs[-1], equals the port's last critic iteration's fakes, which the
    port reuses: its mapper runs 1 + CRITIC_ITERS times a step."""
    japp, st, init = jax_model4
    host = _host_batches(7, 1 + C if mode == "fresh" else 1)
    jbs = [{k: jnp.asarray(v) for k, v in b.items()} for b in host]
    rng = jax.random.PRNGKey(9)
    ref, calls, clipped, new = _jax_step(
        japp, jax.tree_util.tree_map(jnp.array, st), jbs, rng,
        japp.real_pose_embs, monkeypatch)
    app = _port_app(Stage2PoseApp, init, POSE_NETS,
                    ("PoseAE", "Encoder", "ID_AE"))
    before = _frozen_copy(app)
    runs = []
    app.mappers["PoseGaussian"].register_forward_hook(
        lambda m, args, out: runs.append(out.detach().clone()))
    rec = recorded_train_step(
        app, host if mode == "fresh" else host[0], noise=_pose_noise(rng),
        g_updated=_flat(new.g_params, POSE_NETS[:1]),
        d_clipped=[_flat(c, POSE_NETS[1:]) for c in clipped])
    assert set(rec.metrics) == {"g_loss_embs", "d_loss_embs"}
    assert len(runs) == 1 + C
    assert torch.equal(rec.arrays["hist/embs_fake"], runs[-1])
    _check_step(rec, ref, calls, clipped, new, POSE_NETS, before, app, 1e-5)


def test_previews_match_jax(jax_model3, jax_model4):
    """Model 3's fix-FG / vary-BG composition and model 4's sampled poses
    through the frozen nets, on the same noise, an odd batch (the halves
    differ): [0,255] within 2e-2 (the 1e-4 g_raw bound times 127.5, as
    tests/test_torch_transfer.py)."""
    host = next(JaxLoader(5, 32, 16, seed=2))
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    rng = jax.random.PRNGKey(4)
    rf, rb = jax.random.split(rng)
    noise = {3: np.concatenate([np.asarray(jax_noise(rf, 5, FG)),
                                np.asarray(jax_noise(rb, 5, BG))], -1),
             4: np.asarray(jax_noise(rng, 5, POSE_Z))}
    for model, (japp, st, init), cls, nets, frozen in (
            (3, jax_model3, Stage2AppApp, APP_NETS, ("Encoder", "ID_AE")),
            (4, jax_model4, Stage2PoseApp, POSE_NETS,
             ("PoseAE", "Encoder", "ID_AE"))):
        ref = np.asarray(japp.preview_step(st, jb, rng))
        app = _port_app(cls, init, nets, frozen)
        got = app.preview_step(batch_to_device(host, CPU), _t(noise[model]))
        assert got.shape == (5, 32, 16, 3)
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-2, rtol=0,
                                   err_msg=f"model {model}")


# ---------------------------------------------------------------- harness
def test_trainer_feeds_fresh_batches_and_one_noise_tensor(tmp_path):
    """Under `fresh` each step gets 1+CRITIC_ITERS distinct loader batches
    in loader order, and the step's noise as one [1+C, b, dim] tensor from
    the Trainer's generator; `reused` gets one batch."""
    for mode, n in (("fresh", 1 + C), ("reused", 1)):
        cfg = _cfg(tmp_path / mode, max_step=2, log_step=1,
                   critic_batch_mode=mode)
        app = Stage2PoseApp(cfg, CPU)
        seen = []
        step = app.train_step
        app.train_step = lambda state, batch, noise: (
            seen.append((batch, noise)), step(state, batch, noise))[1]
        Trainer(cfg, app, SyntheticLoader(4, 32, 16, seed=3)).train()
        ref = SyntheticLoader(4, 32, 16, seed=3)
        next(ref)  # the fixed preview batch
        gen = torch.Generator().manual_seed(cfg.random_seed)
        for batch, noise in seen:
            batches = batch if n > 1 else (batch,)
            assert isinstance(batch, tuple) == (n > 1) and len(batches) == n
            for b in batches:
                assert torch.equal(b["x"], torch.from_numpy(next(ref)["x"]))
            assert torch.equal(noise, torch.randn(
                ((1 + C) * 4, POSE_Z), generator=gen).mul(0.2).view(
                    1 + C, 4, POSE_Z))


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("model", [2, 4])
def test_checkpoint_round_trip_and_resume(tmp_path, model):
    """A state with frozen nets (model 4) or without a D (model 2): the
    tree leaves out what the state lacks, and a fresh app (other seed)
    resumes it bit for bit, frozen nets included."""
    def make(seed):
        cfg = _cfg(tmp_path, max_step=1, log_step=1, random_seed=seed,
                   critic_batch_mode="reused")
        return (Stage1PoseApp(cfg, CPU) if model == 2
                else Stage2PoseApp(cfg, CPU)), cfg

    app, cfg = make(123)
    saved = ckpt.state_tree(Trainer(cfg, app, SyntheticLoader(
        4, 32, 16, seed=2)).train())
    keys = {"step", "g_params", "g_opt_state"}
    if model == 4:
        keys |= {"d_params", "d_opt_state", "d_stats", "frozen_params"}
        assert set(saved["frozen_params"]) == {"PoseAE", "Encoder", "ID_AE"}
    assert set(saved) == keys and saved["step"] == 1
    other, cfg = make(7)
    resumed = ckpt.state_tree(Trainer(cfg, other, SyntheticLoader(
        4, 32, 16)).init_state())
    _assert_tree_equal(resumed, saved)


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), path
    else:
        assert got == want, path


def test_an_orbax_checkpoint_raises_naming_item_5(tmp_path):
    step = tmp_path / "ckpt" / "step_00000010"
    step.mkdir(parents=True)
    (step / "_CHECKPOINT_METADATA").write_text("{}")
    for path in (tmp_path, step):
        with pytest.raises(NotImplementedError, match="queue item 5"):
            ckpt.restore_subtrees(str(path), ["Encoder"])
    with pytest.raises(NotImplementedError, match="queue item 5"):
        port_main.train_model(_cfg(tmp_path / "m3", model=3,
                                   synthetic_data=True,
                                   pretrained_path=str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_subtrees(str(tmp_path / "ckpt"), ["Encoder"])


# -------------------------------------------------------------- the chain
TINY = ["--platform=cpu", "--synthetic_data=true", "--img_H=32",
        "--img_W=16", "--batch_size=4", "--conv_hidden_num=16", "--z_num=16"]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Models 1 -> 2 -> 3 -> 4 through the CLI, 2 steps each, each on the
    port checkpoints of the stages before it -> {model: model_dir}."""
    root = tmp_path_factory.mktemp("chain")
    dirs = {m: str(root / f"s{m}") for m in (1, 2, 3, 4)}
    pre = {3: [f"--pretrained_path={dirs[1]}"],
           4: [f"--pretrained_path={dirs[1]}",
               f"--pretrained_poseAE_path={dirs[2]}"]}
    for m, d in dirs.items():
        port_main.main([f"--model={m}", "--max_step=2", "--log_step=1",
                        f"--model_dir={d}", *TINY, *pre.get(m, [])])
    return dirs


def test_cli_trains_models_2_3_4_and_resumes(chain):
    hists = {3: [f"embs_{s}_{p}" for s in ("real", "fake")
                 for p in ("fg", "bg")], 4: ["embs_real", "embs_fake"]}
    for m in (2, 3, 4):
        d = chain[m]
        with open(os.path.join(d, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        assert [r["step"] for r in recs] == [0, 1]
        for r in recs:
            assert all(np.isfinite(v) for v in r.values())
            for h in hists.get(m, []):
                assert r[f"{h}_std"] > 0 and f"{h}_mean" in r
        previews = sorted(f for f in os.listdir(d) if "_G_ssim" in f)
        assert len(previews) == (0 if m == 2 else 1)
        assert ckpt.latest_checkpoint(d).endswith("step_00000002")
    # model 3 carries the model-1 nets it was given, untouched
    s1 = ckpt.restore_subtrees(chain[1], ["Encoder", "ID_AE"])
    s3 = ckpt.load_tree(chain[3])
    _assert_tree_equal(s3["frozen_params"], s1)
    assert float(max(t.abs().max() for sub in s3["d_params"].values()
                     for t in sub.values())) <= 0.01
    # a rerun to step 3 resumes at 2, frozen nets included
    port_main.main(["--model=3", "--max_step=3", "--log_step=1",
                    f"--model_dir={chain[3]}", *TINY])
    s3b = ckpt.load_tree(chain[3])
    assert s3b["step"] == 3
    _assert_tree_equal(s3b["frozen_params"], s1)


def test_compose_pretrained_reads_port_checkpoints(chain):
    cfg = _cfg(pretrained_path=chain[1], pretrained_poseAE_path=chain[2],
               pretrained_appSample_path=chain[3],
               pretrained_poseSample_path=chain[4])
    merged = ckpt.compose_pretrained(cfg)
    assert set(merged) == {"Encoder", "ID_AE", "PoseAE", "Gaussian_FC_Fg",
                           "Gaussian_FC_Bg", "PoseGaussian"}
    trees = {m: ckpt.load_tree(chain[m]) for m in (1, 2, 3, 4)}
    _assert_tree_equal(merged["Encoder"], trees[1]["g_params"]["Encoder"])
    _assert_tree_equal(merged["PoseAE"], trees[2]["g_params"]["PoseAE"])
    _assert_tree_equal(merged["PoseGaussian"],
                       trees[4]["g_params"]["PoseGaussian"])
    # frozen nets, then critics, are looked up after the trained nets
    got = ckpt.restore_subtrees(chain[4], ["PoseAE", "Pose_emb_FCDis"])
    _assert_tree_equal(got["PoseAE"], trees[4]["frozen_params"]["PoseAE"])
    _assert_tree_equal(got["Pose_emb_FCDis"],
                       trees[4]["d_params"]["Pose_emb_FCDis"])
    with pytest.raises(KeyError, match="Gaussian_FC_Fg"):
        ckpt.restore_subtrees(chain[4], ["Gaussian_FC_Fg"])


def test_model_11_on_the_chain_scores_zeros_without_a_d(chain, capsys):
    """With all four --pretrained_* flags the tester needs no fresh net
    (no RANDOM-init line) and, as JAX, has no D: the scores are 0. With one
    flag missing it says so and scores with a fresh D."""
    flags = [f"--pretrained_path={chain[1]}",
             f"--pretrained_poseAE_path={chain[2]}",
             f"--pretrained_appSample_path={chain[3]}",
             f"--pretrained_poseSample_path={chain[4]}"]
    out = port_main.test_model(port_main.get_config([
        "--model=11", "--is_train=false", "--sample_app=true",
        "--pose_source=sampled", "--test_batch_num=1",
        f"--model_dir={chain[1]}/m11", *TINY, *flags]))
    assert "RANDOM" not in capsys.readouterr().out
    g = sorted(os.listdir(os.path.join(out, "G")))
    assert len(g) == 4 and all(n.endswith("_score0.000.png") for n in g)
    t = testers.FullSamplingTester(_cfg(
        pretrained_path=chain[1], pretrained_appSample_path=chain[3]))
    assert "['PoseAE', 'PoseGaussian'] — using RANDOM init" in \
        capsys.readouterr().out
    assert t.stage1.disc is not None
    trained = ckpt.load_tree(chain[3])["g_params"]["Gaussian_FC_Fg"]
    _assert_tree_equal(t.cpu_state()["Gaussian_FC_Fg"], trained)

