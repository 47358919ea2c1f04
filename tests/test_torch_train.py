"""Stage-I training (model 1) in the port against the JAX package.

One `train_step` from the same params and batch on both sides, for both
`fast_gan_step` variants: the five metrics, the G and D gradients, the
updated params, the D's running statistics and `step`. Then the pieces:
the optimizer table against optax on identical gradients, the GAN losses
and the gradient penalty, BatchNorm's running statistics against flax,
`upscale_nn`'s gradient, the float32 guard over the backward passes, the
checkpoints with auto-resume, and the CLI run.

Tolerances are stated where they are used. Why the gradients are held
against eager `jax.grad` and not the jitted step's: on the CPU, XLA's
compiled encoder backward is off by up to 4.3e-3 of a tensor's largest
gradient in the first ROI-tower stage against a float64 run of the port,
where eager JAX reads 2.5e-6 and the port 1.7e-6
(scripts/port_grad_precision.py). The updated params come from the
jitted JAX step, so they also carry that.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpig_tpu.apps import common as jcommon
from dpig_tpu.apps.stage1_app import Stage1App as JaxStage1App
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.data.synthetic import SyntheticLoader as JaxLoader
from dpig_tpu.losses import gan as jgan
from dpig_tpu.ops.image import upscale_nn as jupscale_nn
from dpig_tpu.train import state as jstate
from dpig_tpu_torch import main as port_main
from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.apps.stage1_app import Stage1App
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.data.synthetic import SyntheticLoader
from dpig_tpu_torch.losses import gan
from dpig_tpu_torch.models.layers import BatchNorm
from dpig_tpu_torch.ops.image import upscale_nn
from dpig_tpu_torch.train import checkpoint as ckpt
from dpig_tpu_torch.train.harness import Trainer
from dpig_tpu_torch.train.parity import recorded_train_step
from dpig_tpu_torch.train.state import halving_schedule, make_optimizer

torch.set_num_threads(1)

SMALL = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16)
CPU = torch.device("cpu")
METRICS = ("g_loss", "g_loss_only", "d_loss", "L1Loss", "PoseMaskLoss")
LR = Config().g_lr  # 8e-5, both nets
BN_FED_BIASES = {f"Discriminator/Conv_{i}.bias" for i in (1, 2, 3)}
SUBNETS = ("Encoder", "ID_AE", "Discriminator")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _bridge(g_params, d_params, d_stats):
    return params_from_flax({"Encoder": g_params["Encoder"],
                             "ID_AE": g_params["ID_AE"],
                             "Discriminator": d_params["Discriminator"],
                             "Discriminator_stats": d_stats})


@pytest.fixture(scope="module")
def jax_init():
    """The JAX package's initial Stage-I state, copied to numpy (its
    train_step donates the state), and one batch."""
    japp = JaxStage1App(JaxConfig(**SMALL))
    st = japp.init_state(jax.random.PRNGKey(3))
    init = _np_tree({"g": st.g_params, "d": st.d_params, "s": st.d_stats})
    return st, init, next(JaxLoader(4, 32, 16, seed=3))


def _jax_reference(japp, st, init, batch):
    """JAX's step (jitted, as the package runs it) and the gradients of
    its two objectives by eager jax.grad, mirroring train_step's body. The
    D's fakes come from the G params after an eager G update (optax on the
    eager gradients), so that the jitted step's gradient error does not
    reach the D gradients through sign-flipped Adam updates."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pose = jcommon.pose_maps_from_batch(jb, japp.cfg)
    bbox, vis = jcommon.select_parts(jb["part_bbox"], jb["part_vis"], 7)
    x, mask = jb["x"], jb["mask_r6"]
    new_state, metrics = japp.train_step(st, jb, jax.random.PRNGKey(0))
    new = _np_tree({"g": new_state.g_params, "d": new_state.d_params,
                    "s": new_state.d_stats})

    def g_obj(g_params):
        g_raw, _ = japp.g_forward(g_params, x, pose, mask, bbox, vis)
        d_fake, _ = japp._disc_apply(init["d"], init["s"], g_raw)
        return (jgan.g_loss("dcgan", d_fake)
                + japp.cfg.L1Loss_weight * jcommon.l1_loss(g_raw, x))

    g_grads = jax.grad(g_obj)(init["g"])
    g_params = init["g"]
    if not japp.cfg.fast_gan_step:
        tx = jstate.make_optimizer("dcgan", japp.cfg.g_lr,
                                   japp.cfg.lr_update_step)
        updates, _ = tx.update(g_grads, tx.init(g_params), g_params)
        g_params = optax.apply_updates(g_params, updates)
    fake, _ = japp.g_forward(g_params, x, pose, mask, bbox, vis)

    def d_obj(d_params):
        d_real, stats1 = japp._disc_apply(d_params, init["s"], x)
        d_fake, _ = japp._disc_apply(d_params, stats1, fake)
        return jgan.d_loss("dcgan", d_real, d_fake)

    grads = _bridge(g_grads, jax.grad(d_obj)(init["d"]), init["s"])
    return ({k: float(v) for k, v in metrics.items()},
            _bridge(new["g"], new["d"], new["s"]), grads,
            int(new_state.step))


@pytest.mark.parametrize("fast", [False, True], ids=["reforward", "fast"])
def test_train_step_matches_jax(jax_init, fast):
    st, init, batch = jax_init
    japp = JaxStage1App(JaxConfig(fast_gan_step=fast, **SMALL))
    st = jax.tree_util.tree_map(jnp.array, st)  # a copy to donate
    metrics_ref, new_ref, grads_ref, step_ref = _jax_reference(
        japp, st, init, batch)

    app = Stage1App(Config(platform="cpu", fast_gan_step=fast, **SMALL), CPU,
                    state=_bridge(init["g"], init["d"], init["s"]))
    rec = recorded_train_step(app, batch)
    metrics, grads, state = rec.metrics, rec.grads, rec.state

    assert set(metrics) == set(METRICS)
    for k in METRICS:  # float32 sums in other orders
        np.testing.assert_allclose(metrics[k], metrics_ref[k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert state.step == step_ref == 1
    for p in app.encoder.parameters():
        assert p.grad is None  # autograd.grad: nothing accumulates
    for p in app.disc.parameters():
        assert p.grad is None

    # Gradients: max |diff| per tensor within 1e-4 of that tensor's
    # largest |grad| (measured: at most 1.2e-5). The D's conv biases ahead
    # of a BatchNorm have a zero gradient in exact arithmetic (the batch
    # mean takes them out): both sides must give under 1e-5 of the D's
    # largest |grad| there.
    d_scale = max(float(g.abs().max()) for n, g in grads.items()
                  if n.startswith("Discriminator/"))
    for name, g in grads.items():
        sub, key = name.split("/", 1)
        ref = grads_ref[sub][key]
        if name in BN_FED_BIASES:
            assert max(float(g.abs().max()), float(ref.abs().max())) <= (
                1e-5 * d_scale), name
            continue
        scale = float(ref.abs().max())
        assert float((g - ref).abs().max()) <= 1e-4 * scale, name

    # Updated params: Adam's first update is lr * g / (|g| + 1e-8), +-lr
    # for any gradient well above 1e-8, so an element whose gradient sign
    # differs between the two float32 runs moves 2 * lr apart; 1e-6 on
    # top covers the rest. Most elements agree far closer: at most 0.1%
    # may differ by more than lr / 100 (measured: 0.026%).
    for sub, module in zip(SUBNETS, (app.encoder, app.generator, app.disc)):
        sd = module.state_dict()
        diffs = torch.cat([(sd[k] - ref).abs().reshape(-1)
                           for k, ref in new_ref[sub].items()])
        assert float(diffs.max()) <= 2 * LR + 1e-6, sub
        assert float((diffs > LR / 100).float().mean()) <= 1e-3, sub
    # the D's running statistics, chained real -> fake, moved by the step
    # (measured: 8.6e-6 with the re-forward, whose fakes come from the
    # jitted step's G update, 1.8e-7 without)
    sd = app.disc.state_dict()
    for k, ref in new_ref["Discriminator_stats"].items():
        torch.testing.assert_close(sd[k], ref, rtol=0, atol=2e-5)
        assert not torch.equal(ref, _bridge(init["g"], init["d"], init["s"])
                               ["Discriminator_stats"][k])


@pytest.mark.parametrize("mode", ["dcgan", "ae", "wgan-gp", "wgan", "lsgan"])
def test_optimizer_matches_optax(mode, rng):
    """Three updates on identical gradients, the halving schedule crossing
    its interval (2) before the third: params and moments within float32
    rounding (rtol 1e-6). RMSProp's eps sits inside the square root."""
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 3, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    tx = jstate.make_optimizer(mode, 1e-3, 2)
    jparams, jopt = dict(params), tx.init(params)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = make_optimizer(mode, tparams, 1e-3, 2)
    for _ in range(3):
        grads = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1))
                 .astype(np.float32) for k, s in shapes.items()}
        updates, jopt = tx.update(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(grads[k]) for k in opt.params])
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(), jparams[k],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    moments = [s for s in jax.tree_util.tree_leaves(
        jopt, is_leaf=lambda x: isinstance(x, dict)) if isinstance(s, dict)]
    names = ("mu", "nu") if mode in ("dcgan", "ae", "wgan-gp") else ("nu",)
    assert len(moments) == len(names) and opt.count == 3
    for name, ref in zip(names, moments):
        for k in shapes:
            np.testing.assert_allclose(opt.moments[name][k].numpy(), ref[k],
                                       rtol=1e-6, atol=1e-12)


def test_halving_schedule_matches_jax():
    ref = jstate.halving_schedule(8e-5, 3)
    port = halving_schedule(8e-5, 3)
    for count in range(8):
        assert port(count) == float(ref(jnp.asarray(count, jnp.int32)))
    assert port(2) == port(0) and port(3) == port(0) / 2


def _critic_pair(rng, dim):
    """The same small critic on both sides: x -> sum(tanh(x W)) per sample."""
    w = rng.standard_normal((dim, 5)).astype(np.float32) * 0.3
    jw, tw = jnp.asarray(w), torch.from_numpy(w).requires_grad_(True)

    def jcritic(x, w=jw):
        return jnp.tanh(x.reshape(x.shape[0], -1) @ w).sum(-1)

    def tcritic(x):
        return torch.tanh(x.reshape(x.shape[0], -1) @ tw).sum(-1)

    return jcritic, tcritic, jw, tw


@pytest.mark.parametrize("mode", ["dcgan", "lsgan", "wgan", "wgan-gp"])
def test_gan_losses_match_jax(mode, rng):
    """g_loss / d_loss in every mode (the penalty with the same alpha,
    drawn by jax.random); float32, tolerance 1e-6 relative."""
    real = rng.standard_normal((4, 6, 3, 2)).astype(np.float32)
    fake = rng.standard_normal((4, 6, 3, 2)).astype(np.float32)
    d_real = rng.standard_normal(4).astype(np.float32) * 30  # saturating
    d_fake = rng.standard_normal(4).astype(np.float32) * 30
    jcritic, tcritic, _, _ = _critic_pair(rng, 36)
    key = jax.random.PRNGKey(5)
    alpha = np.array(jax.random.uniform(key, (4, 1, 1, 1)))
    ref_g = jgan.g_loss(mode, jnp.asarray(d_fake))
    ref_d = jgan.d_loss(mode, jnp.asarray(d_real), jnp.asarray(d_fake),
                        critic_fn=jcritic, real_data=jnp.asarray(real),
                        fake_data=jnp.asarray(fake), rng=key)
    t = torch.from_numpy
    port_g = gan.g_loss(mode, t(d_fake))
    port_d = gan.d_loss(mode, t(d_real), t(d_fake), critic_fn=tcritic,
                        real_data=t(real), fake_data=t(fake), alpha=t(alpha))
    np.testing.assert_allclose(float(port_g), float(ref_g), rtol=1e-6)
    np.testing.assert_allclose(float(port_d.detach()), float(ref_d), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown GAN mode"):
        gan.g_loss("hinge", t(d_fake))


def test_gradient_penalty_and_its_critic_gradient_match_jax(rng):
    """The penalty (norm over all non-batch axes, +1e-12 in the sqrt) and
    its gradient w.r.t. the critic's weights (double backward), same
    alpha; tolerance 1e-5 relative."""
    real = rng.standard_normal((4, 6, 3, 2)).astype(np.float32)
    fake = rng.standard_normal((4, 6, 3, 2)).astype(np.float32)
    jcritic, tcritic, jw, tw = _critic_pair(rng, 36)
    key = jax.random.PRNGKey(9)
    alpha = np.array(jax.random.uniform(key, (4, 1, 1, 1)))

    def jgp(w):
        return jgan.gradient_penalty(lambda x: jcritic(x, w),
                                     jnp.asarray(real), jnp.asarray(fake),
                                     key)

    ref, ref_dw = jax.value_and_grad(jgp)(jw)
    gp = gan.gradient_penalty(tcritic, torch.from_numpy(real),
                              torch.from_numpy(fake), torch.from_numpy(alpha))
    (dw,) = torch.autograd.grad(gp, tw)
    np.testing.assert_allclose(float(gp.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(ref_dw), rtol=1e-5,
                               atol=1e-6)


def test_clip_params_matches_jax(rng):
    p = rng.standard_normal((3, 5)).astype(np.float32) * 0.02
    ref = jgan.clip_params({"w": jnp.asarray(p)})["w"]
    t = torch.from_numpy(p.copy())
    gan.clip_params([t])
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref))
    assert (gan.GP_LAMBDA, gan.CRITIC_ITERS, gan.WGAN_CLIP) == (
        jgan.GP_LAMBDA, jgan.CRITIC_ITERS, jgan.WGAN_CLIP)


def test_batchnorm_running_stats_match_flax(rng):
    """Two chained updating passes (as the D step's real and fake passes)
    against flax's mutable apply: the outputs, and the running mean and
    biased variance with momentum 0.9; tolerance 1e-6 absolute."""
    from flax import linen as nn
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9)
    x1 = rng.normal(0.5, 2.0, (4, 5, 3, 6)).astype(np.float32)
    x2 = rng.normal(-1.0, 0.5, (4, 5, 3, 6)).astype(np.float32)
    variables = bn.init(jax.random.PRNGKey(0), x1)
    port = BatchNorm(6)
    with torch.no_grad():
        port.weight.fill_(1.0)
        port.bias.zero_()
    stats = variables["batch_stats"]
    for x in (x1, x2):
        ref, new = bn.apply({**variables, "batch_stats": stats}, x,
                            mutable=["batch_stats"])
        stats = new["batch_stats"]
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2), train=True,
                   update_stats=True)
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(ref), atol=1e-5, rtol=0)
        np.testing.assert_allclose(port.running_mean.numpy(),
                                   np.asarray(stats["mean"]), atol=1e-6)
        np.testing.assert_allclose(port.running_var.numpy(),
                                   np.asarray(stats["var"]), atol=1e-6)
    before = port.running_var.clone()
    port(torch.from_numpy(x1).permute(0, 3, 1, 2), train=True)  # G step
    assert torch.equal(port.running_var, before)


def test_upscale_gradient_matches_jax_custom_vjp(rng):
    """The JAX package's custom VJP (2x2 sum) = autograd through the
    port's expand + reshape and through the generator's repeat_interleave;
    float32 sums of four, tolerance 1e-6."""
    x = rng.standard_normal((2, 5, 3, 4)).astype(np.float32)
    ct = rng.standard_normal((2, 10, 6, 4)).astype(np.float32)
    out, vjp = jax.vjp(jupscale_nn, jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_(True)
    port = upscale_nn(tx)
    np.testing.assert_array_equal(port.detach().numpy(), np.asarray(out))
    (g,) = torch.autograd.grad(port, tx, torch.from_numpy(ct))
    np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    nchw = tx.permute(0, 3, 1, 2)
    rep = nchw.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    (g2,) = torch.autograd.grad(rep, tx, torch.from_numpy(ct)
                                .permute(0, 3, 1, 2))
    np.testing.assert_allclose(g2.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_train_step_backward_and_updates_run_float32(tmp_path):
    """With PyTorch's TF32 flags on, the gradient of every net's
    parameters is computed, and both optimizers step, with the flags off;
    the caller's flags come back after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    app = Stage1App(Config(platform="cpu", model_dir=str(tmp_path), **SMALL),
                    CPU)
    state = app.init_state()
    seen = []

    def flags(*_):
        seen.append((cudnn.allow_tf32, matmul.allow_tf32))

    for m in (app.encoder, app.generator, app.disc):
        next(m.parameters()).register_hook(flags)
    for opt in (state.g_opt, state.d_opt):
        step = opt.step
        opt.step = lambda grads, step=step: (flags(), step(grads))
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        app.train_step(state, batch_to_device(
            next(SyntheticLoader(4, 32, 16, seed=1)), CPU))
        assert seen == [(False, False)] * 5  # 3 param hooks + 2 updates
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _small_cfg(tmp_path, **kw):
    return Config(platform="cpu", model_dir=str(tmp_path), log_step=1, **SMALL,
                  **kw)


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), path
    else:
        assert got == want, path


def test_checkpoint_round_trip_and_auto_resume(tmp_path):
    cfg = _small_cfg(tmp_path, max_step=2)
    loader = SyntheticLoader(4, 32, 16, seed=2)
    state = Trainer(cfg, Stage1App(cfg, CPU), loader).train()
    saved = ckpt.state_tree(state)
    path = ckpt.latest_checkpoint(str(tmp_path))
    assert path.endswith(os.path.join("ckpt", "step_00000002"))
    assert saved["g_opt_state"]["count"] == saved["step"] == 2

    # a fresh app (other weights) resumes from model_dir
    fresh = Stage1App(_small_cfg(tmp_path, max_step=2, random_seed=7), CPU)
    resumed = Trainer(fresh.cfg, fresh, loader).init_state()
    assert resumed.step == 2
    # and from --ckpt_path, given a model_dir
    other = Stage1App(_small_cfg(tmp_path / "x", ckpt_path=str(tmp_path)), CPU)
    from_path = Trainer(other.cfg, other, loader).init_state()
    for got in (ckpt.state_tree(resumed), ckpt.state_tree(from_path)):
        _assert_tree_equal(got, saved)
    with pytest.raises(FileNotFoundError):
        ckpt.resolve_checkpoint(str(tmp_path / "nothing"))


def test_cli_trains_model_1(tmp_path, capsys):
    port_main.main([
        "--model=1", "--platform=cpu", "--synthetic_data=true",
        "--max_step=3", "--log_step=1", f"--model_dir={tmp_path}",
        "--img_H=32", "--img_W=16", "--batch_size=4",
        "--conv_hidden_num=16", "--z_num=16"])
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1, 2]
    for r in recs:
        assert set(r) == {"step", "imgs_per_sec", *METRICS}
        assert all(np.isfinite(v) for v in r.values())
    files = set(os.listdir(tmp_path))
    assert {"x_fixed.png", "x_target_fixed.png", "pose_fixed.png",
            "mask_fixed.png", "params.json"} <= files
    previews = sorted(f for f in files if "_G_ssim" in f)
    assert [p.split("_")[0] for p in previews] == ["0", "2"]
    assert os.path.exists(tmp_path / "ckpt" / "step_00000003" / "state.pt")
    assert "[2] " in capsys.readouterr().out


def test_cli_refuses_to_train_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(["--model=1", "--synthetic_data=true",
                        f"--model_dir={tmp_path}"])
    assert not os.listdir(tmp_path)  # nothing written before the refusal


def test_unported_training_options_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="remat.*The remaining"):
        Stage1App(_small_cfg(tmp_path, remat=True), CPU).init_state()
    # bfloat16 is ported (tests/test_torch_bf16.py); a dtype that is
    # neither raises, where the JAX package would run float32 silently
    with pytest.raises(ValueError, match="compute_dtype"):
        Stage1App(_small_cfg(tmp_path, compute_dtype="float16"), CPU)
    with pytest.raises(NotImplementedError, match="D_arch.*The remaining"):
        Stage1App(_small_cfg(tmp_path, D_arch="DCGANRegion"), CPU)
