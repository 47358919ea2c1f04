"""The bfloat16 compute path (`--compute_dtype=bfloat16`) of the port
against the JAX package's, on the CPU at a tiny config: the FG/BG ROI
encoder, the generator module, the DCGAN D in train mode (BatchNorm),
`quant.uae_forward_bf16`, one model-1 train step and one model-3 step with
the frozen bfloat16 encoder.

Limits come from JAX's own gap: the same inputs through JAX at bfloat16
and at float32. The port at bfloat16 must be as close to JAX at bfloat16
as JAX's bfloat16 is to its float32: max |diff| at most that gap's max,
and mean |diff| below that gap's mean. float32 is the control: port and
JAX at float32 within 1e-5. Readings at this config are in the docstring
of each test. Where both sides round a handful of outputs to bfloat16 at
the same magnitude (the D's 4 logits), one bfloat16 ulp of the largest
output is added to the max limit: a tie that rounds the other way is a
whole ulp.

Both sides sum a bfloat16 conv's exact products in float32 and round the
output once. On the CPU the port does that as a float32 conv of the
bfloat16 values (`models/layers.py:conv2d_same`: PyTorch's oneDNN
bfloat16 conv gives wrong sums at the D's last stage here), so the
encoder matches JAX bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpig_tpu.apps import common as jcommon
from dpig_tpu.apps.stage1_app import Stage1App as JaxStage1App
from dpig_tpu.apps.stage2_app import Stage2AppApp as JaxAppApp
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.data.synthetic import SyntheticLoader as JaxLoader
from dpig_tpu.data.synthetic import synthetic_batch
from dpig_tpu.losses import gan as jgan
from dpig_tpu.models import quant as jquant
from dpig_tpu.ops.pose import render_pose_maps
from dpig_tpu.train import state as jstate
from dpig_tpu_torch.apps.common import select_parts
from dpig_tpu_torch.apps.stage1_app import Stage1App
from dpig_tpu_torch.apps.stage2_app import Stage2AppApp
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.models import quant
from dpig_tpu_torch.train.parity import recorded_train_step

torch.set_num_threads(1)

SMALL = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16)
CPU = torch.device("cpu")
F32_TOL = 1e-5
LR = Config().g_lr
BF16_ULP_AT_1 = 2.0 ** -7


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _f(a):
    return np.asarray(a, np.float32)


def _check(name, j32, j16, p16, p32):
    """Port bf16 vs JAX bf16 within JAX's bf16-vs-f32 gap; port f32 vs JAX
    f32 within F32_TOL. Returns the readings."""
    j32, j16, p16, p32 = (_f(a) for a in (j32, j16, p16, p32))
    gap = np.abs(j16 - j32)
    diff = np.abs(p16 - j16)
    limit = gap.max()
    readings = dict(gap_max=gap.max(), gap_mean=gap.mean(),
                    max=diff.max(), mean=diff.mean(),
                    f32=np.abs(p32 - j32).max())
    assert diff.max() <= limit, (name, readings)
    assert diff.mean() < gap.mean(), (name, readings)
    assert readings["f32"] <= F32_TOL, (name, readings)
    return readings


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(7)
    j32 = JaxStage1App(JaxConfig(**SMALL))
    j16 = JaxStage1App(JaxConfig(compute_dtype="bfloat16", **SMALL))
    st = j32.init_state(jax.random.PRNGKey(3))
    tree = _np({"Encoder": st.g_params["Encoder"],
                "ID_AE": st.g_params["ID_AE"],
                "Discriminator": st.d_params["Discriminator"],
                "Discriminator_stats": st.d_stats})
    tree["Discriminator_stats"] = jax.tree_util.tree_map(
        lambda v: v + rng.uniform(0.1, 0.5, v.shape).astype(np.float32),
        tree["Discriminator_stats"])
    state = params_from_flax(tree)
    p32 = Stage1App(Config(platform="cpu", **SMALL), CPU, state=state)
    p16 = Stage1App(Config(platform="cpu", compute_dtype="bfloat16",
                           **SMALL), CPU, state=state)
    batch = synthetic_batch(rng, 4, 32, 16)
    embs = rng.normal(0, 1, (4, 352)).astype(np.float32)
    pose = np.asarray(render_pose_maps(jnp.asarray(batch["pose_rcv"]), 32,
                                       16))
    return j32, j16, tree, p32, p16, batch, embs, pose


def test_modules_are_bf16_with_float32_params(nets):
    *_, p32, p16, _, _, _ = nets
    assert p16.dtype == torch.bfloat16 and p32.dtype == torch.float32
    for m in (p16.encoder, p16.generator, p16.disc):
        assert all(p.dtype == torch.float32 for p in m.parameters())


def test_encoder_bf16_matches_jax(nets):
    """Readings: JAX's gap max 2.7e-3, mean 5.1e-4; port vs JAX bf16 0
    (bit-equal); float32 3.2e-7."""
    j32, j16, tree, p32, p16, b, _, _ = nets
    bbox, vis = b["part_bbox"][:, :7], b["part_vis"][:, :7].astype(np.float32)
    args = (b["x"], b["mask_r6"], bbox, vis)
    targs = (_t(b["x"]), _t(b["mask_r6"]),
             *select_parts(_t(b["part_bbox"]), _t(b["part_vis"])))
    with torch.no_grad():
        out16 = p16.encoder(*targs)
        assert out16.dtype == torch.bfloat16
        _check("encoder",
               j32.encoder.apply({"params": tree["Encoder"]}, *args),
               j16.encoder.apply({"params": tree["Encoder"]}, *args),
               out16.float(), p32.encoder(*targs))


def test_generator_bf16_matches_jax(nets):
    """Readings: JAX's gap max 2.7e-2, mean 5.0e-3; port vs JAX bf16 max
    1.6e-2, mean 1.3e-4; float32 2.5e-6. z likewise."""
    j32, j16, tree, p32, p16, _, embs, pose = nets
    r32, z32 = j32.generator.apply({"params": tree["ID_AE"]}, None, pose,
                                   embs_const=embs)
    r16, z16 = j16.generator.apply({"params": tree["ID_AE"]}, None, pose,
                                   embs_const=embs)
    with torch.no_grad():
        o16, q16 = p16.generator(_t(embs), _t(pose))
        o32, q32 = p32.generator(_t(embs), _t(pose))
    assert o16.dtype == q16.dtype == torch.bfloat16
    _check("g_raw", r32, r16, o16.float(), o32)
    _check("z", z32, z16, q16.float(), q32)


def test_discriminator_bf16_train_mode_matches_jax(nets):
    """BatchNorm on the batch's own statistics (train=True), and the
    running statistics moved as flax's mutable apply moves them. Readings:
    JAX's gap max 7.5e-3, mean 3.5e-3; port vs JAX bf16 max 7.8e-3 (one
    ulp at the logits' ~1), mean 5.5e-3 -> the mean is held to the max
    limit too; float32 2.4e-6. The moved running statistics within twice
    JAX's own gap for each buffer: they average squares of bf16 conv
    outputs that each side rounds on its own, over 4 samples (readings:
    BatchNorm_1.running_var 3.0e-4 against a gap of 2.6e-4, the others
    at most 1.5e-4)."""
    j32, j16, tree, p32, p16, b, _, _ = nets
    img = b["x_target"]
    variables = {"params": tree["Discriminator"],
                 "batch_stats": tree["Discriminator_stats"]}
    r32, new32 = j32.disc.apply(variables, img, train=True,
                                mutable=["batch_stats"])
    r16, new16 = j16.disc.apply(variables, img, train=True,
                                mutable=["batch_stats"])
    with torch.no_grad():
        o16 = p16.disc(_t(img), train=True, update_stats=True)
        o32 = p32.disc(_t(img), train=True)
    assert o16.dtype == torch.bfloat16
    j32a, j16a, p16a = _f(r32), _f(r16), _f(o16.float())
    gap, diff = np.abs(j16a - j32a), np.abs(p16a - j16a)
    limit = gap.max() + BF16_ULP_AT_1 * 2.0 ** np.floor(
        np.log2(np.abs(j16a).max()))
    assert diff.max() <= limit and diff.mean() <= limit, (diff, gap)
    assert np.abs(_f(o32) - j32a).max() <= F32_TOL
    want, other = (params_from_flax({"d_stats": n["batch_stats"]},
                                    ["d_stats"])["d_stats"]
                   for n in (new16, new32))
    got = p16.disc.state_dict()
    for k, v in want.items():
        gap = float((v - other[k]).abs().max())
        assert float((got[k] - v).abs().max()) <= 2 * gap, (k, gap)


def test_uae_forward_bf16_matches_jax_and_the_module(nets):
    """`quant.uae_forward_bf16` against JAX's and against the port's bf16
    module (1x1 conv before the upsample, an exact commute: equal, or one
    bf16 ulp where the two sum in another order). Readings: vs JAX max
    1.6e-2, mean 1.3e-4 (JAX's gap 2.7e-2 / 5.0e-3); vs the module: 0."""
    j32, j16, tree, p32, p16, _, embs, pose = nets
    ref16, _ = jquant.uae_forward_bf16(tree["ID_AE"], embs, pose, 3, 16)
    ref32, _ = j32.generator.apply({"params": tree["ID_AE"]}, None, pose,
                                   embs_const=embs)
    with torch.no_grad():
        out, z = quant.uae_forward_bf16(p16.generator, _t(embs), _t(pose),
                                        3, 16)
        mod, zm = p16.generator(_t(embs), _t(pose))
        out32, _ = p32.generator(_t(embs), _t(pose))
    assert out.dtype == torch.float32 and z.dtype == torch.bfloat16
    _check("uae_forward_bf16", ref32, ref16, out, out32)
    mod = mod.float()
    ulp = 2.0 ** (torch.floor(torch.log2(mod.abs().clamp_min(1e-30))) - 7)
    assert bool(((out - mod).abs() <= ulp).all())
    assert torch.equal(z, zm)


# -------------------------------------------------------------- model 1
def _bridge(g, d, s):
    return params_from_flax({"Encoder": g["Encoder"], "ID_AE": g["ID_AE"],
                             "Discriminator": d["Discriminator"],
                             "Discriminator_stats": s})


def _jax_step_reference(japp, init, batch):
    """JAX's model-1 step in pieces: the G objective's gradients by
    jax.grad, the Adam update, the D objective's gradients on the fakes of
    the updated G -> (losses, g grads, d grads, updated G params). The
    gradients are jitted (a few minutes eager at two dtypes): XLA's 0.43%
    gradient error in the first ROI stage on the CPU
    (tests/test_torch_train.py) is far inside the bf16 gap."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pose = jcommon.pose_maps_from_batch(jb, japp.cfg)
    bbox, vis = jcommon.select_parts(jb["part_bbox"], jb["part_vis"], 7)
    x, mask = jb["x"], jb["mask_r6"]

    def g_obj(g_params):
        g_raw, _ = japp.g_forward(g_params, x, pose, mask, bbox, vis)
        d_fake, _ = japp._disc_apply(init["d"], init["s"], g_raw)
        return (jgan.g_loss("dcgan", d_fake)
                + japp.cfg.L1Loss_weight * jcommon.l1_loss(g_raw, x))

    g_loss, g_grads = jax.jit(jax.value_and_grad(g_obj))(init["g"])
    tx = jstate.make_optimizer("dcgan", japp.cfg.g_lr,
                               japp.cfg.lr_update_step)
    updates, _ = tx.update(g_grads, tx.init(init["g"]), init["g"])
    g_new = optax.apply_updates(init["g"], updates)
    fake, _ = jax.jit(japp.g_forward)(g_new, x, pose, mask, bbox, vis)

    def d_obj(d_params):
        d_real, stats1 = japp._disc_apply(d_params, init["s"], x)
        d_fake, _ = japp._disc_apply(d_params, stats1, fake)
        return jgan.d_loss("dcgan", d_real, d_fake)

    d_loss, d_grads = jax.jit(jax.value_and_grad(d_obj))(init["d"])
    return (float(g_loss), float(d_loss),
            _bridge(g_grads, d_grads, init["s"]),
            _bridge(_np(g_new), init["d"], init["s"]))


def _grad_err(got, want):
    """Per sub-net ||diff|| / ||grad|| over all its gradient tensors."""
    out = {}
    for sub in ("Encoder", "ID_AE", "Discriminator"):
        d = sum(float(((got[f"{sub}/{k}"] - v) ** 2).sum())
                for k, v in want[sub].items())
        n = sum(float((v ** 2).sum()) for v in want[sub].values())
        out[sub] = (d / n) ** 0.5
    return out


@pytest.fixture(scope="module")
def model1_refs(nets):
    j32, j16, tree = nets[:3]
    init = {"g": {"Encoder": tree["Encoder"], "ID_AE": tree["ID_AE"]},
            "d": {"Discriminator": tree["Discriminator"]},
            "s": tree["Discriminator_stats"]}
    batch = next(JaxLoader(4, 32, 16, seed=3))
    return (init, batch, _jax_step_reference(j32, init, batch),
            _jax_step_reference(j16, init, batch))


def test_train_step_bf16_matches_jax(model1_refs):
    """One model-1 step at bf16 (the G step, the Adam update, the D step on
    the updated G's fakes) against JAX's eager bf16 pieces: the losses and
    the gradients (worst tensor's max |diff| / max |grad|) within JAX's
    own bf16-vs-f32 gap (gradients per sub-net as ||diff|| / ||grad||),
    the updated G within Adam's sign-like first step
    (2 lr) with at most as large a share of elements more than lr/100
    apart as JAX's bf16 has against its float32. The D step starts from
    JAX's updated G (Adam's first step flips with the gradient's sign).
    Readings in the assertion messages."""
    init, batch, (g32, d32, gr32, new32), (g16, d16, gr16, new16) = \
        model1_refs
    app = Stage1App(Config(platform="cpu", compute_dtype="bfloat16",
                           **SMALL), CPU,
                    state=_bridge(init["g"], init["d"], init["s"]))
    g_updated = {f"{s}/{k}": v for s in ("Encoder", "ID_AE")
                 for k, v in new16[s].items()}
    rec = recorded_train_step(app, batch, g_updated=g_updated)
    readings = dict(
        g_loss=abs(rec.metrics["g_loss"] - g16), g_gap=abs(g16 - g32),
        d_loss=abs(rec.metrics["d_loss"] - d16), d_gap=abs(d16 - d32),
        grads=_grad_err(rec.grads, gr16),
        grad_gap=_grad_err({f"{s}/{k}": v for s in gr32 for k, v in
                            gr32[s].items()}, gr16))
    assert readings["g_loss"] <= readings["g_gap"], readings
    assert readings["d_loss"] <= readings["d_gap"], readings
    for sub, err in readings["grads"].items():
        assert err <= readings["grad_gap"][sub], (sub, readings)
    for sub in ("Encoder", "ID_AE"):
        diffs = torch.cat([(rec.g_updated[f"{sub}/{k}"] - v).abs()
                           .reshape(-1) for k, v in new16[sub].items()])
        jdiffs = torch.cat([(new32[sub][k] - v).abs().reshape(-1)
                            for k, v in new16[sub].items()])
        assert float(diffs.max()) <= 2 * LR + 1e-6, sub
        assert float((diffs > LR / 100).float().mean()) <= max(
            float((jdiffs > LR / 100).float().mean()), 1e-3), sub
    for p in app.encoder.parameters():
        assert p.dtype == torch.float32 and p.grad is None


# -------------------------------------------------------------- model 3
APP_NETS = ("Gaussian_FC_Fg", "Gaussian_FC_Bg", "Fg_FCDis", "Bg_FCDis")


def _app_noise(rng, b=4):
    """The noise JAX's model-3 step draws, as the port's [1+C, b, FG+BG]
    step noise (tests/test_torch_stage2.py)."""
    from dpig_tpu.models.mappers import sample_mapper_noise as jax_noise
    c = jgan.CRITIC_ITERS
    rngs = jax.random.split(rng, 2 + 2 * c)
    draws = []
    for r in [rngs[0]] + [rngs[2 + i] for i in range(c)]:
        rf, rb = jax.random.split(r)
        draws.append(np.concatenate([np.asarray(jax_noise(rf, b, 7 * 32)),
                                     np.asarray(jax_noise(rb, b, 4 * 32))],
                                    -1))
    return _t(np.stack(draws))


def test_model3_step_with_the_frozen_bf16_encoder_matches_jax():
    """One model-3 step (reused batch) at bf16: the frozen encoder runs in
    bf16 and the mappers and FC critics in float32, as in JAX. The real
    embeddings (the step's bf16 part) within JAX's own bf16-vs-f32 gap
    (readings: FG 0, BG 0: bit-equal, as the encoder test), the G losses
    (mapper outputs through the critics, float32 on both sides) within
    1e-5 relative. The D losses are the last critic iteration's, after
    four sign-like RMSProp updates of each side's own critics: the Stage-II
    tests hold those with synced critics at float32."""
    jax16 = JaxAppApp(JaxConfig(compute_dtype="bfloat16", **SMALL))
    st = jax16.init_state(jax.random.PRNGKey(1))
    init = _np({"g": st.g_params, "d": st.d_params, "f": st.frozen_params})
    batch = next(JaxLoader(4, 32, 16, seed=6))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(8)
    _, ref = jax16._step_impl(jax.tree_util.tree_map(jnp.array, st), jb,
                              rng, None)
    ref = _np(ref)
    assert ref["hist/embs_real_fg"].dtype == jnp.bfloat16
    # JAX's gap: the same frozen encoder at float32
    real32 = JaxAppApp(JaxConfig(**SMALL)).real_embs(st.frozen_params, jb)
    gap_ref = {"hist/embs_real_fg": real32[0], "hist/embs_real_bg": real32[1]}

    app = Stage2AppApp(Config(platform="cpu", compute_dtype="bfloat16",
                              **SMALL), CPU,
                       params_from_flax(init["f"], ("Encoder", "ID_AE")))
    assert app.stage1.encoder.bg_fc.dtype == torch.bfloat16
    state = params_from_flax({**init["g"], **init["d"]}, APP_NETS)
    for name, net in {**app.mappers, **app.critics}.items():
        net.load_state_dict(state[name], strict=True)
    rec = recorded_train_step(app, batch, noise=_app_noise(rng))
    for k in ("hist/embs_real_fg", "hist/embs_real_bg"):
        want, other = _f(ref[k]), _f(gap_ref[k])
        got = rec.arrays[k].numpy()
        assert np.abs(got - want).max() <= np.abs(want - other).max(), k
    for k in ("g_loss_embs_fg", "g_loss_embs_bg"):
        np.testing.assert_allclose(rec.metrics[k], float(ref[k]),
                                   rtol=1e-5, err_msg=k)
