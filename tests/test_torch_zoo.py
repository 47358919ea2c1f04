"""The port's zoo (`dpig_tpu_torch/models/zoo.py`), `layers.LayerNorm`,
`PlainEncoder` / `tile_embedding` and `PlainDecoder` against the JAX
package's modules (`dpig_tpu/models/zoo.py`, flax's `nn.LayerNorm`,
`encoders.py:145-172`, `generator.py:171-198`), on the CPU at tiny sizes
(32x16, dim 4-8, `blocks_per_scale` 1).

Each module runs on its JAX twin's params, bridged strictly
(`bridge.params_from_flax`; every 1-D leaf, biases and scales, moved off
its init so that a swapped or dropped one shows), on numpy inputs from a
seed, in float32 (`check_module`):
  * the train-mode outputs of two chained passes that update the
    BatchNorm statistics, as flax's mutable apply, and the statistics
    they leave;
  * the eval-mode output on those statistics;
  * the gradients of a scalar objective, sum(out * W) for a fixed random
    W, w.r.t. every parameter and every input.
Limits, per check: outputs within 1e-5 absolute and relative; the
statistics within 1e-6 absolute of a variance near 1; the gradients as
||diff|| / ||grad|| and max|diff| / max|grad| over all of them within
1e-5. The two sides sum in other orders; readings over these tests:
outputs at most 2.8e-6 (the ResnetGenerator's nine BatchNorms at batch
3; the rest at most 7.2e-7), statistics 1.2e-7, gradients 3.7e-6 (the
ResnetGenerator; the rest 8.7e-7). bfloat16: `ResnetGenerator` against JAX's bfloat16 within
JAX's own bfloat16-vs-float32 gap (the same as
`tests/test_torch_bf16.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from dpig_tpu.models import encoders as jenc
from dpig_tpu.models import generator as jgen
from dpig_tpu.models import zoo as jzoo
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.models import encoders, generator, layers, zoo

torch.set_num_threads(1)

BF16_ULP_AT_1 = 2.0 ** -7


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _grad_errors(got, want):
    """(||diff|| / ||grad||, the largest max|diff| over the largest
    |grad|), over all tensors; `got` and `want` are lists of arrays."""
    got = [np.asarray(g, np.float64) for g in got]
    want = [np.asarray(w, np.float64) for w in want]
    diff = sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want))
    norm = sum(float((w ** 2).sum()) for w in want)
    peak = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    return (diff / norm) ** 0.5, peak / max(float(np.abs(w).max())
                                            for w in want)


def jax_variables(jm, inputs, bn, seed=1, **kw):
    """`jm`'s fresh variables, every 1-D param and BatchNorm statistic
    moved off its init by a seeded uniform."""
    v = _np(jm.init(jax.random.PRNGKey(seed),
                    *[jnp.asarray(x) for x in inputs],
                    **({"train": True} if bn else {}), **kw))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
        if a.ndim == 1 else a, v["params"])
    stats = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
        v.get("batch_stats", {}))
    return {"params": params, "batch_stats": stats}


def load_port(pm, variables):
    """The port module on the bridged variables, loaded strictly."""
    tree = {"P": variables["params"], "P_stats": variables["batch_stats"]}
    state = params_from_flax(tree, ["P", "P_stats"])
    pm.load_state_dict({**state["P"], **state["P_stats"]}, strict=True)
    return pm


def _port_in(x, nchw):
    t = _t(x)
    return t.permute(0, 3, 1, 2) if nchw and t.dim() == 4 else t


def _port_out(t, nchw):
    return t.permute(0, 2, 3, 1) if nchw and t.dim() == 4 else t


def check_module(jm, make_port, inputs, *, bn, nchw=False, tol=1e-5,
                 grad_tol=1e-5, inputs2=None, jax_kw=None, port_kw=None):
    """`jm` and the port module `make_port()` on the same variables and
    numpy inputs (JAX layout; `nchw`: the port module takes and returns
    NCHW). Returns the readings (outputs, statistics, gradients)."""
    jax_kw, port_kw = jax_kw or {}, port_kw or {}
    variables = jax_variables(jm, inputs, bn, **jax_kw)
    params, stats0 = variables["params"], variables["batch_stats"]
    inputs2 = inputs if inputs2 is None else inputs2

    def japply(params, stats, xs, train=True):
        if bn:
            out, new = jm.apply({"params": params, "batch_stats": stats},
                                *xs, train=train, mutable=["batch_stats"],
                                **jax_kw)
            return out, new["batch_stats"]
        return jm.apply({"params": params}, *xs, **jax_kw), {}

    def papply(pm, xs, train=True, update=False):
        ts = [_port_in(x, nchw) for x in xs]
        if bn:
            out = pm(*ts, train=train, update_stats=update, **port_kw)
        else:
            out = pm(*ts, **port_kw)
        return _port_out(out, nchw)

    readings = {}
    pm = load_port(make_port(), variables)
    j1, s1 = japply(params, stats0, inputs)
    j2, s2 = japply(params, s1, inputs2)
    p1 = papply(pm, inputs, update=True)
    p2 = papply(pm, inputs2, update=True)
    for name, p, j in (("out", p1, j1), ("out2", p2, j2)):
        assert p.shape == j.shape, (name, p.shape, j.shape)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                   atol=tol, rtol=tol, err_msg=name)
        readings[name] = float(np.abs(p.detach().numpy()
                                      - np.asarray(j)).max())
    if bn:
        want = params_from_flax({"S_stats": _np(s2)},
                                ["S_stats"])["S_stats"]
        got = {k: v for k, v in pm.state_dict().items() if k in want}
        assert set(got) == set(want) and want
        readings["stats"] = max(float((got[k] - v).abs().max())
                                for k, v in want.items())
        assert readings["stats"] <= 1e-6, readings
        j_eval, _ = japply(params, s2, inputs, train=False)
        with torch.no_grad():
            p_eval = papply(pm, inputs, train=False)
        np.testing.assert_allclose(p_eval.numpy(), np.asarray(j_eval),
                                   atol=tol, rtol=tol, err_msg="eval")

    weight = np.random.default_rng(7).standard_normal(
        np.shape(j1)).astype(np.float32)

    def jobj(params, *xs):
        return jnp.sum(japply(params, stats0, xs)[0] * weight)

    jg = jax.jit(jax.grad(jobj, argnums=tuple(range(1 + len(inputs)))))(
        params, *[jnp.asarray(x) for x in inputs])
    jparams, jinputs = jg[0], jg[1:]
    pm = load_port(make_port(), variables)
    xs = [_t(x).requires_grad_(True) for x in inputs]
    ts = [x.permute(0, 3, 1, 2) if nchw and x.dim() == 4 else x for x in xs]
    out = pm(*ts, **({"train": True} if bn else {}), **port_kw)
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(
        (_port_out(out, nchw) * _t(weight)).sum(),
        [p for _, p in pm.named_parameters()] + xs)
    want = params_from_flax({"G": _np(jparams)}, ["G"])["G"]
    got = dict(zip(names, grads))
    assert set(want) == set(names)
    readings["grads"] = _grad_errors(
        [got[n] for n in names] + list(grads[len(names):]),
        [want[n] for n in names] + [np.asarray(g) for g in jinputs])
    assert max(readings["grads"]) <= grad_tol, readings
    return readings


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ----------------------------------------------------------------- blocks

def test_pixcnn_gated_matches_jax():
    a, b = _x(1, 2, 5, 3, 4), _x(2, 2, 5, 3, 4)
    np.testing.assert_allclose(
        zoo.pixcnn_gated(_t(a), _t(b)).numpy(),
        np.asarray(jzoo.pixcnn_gated(a, b)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_flax(dtype):
    """flax's LayerNorm over the channels (its fast variance, epsilon
    1e-6, statistics in float32) on an NHWC input with an offset mean:
    float32 within 1e-5 (outputs, gradients of x, scale and bias);
    bfloat16 (compute dtype) within one bfloat16 ulp of the largest
    output, both sides rounding the same float32 numbers."""
    x = _x(3, 2, 5, 3, 8) * 3.0 + 1.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jm = fnn.LayerNorm(dtype=jdt)
    tdt = getattr(torch, dtype)
    if dtype == "float32":
        r = check_module(jm, lambda: layers.LayerNorm(8), [x], bn=False,
                         nchw=True, tol=1e-5, grad_tol=1e-5)
        assert r["grads"][0] <= 1e-5
        return
    variables = jax_variables(jm, [x], bn=False)
    pm = load_port(layers.LayerNorm(8, dtype=tdt), variables)
    want = np.asarray(jm.apply(variables, x), np.float32)
    with torch.no_grad():
        got = pm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == tdt
    ulp = BF16_ULP_AT_1 * 2.0 ** np.floor(np.log2(np.abs(want).max()))
    assert np.abs(got.float().numpy() - want).max() <= ulp


def test_instance_norm_matches_jax():
    """Population variance over H, W per sample and channel, epsilon
    1e-3; `shift` bridged to `bias`. Outputs 1e-5, gradients 1e-5."""
    x = _x(4, 2, 6, 5, 3) * 2.0 + 0.5
    check_module(jzoo.InstanceNorm(), lambda: zoo.InstanceNorm(3), [x],
                 bn=False, nchw=True)


@pytest.mark.parametrize("cls", ["ResBlock", "ResBottleneckBlock"])
@pytest.mark.parametrize("in_ch,n3", [(6, 6), (4, 6)])
def test_res_blocks_match_jax(cls, in_ch, n3):
    """With and without the 1x1 projection (flax's `Conv_0` when the
    channels differ), LeakyReLU 0.3. Outputs 1e-5, gradients 1e-5."""
    x = _x(5, 2, 8, 6, in_ch)
    check_module(getattr(jzoo, cls)(n2=5, n3=n3),
                 lambda: getattr(zoo, cls)(in_ch, 5, n3), [x], bn=False,
                 nchw=True)


@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (5, 2)])
def test_conv_bn_leaky_relu_matches_jax(kernel, stride):
    """XLA's SAME padding (asymmetric at stride 2 on even sizes), the
    BatchNorm's statistics, LeakyReLU 0.2. Outputs 1e-5 (BatchNorm
    divides by the batch's deviation), gradients 1e-5."""
    x, x2 = _x(6, 2, 8, 6, 3), _x(7, 2, 8, 6, 3)
    check_module(jzoo.ConvBnLeakyReLU(5, kernel, stride),
                 lambda: zoo.ConvBnLeakyReLU(3, 5, kernel, stride), [x],
                 inputs2=[x2], bn=True, nchw=True)


@pytest.mark.parametrize("kernel", [1, 3])
def test_subpixel_conv_matches_jax(kernel):
    """The JAX package's (2, 2, C) channel order, not F.pixel_shuffle's
    (the control: pixel_shuffle of the same conv differs)."""
    x = _x(8, 2, 4, 3, 5)
    check_module(jzoo.SubpixelConv(3, kernel),
                 lambda: zoo.SubpixelConv(5, 3, kernel), [x], bn=False,
                 nchw=True)
    pm = load_port(zoo.SubpixelConv(5, 3, kernel),
                   jax_variables(jzoo.SubpixelConv(3, kernel), [x], False))
    xt = _t(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        shuffled = torch.nn.functional.pixel_shuffle(pm.Conv_0(xt), 2)
        assert not torch.allclose(shuffled, pm(xt))


@pytest.mark.parametrize("in_ch,out_ch,resample", [
    (8, 8, None), (8, 6, None), (4, 8, "down"), (8, 4, "up")])
def test_wgan_residual_block_matches_jax(in_ch, out_ch, resample):
    """Every shortcut (identity, 1x1, 1x1 stride 2, `SubpixelConv` as
    `shortcut.Conv_0`), `conv1b` at stride 2 with XLA's SAME padding or
    after the NN upscale, `conv2` without bias into the BatchNorm, the
    branch scaled by 0.3. At an odd size too (7x5 down). Outputs 1e-5,
    statistics 1e-6, gradients 1e-5."""
    h, w = (7, 5) if resample == "down" else (8, 4)
    x, x2 = _x(9, 2, h, w, in_ch), _x(10, 2, h, w, in_ch)
    pm = zoo.WGANResidualBlock(in_ch, out_ch, 3, resample)
    assert (pm.conv2.bias is None
            and (pm.shortcut is None) == (in_ch == out_ch and not resample))
    check_module(jzoo.WGANResidualBlock(out_ch, 3, resample),
                 lambda: zoo.WGANResidualBlock(in_ch, out_ch, 3, resample),
                 [x], inputs2=[x2], bn=True, nchw=True)


def test_wgan_residual_block_refuses_an_unknown_resample():
    with pytest.raises(ValueError, match="resample"):
        zoo.WGANResidualBlock(4, 4, 3, "sideways")


# ------------------------------------------------------------- generators

def test_fc_generator_matches_jax():
    """Four 512-wide ReLU layers, tanh, out 32*16*3. Outputs 1e-5,
    gradients 1e-5."""
    z = _x(11, 3, 16)
    check_module(jzoo.FCGenerator(out_dim=32 * 16 * 3),
                 lambda: zoo.FCGenerator(16, 32 * 16 * 3), [z], bn=False)


def test_dcgan_generator_matches_jax():
    """32x16, dim 8: Dense to 2x1x64, 4 x [BN, ReLU, upscale, 5x5 conv],
    channels 32 -> 16 -> 8 -> 4 floored at dim/2 = 4, then 3. Outputs 1e-5,
    statistics 1e-6, gradients 1e-5."""
    z, z2 = _x(12, 3, 16), _x(13, 3, 16)
    check_module(jzoo.DCGANGenerator(out_h=32, out_w=16, dim=8),
                 lambda: zoo.DCGANGenerator(16, 32, 16, dim=8), [z],
                 inputs2=[z2], bn=True)


def test_resnet_generator_matches_jax():
    """32x16, dim 4, blocks_per_scale 1: Dense to 2x1x32, 4 scales of 1
    block and an up block, 0 more, the 1x1 conv, tanh(x / 5)."""
    z, z2 = _x(14, 3, 16), _x(15, 3, 16)
    pm = zoo.ResnetGenerator(16, 32, 16, dim=4, blocks_per_scale=1)
    assert pm.n_blocks == 8 and isinstance(
        pm.WGANResidualBlock_1.shortcut, zoo.SubpixelConv)
    check_module(
        jzoo.ResnetGenerator(out_h=32, out_w=16, dim=4, blocks_per_scale=1),
        lambda: zoo.ResnetGenerator(16, 32, 16, dim=4, blocks_per_scale=1),
        [z], inputs2=[z2], bn=True)


def test_resnet_generator_bf16_matches_jax():
    """bfloat16 train-mode images against JAX's bfloat16 ones within JAX's
    own bfloat16-vs-float32 gap, max and mean (`tests/test_torch_bf16.py`);
    the port's images are bfloat16, its params float32."""
    z = _x(16, 3, 16)
    kw = dict(out_h=32, out_w=16, dim=4, blocks_per_scale=1)
    j32 = jzoo.ResnetGenerator(**kw)
    j16 = jzoo.ResnetGenerator(**kw, dtype=jnp.bfloat16)
    variables = jax_variables(j32, [z], bn=True)
    r32, r16 = (np.asarray(jm.apply(variables, z, train=True,
                                    mutable=["batch_stats"])[0], np.float32)
                for jm in (j32, j16))
    pm = load_port(zoo.ResnetGenerator(16, 32, 16, dim=4, blocks_per_scale=1,
                                       dtype=torch.bfloat16), variables)
    with torch.no_grad():
        o16 = pm(_t(z), train=True)
    assert o16.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    gap, diff = np.abs(r16 - r32), np.abs(o16.float().numpy() - r16)
    assert diff.max() <= gap.max() and diff.mean() <= gap.mean(), (
        diff.max(), diff.mean(), gap.max(), gap.mean())


# ------------------------------------------------- plain encoder / decoder

@pytest.mark.parametrize("with_pose", [True, False])
def test_plain_encoder_matches_jax(with_pose):
    """32x16, hidden 4, repeat 3, z 8, ELU; the pose (18 channels)
    concatenated on the channels, or none. Outputs 1e-5, gradients 1e-5
    (params, image and pose)."""
    x, pose = _x(17, 2, 32, 16, 3), _x(18, 2, 32, 16, 18)
    inputs = [x, pose] if with_pose else [x]
    check_module(jenc.PlainEncoder(z_num=8, repeat_num=3, hidden_num=4),
                 lambda: encoders.PlainEncoder(32, 16, 3 + 18 * with_pose,
                                               8, 3, 4), inputs, bn=False)


def test_tile_embedding_matches_jax():
    e = _x(19, 3, 5)
    got = encoders.tile_embedding(_t(e), 4, 2)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jenc.tile_embedding(e, 4, 2)))


def test_plain_decoder_matches_jax():
    """32x16, hidden 4, repeat 3, z 8: Dense to 8x4x12, residual pairs at
    12 / 8 / 4 channels with NN upscales, the last 3x3 conv. Outputs 1e-5,
    gradients 1e-5."""
    z = _x(20, 2, 8)
    check_module(jgen.PlainDecoder(out_h=32, out_w=16, repeat_num=3,
                                   hidden_num=4),
                 lambda: generator.PlainDecoder(8, 32, 16, 3, 3, 4), [z],
                 bn=False)
