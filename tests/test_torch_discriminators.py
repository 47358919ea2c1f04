"""The `--D_arch` image discriminators of the port against the JAX
package's (`dpig_tpu/models/discriminators.py:23-147`): DCGANRegion,
Patch and FCDis, and DCGAN through the same selector, the image Ds in
both GAN modes ('dcgan': BatchNorm; 'wgan-gp': flax's LayerNorm over
the channels).

Each module on bridged flax params (its submodule names are flax's, so
`bridge.params_from_flax` loads it strictly): the train-mode outputs of
two chained updating passes (the D step's real then fake pass) and the
running statistics they leave, the eval-mode output, and the gradients of
the D objective (params) and of the G objective (the image), in float32;
the bfloat16 outputs within JAX's own bfloat16-vs-float32 gap; the
selector's names and errors; `layers._NativeConv2d`, the DCGAN D's conv
on the card, against F.conv2d and numerical first and second
derivatives. The Stage-I step with each arch is in
`tests/test_torch_d_arch_train.py`; the WGAN-GP critic step in
`tests/test_torch_wgan_gp.py`.

The Patch D needs 2^(n_layers+1) = 16 px per side, and at 16 to 23 px its
logit map is empty (JAX returns a [B, 2, 0] map at 32x16, so NaN losses):
its cases run at 64x32.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpig_tpu.data.synthetic import synthetic_batch
from dpig_tpu.losses import gan as jgan
from dpig_tpu.models import discriminators as jdisc
from dpig_tpu_torch.apps.stage1_app import Stage1App
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.losses import gan
from dpig_tpu_torch.models import discriminators as disc

torch.set_num_threads(1)

CPU = torch.device("cpu")
SIZES = {"DCGAN": (32, 16), "DCGANRegion": (32, 16), "Patch": (64, 32),
         "FCDis": (32, 16)}
CLASSES = {"DCGAN": disc.DCGANDiscriminator,
           "DCGANRegion": disc.RegionDiscriminator,
           "Patch": disc.PatchDiscriminator, "FCDis": disc.FCDiscriminator}
LR = Config().g_lr
BF16_ULP_AT_1 = 2.0 ** -7
IMAGE_DS = ("DCGAN", "DCGANRegion", "Patch")


def _modes(archs):
    """(arch, mode) cases: each arch in 'dcgan' under its old id, each
    image D also in 'wgan-gp'."""
    return ([pytest.param(a, "dcgan", id=a) for a in archs]
            + [pytest.param(a, "wgan-gp", id=f"{a}-wgan-gp")
               for a in archs if a in IMAGE_DS])


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _pair(arch, dtype=jnp.float32, mode="dcgan"):
    """A JAX D with fresh variables, and the port's on the same params,
    running statistics moved off (0, 1) so that eval mode reads them (in
    'wgan-gp' the LayerNorms' scales and biases instead, which have no
    statistics)."""
    h, w = SIZES[arch]
    jd = jdisc.get_discriminator(arch, mode=mode, dtype=dtype)
    variables = _np(jd.init(jax.random.PRNGKey(1), jnp.zeros((2, h, w, 3)),
                            train=True))
    rng = np.random.default_rng(2)
    stats = jax.tree_util.tree_map(
        lambda v: v + rng.uniform(0.1, 0.5, v.shape).astype(np.float32),
        variables.get("batch_stats", {}))
    params = variables["params"]
    if mode == "wgan-gp":
        # seed 3: with seed 2 one LeakyReLU input of the Patch D's fake
        # pass lies at 9.0e-7 in float64 and below 0 in the port's
        # float32 (JAX's float32 lands above), so that one slope puts the
        # port's D gradients 8e-4 from float64 (a float32 kink, as
        # tests/test_torch_df256.py's seed 5; every activation and its
        # gradient before that element read within 2.5e-6)
        rng = np.random.default_rng(3)
        params = {k: ({n: a + rng.uniform(-0.2, 0.2, a.shape).astype(
            np.float32) for n, a in v.items()} if k.startswith("LayerNorm")
            else v) for k, v in params.items()}
    state = params_from_flax({"D": params, "D_stats": stats},
                             ["D", "D_stats"])
    pd = disc.get_discriminator(
        arch, h, w, mode=mode, dtype=torch.bfloat16 if dtype == jnp.bfloat16
        else torch.float32)
    pd.load_state_dict({**state["D"], **state["D_stats"]}, strict=True)
    return jd, {"params": params, "batch_stats": stats}, pd


def _images(arch, seed):
    h, w = SIZES[arch]
    b = synthetic_batch(np.random.default_rng(seed), 4, h, w)
    return b["x"], b["x_target"]


def _bridge_d(grads):
    return params_from_flax({"D": grads}, ["D"])["D"]


def _d_grads(pd, real, fake, dtype=torch.float32):
    """Gradients of the D objective (the real pass, then the fake pass from
    the statistics it left) of a copy of the port's D `pd`, parameters and
    compute dtype in `dtype`, as float32."""
    pd = copy.deepcopy(pd).to(dtype)
    for m in pd.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dtype
    pd.requires_grad_(True)
    loss = gan.d_loss("dcgan", pd(_t(real).to(dtype), update_stats=True),
                      pd(_t(fake).to(dtype), update_stats=True))
    grads = torch.autograd.grad(loss, list(pd.parameters()))
    return {n: g.float() for (n, _), g in zip(pd.named_parameters(), grads)}


def _grad_errors(got, want):
    """(||diff|| / ||grad|| over the D, the largest max|diff| of a tensor
    over the D's largest |grad|)."""
    diff = {k: got[k].double() - v.double() for k, v in want.items()}
    norm = sum(float((d * d).sum()) for d in diff.values()) / sum(
        float((v.double() ** 2).sum()) for v in want.values())
    return norm ** 0.5, max(float(d.abs().max()) for d in diff.values()) / \
        max(float(v.abs().max()) for v in want.values())


def _check_d_grads(pd, real, fake, port, jax_grads):
    """Both `_grad_errors` readings, against the port's D in float64 on the
    same inputs: JAX's float32 gradients within 5e-3 of it (the two
    compute one function; a wiring fault reads O(1e-1)), and the port's
    float32 ones at most 4x as far as JAX's, or 1e-5. Where real and fake
    score alike the D objective's gradient is a small difference of large
    sums, and float32 resolves it poorly on both sides. Readings (port,
    JAX): DCGAN, DCGANRegion, Patch modules and the DCGANRegion step
    1.0e-6 to 3.1e-6 and 5.9e-7 to 1.2e-6; FCDis module 2.4e-5 / 1.1e-4
    and 2.7e-4 / 7.2e-4; FCDis step 4.2e-7 / 7.9e-7 and 7.3e-5 / 3.2e-4;
    Patch step 9.1e-4 / 2.1e-3 and 3.4e-4 / 1.5e-3."""
    f64 = _d_grads(pd, real, fake, torch.float64)
    gap = _grad_errors(jax_grads, f64)
    own = _grad_errors(port, f64)
    assert max(gap) <= 5e-3, gap
    assert all(o <= max(1e-5, 4 * g) for o, g in zip(own, gap)), (own, gap)


@pytest.mark.parametrize("arch,mode", _modes(list(SIZES)))
def test_discriminator_matches_jax(arch, mode):
    """float32. Outputs within 1e-5 absolute and relative (sums of up to
    4x4x512 products in other orders); running statistics within 1e-6
    ('wgan-gp' has none, and builds a LayerNorm wherever 'dcgan' builds a
    BatchNorm); the D objective's parameter gradients as
    `_check_d_grads`; the G objective's gradient w.r.t. the image within
    1e-4 of its largest."""
    jd, variables, pd = _pair(arch, mode=mode)
    if mode == "wgan-gp":
        names = [n for n, _ in pd.named_children()]
        assert not any(n.startswith("BatchNorm") for n in names)
        assert "LayerNorm_0" in names and not list(pd.buffers())
    real, fake = _images(arch, 3)
    assert type(pd) is CLASSES[arch]

    def japply(params, stats, img, train=True):
        out, new = jd.apply({"params": params, "batch_stats": stats}, img,
                            train=train, mutable=["batch_stats"])
        return out, new.get("batch_stats", {})

    j_real, stats1 = japply(variables["params"], variables["batch_stats"],
                            real)
    j_fake, stats2 = japply(variables["params"], stats1, fake)
    p_real = pd(_t(real), train=True, update_stats=True)
    p_fake = pd(_t(fake), train=True, update_stats=True)
    assert p_real.shape == j_real.shape and p_fake.shape == j_fake.shape
    for p, j in ((p_real, j_real), (p_fake, j_fake)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                   atol=1e-5, rtol=1e-5)
    want = params_from_flax({"D_stats": _np(stats2)},
                            ["D_stats"])["D_stats"]
    got = {k: v for k, v in pd.state_dict().items() if k in want}
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=1e-6)

    j_eval, _ = japply(variables["params"], stats2, real, train=False)
    p_eval = pd(_t(real), train=False)
    if mode == "wgan-gp":
        # no statistics: eval mode is the train-mode function, held to
        # the train-mode limit above
        assert torch.equal(p_eval, p_real)
    np.testing.assert_allclose(p_eval.detach().numpy(), np.asarray(j_eval),
                               atol=1e-5, rtol=1e-5 if mode == "wgan-gp"
                               else 0)

    # D objective (params, chained statistics) and G objective (image)
    def d_obj(params):
        d_real, s1 = japply(params, variables["batch_stats"], real)
        return jgan.d_loss("dcgan", d_real, japply(params, s1, fake)[0])

    d_ref = _bridge_d(jax.jit(jax.grad(d_obj))(variables["params"]))
    _, _, pd = _pair(arch, mode=mode)  # the statistics as they were
    img_ref = jax.jit(jax.grad(lambda img: jgan.g_loss("dcgan", japply(
        variables["params"], variables["batch_stats"], img)[0])))(
        jnp.asarray(fake))
    _check_d_grads(pd, real, fake, _d_grads(pd, real, fake), d_ref)
    img = _t(fake).requires_grad_(True)
    (g_img,) = torch.autograd.grad(gan.g_loss("dcgan", pd(img)), img)
    ref = np.asarray(img_ref)
    assert np.abs(g_img.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("arch,mode", _modes(["DCGANRegion", "Patch",
                                              "FCDis"]))
def test_discriminator_bf16_matches_jax(arch, mode):
    """bfloat16 train-mode logits against JAX's bfloat16 ones, within JAX's
    own bfloat16-vs-float32 gap plus one bfloat16 ulp at the largest
    logit (a tie that rounds the other way is a whole ulp; see
    tests/test_torch_bf16.py), max and mean; the port's logits are
    bfloat16."""
    j32, variables, _ = _pair(arch, mode=mode)
    j16, _, p16 = _pair(arch, jnp.bfloat16, mode)
    real, _ = _images(arch, 4)
    r32, r16 = (np.asarray(jd.apply(variables, real, train=True,
                                    mutable=["batch_stats"])[0], np.float32)
                for jd in (j32, j16))
    with torch.no_grad():
        o16 = p16(_t(real), train=True)
    assert o16.dtype == torch.bfloat16
    gap, diff = np.abs(r16 - r32), np.abs(o16.float().numpy() - r16)
    limit = gap.max() + BF16_ULP_AT_1 * 2.0 ** np.floor(
        np.log2(np.abs(r16).max()))
    assert diff.max() <= limit and diff.mean() <= limit, (
        diff.max(), diff.mean(), gap.max())


def test_selector_names_and_errors():
    """The names get_discriminator takes (prefixes for Region and Patch),
    its error for any other, the 'wgan-gp' mode building the LayerNorm
    variant of each image D as JAX does (`LayerNorm_i` where 'dcgan' has
    `BatchNorm_i`, no running statistics; FCDis alike in both modes),
    Stage I's D at 256x256 (n_stages 5 reaches DCGAN only), and the Patch
    D's input checks: JAX's ValueError below 16 px, and a ValueError where
    JAX returns an empty map (16 to 23 px per side)."""
    for arch, cls in (("DCGANRegion", disc.RegionDiscriminator),
                      ("DCGANRegion_v2", disc.RegionDiscriminator),
                      ("PatchGAN", disc.PatchDiscriminator),
                      ("FCDis", disc.FCDiscriminator),
                      ("DCGAN", disc.DCGANDiscriminator)):
        assert type(disc.get_discriminator(arch, 32, 16)) is cls
        assert type(jdisc.get_discriminator(arch)).__name__ == cls.__name__
    for fn in (lambda: jdisc.get_discriminator("WGAN"),
               lambda: disc.get_discriminator("WGAN", 32, 16)):
        with pytest.raises(ValueError, match="You must choose an arch"):
            fn()
    for arch, cls in CLASSES.items():
        h, w = SIZES[arch]
        pd = disc.get_discriminator(arch, h, w, mode="wgan-gp")
        jd = jdisc.get_discriminator(arch, mode="wgan-gp")
        assert type(pd) is cls and getattr(jd, "mode", "wgan-gp") == "wgan-gp"
        names = {n.split(".")[0] for n in pd.state_dict()}
        jnames = set(jd.init(jax.random.PRNGKey(0),
                             jnp.zeros((2, h, w, 3)))["params"])
        assert names == jnames and not list(pd.buffers())
        assert not any(n.startswith("BatchNorm") for n in names)
        assert (arch == "FCDis") != any(n.startswith("LayerNorm")
                                         for n in names)
    for arch, cls in CLASSES.items():
        app = Stage1App(Config(platform="cpu", img_H=256, img_W=256,
                               conv_hidden_num=4, z_num=4, D_arch=arch),
                        CPU, fg_bg=False)
        assert type(app.disc) is cls
    assert app.disc.input.in_features == 3
    assert disc.get_discriminator("DCGAN", 256, 256,
                                  n_stages=5).n_stages == 5
    pd = disc.PatchDiscriminator()
    jd = jdisc.PatchDiscriminator()
    small = np.zeros((2, 15, 64, 3), np.float32)
    with pytest.raises(ValueError, match="needs inputs >= 16px"):
        jd.init(jax.random.PRNGKey(0), jnp.asarray(small))
    with pytest.raises(ValueError, match="needs inputs >= 16px"):
        pd(_t(small))
    x = np.zeros((2, 32, 16, 3), np.float32)
    out, _ = jd.apply(jd.init(jax.random.PRNGKey(0), jnp.asarray(x)), x,
                      mutable=["batch_stats"])
    assert out.shape == (2, 2, 0)
    with pytest.raises(ValueError, match="empty logit map"):
        pd(_t(x))


@pytest.mark.parametrize("stride,padding,bias", [(2, (0, 0), True),
                                                 (2, (1, 2), True),
                                                 (1, (2, 2), False)])
def test_native_conv_function_is_the_conv_and_its_gradient(stride, padding,
                                                           bias):
    """`layers._NativeConv2d`, the DCGAN D's conv on the card (PyTorch's own
    kernels forward and backward, its backward `_NativeConv2dGrad`
    calling `aten.convolution_backward` itself, and differentiable again
    through both, for the gradient penalty): here on the CPU in float64,
    the value of F.conv2d and the first and second derivatives autograd
    checks numerically, for each input that needs one; under no_grad it
    records nothing."""
    from dpig_tpu_torch.models.layers import _NativeConv2d
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 4, 11, 8, generator=g, dtype=torch.float64)
    w = torch.randn(6, 4, 5, 5, generator=g, dtype=torch.float64)
    b = torch.randn(6, generator=g, dtype=torch.float64) if bias else None
    args = [t.requires_grad_(True) for t in (x, w, b) if t is not None]

    def conv(x, w, b=None):
        return _NativeConv2d.apply(x, w, b, stride, padding)

    torch.testing.assert_close(conv(*args), torch.nn.functional.conv2d(
        *args, stride=stride, padding=padding), rtol=0, atol=1e-12)
    assert torch.autograd.gradcheck(conv, tuple(args))
    assert torch.autograd.gradgradcheck(conv, tuple(args))
    assert torch.autograd.gradcheck(
        lambda w: conv(x.detach(), w), (w,))  # the D's first conv
    with torch.no_grad():
        assert not conv(*args).requires_grad
