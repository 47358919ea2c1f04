"""The three discriminators that `get_discriminator` never returns
(`DCGANDiscriminatorAttr`, `MultiplicativeDCGANDiscriminator`,
`ResnetDiscriminator`, `dpig_tpu/models/discriminators.py:150-244`)
against the JAX package's, in both GAN modes where they have them. CPU,
tiny sizes (32x16, dim 8, `blocks_per_scale` 1; the Attr D on 8x4 maps
of 6 channels). The WGAN-GP critic step is
`tests/test_torch_wgan_gp.py`.

Module parity is `tests/test_torch_zoo.py:check_module` (train-mode
outputs of two chained updating passes and the statistics they leave,
eval mode, gradients of sum(out * W) w.r.t. params and input; outputs
1e-5, statistics 1e-6, gradients 1e-5). The Attr D's three dropout masks
come from one `dropout_rng`, `jax.random.bernoulli(rng, keep, shape)`
per site, as flax's `Dropout(rng=dropout_rng)` draws them, and go to the
port as tensors.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpig_tpu.models import discriminators as jdisc
from dpig_tpu_torch.models import discriminators as disc
from test_torch_zoo import _t, _x, check_module, jax_variables, load_port

torch.set_num_threads(1)

BF16_ULP_AT_1 = 2.0 ** -7
ATTR_IN = (8, 4, 6)


def _attr_masks(keep, batch):
    """flax's three masks: one rng, one bernoulli call per site."""
    pm = disc.DCGANDiscriminatorAttr(*ATTR_IN, dim=8, keep_prob=keep)
    rng = jax.random.PRNGKey(11)
    return rng, [np.asarray(jax.random.bernoulli(rng, keep, s))
                 for s in pm.keep_mask_shapes(batch)]


@pytest.mark.parametrize("mode", ["dcgan", "wgan-gp"])
@pytest.mark.parametrize("keep", [1.0, 0.5])
def test_attr_discriminator_matches_jax(mode, keep):
    """Two 5x5/2 convs, the norm of `mode`, 512 Dense, 27 logits, with the
    three dropouts at keep 0.5 on JAX's masks (each kept element scaled
    by 2, where the masks differ per site)."""
    x, x2 = _x(21, 3, *ATTR_IN), _x(22, 3, *ATTR_IN)
    rng, masks = _attr_masks(keep, 3)
    if keep < 1.0:
        assert 0 < np.mean(masks[2]) < 1 and masks[0].shape != masks[1].shape
    jm = jdisc.DCGANDiscriminatorAttr(dim=8, keep_prob=keep, mode=mode)
    check_module(jm, lambda: disc.DCGANDiscriminatorAttr(
        *ATTR_IN, dim=8, keep_prob=keep, mode=mode), [x], inputs2=[x2],
        bn=mode == "dcgan",
        jax_kw={"dropout_rng": rng} if keep < 1 else None,
        port_kw={"keep_masks": [_t(m) for m in masks]} if keep < 1
        else None)


def test_attr_discriminator_dropout_needs_its_masks():
    """JAX raises without a dropout rng; the port without its masks. Out
    of train mode (or at keep 1) nothing is dropped and none is needed."""
    x = _t(_x(23, 2, *ATTR_IN))
    pm = disc.DCGANDiscriminatorAttr(*ATTR_IN, dim=8, keep_prob=0.5)
    with pytest.raises(ValueError, match="keep_masks"):
        pm(x)
    pm(x, train=False)
    jm = jdisc.DCGANDiscriminatorAttr(dim=8, keep_prob=0.5)
    xj = jnp.asarray(x.numpy())
    with pytest.raises(flax.errors.InvalidRngError, match="dropout"):
        jm.apply(jm.init(jax.random.PRNGKey(0), xj), xj,
                 mutable=["batch_stats"])


@pytest.mark.parametrize("mode", ["dcgan", "wgan-gp"])
def test_multiplicative_discriminator_matches_jax(mode):
    """4 gated stages at 32x16, dim 8: 2 ch channels a conv, gated even /
    odd (a split into halves reads O(1) off), the norm of `mode`."""
    x, x2 = _x(24, 3, 32, 16, 3), _x(25, 3, 32, 16, 3)
    pm = disc.MultiplicativeDCGANDiscriminator(32, 16, dim=8, mode=mode)
    norm = "LayerNorm" if mode == "wgan-gp" else "BatchNorm"
    assert [n for n, _ in pm.named_children()].count(f"{norm}_2") == 1
    check_module(jdisc.MultiplicativeDCGANDiscriminator(dim=8, mode=mode),
                 lambda: disc.MultiplicativeDCGANDiscriminator(
                     32, 16, dim=8, mode=mode), [x], inputs2=[x2],
                 bn=mode == "dcgan")


def test_resnet_discriminator_matches_jax():
    """32x16, dim 8, blocks_per_scale 1: the 1x1 stem to 4, 0 blocks, 4
    down blocks to 64 channels at 2x1, each with one more block, the
    logit / 5."""
    x, x2 = _x(26, 3, 32, 16, 3), _x(27, 3, 32, 16, 3)
    pm = disc.ResnetDiscriminator(32, 16, dim=8, blocks_per_scale=1)
    assert pm.n_blocks == 8 and pm.WGANResidualBlock_0.resample == "down"
    check_module(jdisc.ResnetDiscriminator(dim=8, blocks_per_scale=1),
                 lambda: disc.ResnetDiscriminator(32, 16, dim=8,
                                                  blocks_per_scale=1),
                 [x], inputs2=[x2], bn=True)


def test_resnet_discriminator_bf16_matches_jax():
    """bfloat16 train-mode logits against JAX's bfloat16 ones within JAX's
    own bfloat16-vs-float32 gap plus one bfloat16 ulp of the largest
    logit (a handful of logits rounded at one magnitude, as
    `tests/test_torch_discriminators.py`), max and mean."""
    x = _x(28, 4, 32, 16, 3)
    kw = dict(dim=8, blocks_per_scale=1)
    j32 = jdisc.ResnetDiscriminator(**kw)
    j16 = jdisc.ResnetDiscriminator(**kw, dtype=jnp.bfloat16)
    variables = jax_variables(j32, [x], bn=True)
    r32, r16 = (np.asarray(jm.apply(variables, x, train=True,
                                    mutable=["batch_stats"])[0], np.float32)
                for jm in (j32, j16))
    pm = load_port(disc.ResnetDiscriminator(32, 16, **kw,
                                            dtype=torch.bfloat16), variables)
    with torch.no_grad():
        o16 = pm(_t(x), train=True)
    assert o16.dtype == torch.bfloat16
    gap, diff = np.abs(r16 - r32), np.abs(o16.float().numpy() - r16)
    limit = gap.max() + BF16_ULP_AT_1 * 2.0 ** np.floor(
        np.log2(np.abs(r16).max()))
    assert diff.max() <= limit and diff.mean() <= limit, (
        diff.max(), diff.mean(), gap.max())
