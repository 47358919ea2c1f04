"""The WGAN-GP critic step (`losses/gan.py:d_loss("wgan-gp", ...)`, the
gradient penalty's double backward through the D) of the 'wgan-gp'
DCGAN, Region and Patch Ds (LayerNorm in place of BatchNorm) and of
`ResnetDiscriminator` (its BatchNorms in train mode) against
`dpig_tpu.losses.gan.d_loss` on the same alpha, on the CPU at 32x16 (the
Patch D at 64x32, where its logit map is not empty), batch 4, dim 8 for
the Resnet D. The DCGAN D's convs on the card run
`layers._NativeConv2d`, whose double backward
`tests/test_torch_discriminators.py` checks numerically.
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
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.losses import gan
from dpig_tpu_torch.models import discriminators as disc
from test_torch_zoo import _grad_errors, _np, _t, jax_variables, load_port

torch.set_num_threads(1)

GP_CASES = {
    "DCGAN": (32, 16, lambda: jdisc.get_discriminator(
        "DCGAN", mode="wgan-gp"), lambda: disc.get_discriminator(
        "DCGAN", 32, 16, mode="wgan-gp")),
    "DCGANRegion": (32, 16, lambda: jdisc.get_discriminator(
        "DCGANRegion", mode="wgan-gp"), lambda: disc.get_discriminator(
        "DCGANRegion", 32, 16, mode="wgan-gp")),
    "Patch": (64, 32, lambda: jdisc.get_discriminator(
        "Patch", mode="wgan-gp"), lambda: disc.get_discriminator(
        "Patch", 64, 32, mode="wgan-gp")),
    "Resnet": (32, 16, lambda: jdisc.ResnetDiscriminator(
        dim=8, blocks_per_scale=1), lambda: disc.ResnetDiscriminator(
        32, 16, dim=8, blocks_per_scale=1)),
}


def critic_step(pd, real, fake, alpha):
    """The port's WGAN-GP D loss and its parameter gradients (the penalty's
    double backward through the D)."""
    loss = gan.d_loss("wgan-gp", pd(real), pd(fake), critic_fn=pd,
                      real_data=real, fake_data=fake, alpha=alpha)
    grads = torch.autograd.grad(loss, list(pd.parameters()))
    return loss.detach(), dict(zip([n for n, _ in pd.named_parameters()],
                                   grads))


def _float64(pd):
    p64 = copy.deepcopy(pd).double()
    for m in p64.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    return p64


@pytest.mark.parametrize("arch", list(GP_CASES))
def test_wgan_gp_critic_step_matches_jax(arch):
    """`d_loss("wgan-gp")` of the 'wgan-gp' D (LayerNorm; the Resnet D with
    its BatchNorms in train mode, as JAX's critic with mutable
    statistics) on real and fake images, alpha JAX's own draw
    (`jax.random.uniform(rng, (B, 1, 1, 1))`, as its gradient_penalty
    makes it) given to the port as a tensor. The loss within 5e-5 of
    JAX's, relative. The parameter gradients (||diff|| / ||grad||,
    max|diff| / max|grad|) against the port's step in float64, as
    `tests/test_torch_discriminators.py:_check_d_grads`: JAX's float32
    within 5e-3 of it (one function; a wiring fault reads O(1e-1)), the
    port's at most 4x as far as JAX's, or 1e-5. Readings (port, JAX):
    the loss 0 to 5.3e-6 off; DCGAN, Region and Patch gradients 4.1e-7 to
    1.9e-6 and 3.9e-7 to 4.9e-7; the Resnet D 4.2e-5 and 4.2e-4 (JAX's
    float32 double backward through its BatchNorms is the one far
    from float64)."""
    h, w, make_j, make_p = GP_CASES[arch]
    b = synthetic_batch(np.random.default_rng(29), 4, h, w)
    real, fake = b["x"], b["x_target"]
    jd = make_j()
    bn = arch == "Resnet"
    variables = jax_variables(jd, [real], bn=bn)
    rng = jax.random.PRNGKey(5)
    alpha = np.asarray(jax.random.uniform(rng, (4, 1, 1, 1)))

    def critic(params, x):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        if bn:
            return jd.apply(v, x, train=True, mutable=["batch_stats"])[0]
        return jd.apply({"params": params}, x, train=True)

    def j_loss(params):
        return jgan.d_loss("wgan-gp", critic(params, real),
                           critic(params, fake),
                           critic_fn=lambda x: critic(params, x),
                           real_data=jnp.asarray(real),
                           fake_data=jnp.asarray(fake), rng=rng)

    j_val, j_grads = jax.jit(jax.value_and_grad(j_loss))(
        variables["params"])
    pd = load_port(make_p(), variables)
    assert bn == any("BatchNorm" in n for n, _ in pd.named_modules())
    loss, grads = critic_step(pd, _t(real), _t(fake), _t(alpha))
    assert abs(float(loss) - float(j_val)) <= 5e-5 * abs(float(j_val))
    _, g64 = critic_step(_float64(pd), _t(real).double(), _t(fake).double(),
                         _t(alpha).double())
    want = params_from_flax({"G": _np(j_grads)}, ["G"])["G"]
    assert set(want) == set(grads) == set(g64)
    gap = _grad_errors(list(want.values()), [g64[k] for k in want])
    own = _grad_errors([grads[k] for k in want], [g64[k] for k in want])
    assert max(gap) <= 5e-3, gap
    assert all(o <= max(1e-5, 4 * g) for o, g in zip(own, gap)), (own, gap)
