"""Part dropout (`keep_part_prob < 1`) in the port's ROI encoders against
the JAX package's (`dpig_tpu/models/encoders.py:62-80`,
`ops/ste.py:bernoulli_sample`): the JAX side draws its uniforms from its
rng, the port is given the same uniforms as a tensor
(`jax.random.uniform(rng, (P, B, 1))`, what JAX's `bernoulli_sample`
draws). At keep_part_prob 0.5 the FG/BG and the single-branch encoder give
the same outputs, parts dropped, and the same parameter gradients
(straight-through) within 1e-4 of the largest; `bernoulli_sample` itself
gives the same {0,1} samples and an identity gradient. Without the
uniforms, as without JAX's rng, nothing is dropped."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpig_tpu.models.encoders import RoiEncoder as JaxRoiEncoder
from dpig_tpu.models.encoders import RoiEncoderFgBg as JaxRoiEncoderFgBg
from dpig_tpu.ops.ste import bernoulli_sample as jax_bernoulli
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.models.encoders import RoiEncoder, RoiEncoderFgBg
from dpig_tpu_torch.ops.ste import bernoulli_sample, uniform_noise

torch.set_num_threads(1)

TOL = 1e-4
B, P, Z, H, W = 2, 7, 8, 32, 16
KW = dict(part_num=P, z_num=Z, repeat_num=2, hidden_num=8, roi_size=8)


def _inputs(rng):
    x = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    mask = (rng.uniform(size=(B, H, W, 1)) > 0.3).astype(np.float32)
    y0 = rng.integers(0, H - 8, (B, P, 1))
    x0 = rng.integers(0, W - 6, (B, P, 1))
    bbox = np.concatenate([y0, x0, y0 + 8, x0 + 6], -1).astype(np.int32)
    vis = np.ones((B, P), np.float32)
    vis[0, 2] = 0.0
    return x, mask, bbox, vis


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("fg_bg", [True, False], ids=["fgbg", "single"])
def test_encoder_dropout_matches_jax(fg_bg):
    rng = np.random.default_rng(11)
    x, mask, bbox, vis = _inputs(rng)
    key = jax.random.PRNGKey(5)
    if fg_bg:
        jenc = JaxRoiEncoderFgBg(keep_part_prob=0.5, **KW)
        args = (x, mask, bbox, vis)
        enc = RoiEncoderFgBg(H, W, keep_part_prob=0.5, **KW)
    else:
        jenc = JaxRoiEncoder(keep_part_prob=0.5, **KW)
        args = (x, bbox, vis)
        enc = RoiEncoder(keep_part_prob=0.5, **KW)
    params = jax.tree_util.tree_map(np.asarray, jenc.init(
        jax.random.PRNGKey(0), *args)["params"])
    enc.load_state_dict(params_from_flax({"E": params}, ["E"])["E"])
    noise = _t(jax.random.uniform(key, (P, B, 1), jnp.float32))
    cot = rng.normal(size=(B, P * Z + (4 * Z if fg_bg else 0))).astype(
        np.float32)

    def jax_loss(p):
        out = jenc.apply({"params": p}, *args, rng=key)
        return jnp.sum(out * cot), out

    (_, ref), grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    out = enc(*map(_t, args), part_noise=noise)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=TOL, rtol=0)
    fg = out[:, :P * Z].reshape(B, P, Z).detach()
    dropped = (noise[:, :, 0].t() >= 0.5) & (_t(vis) > 0)
    assert bool(dropped.any()) and bool((~dropped & (_t(vis) > 0)).any())
    assert bool((fg[dropped] == 0).all())
    assert bool((fg[~dropped & (_t(vis) > 0)].abs().sum(-1) > 0).all())
    want = params_from_flax({"E": jax.tree_util.tree_map(np.asarray, grads)},
                            ["E"])["E"]
    got = dict(zip([n for n, _ in enc.named_parameters()], torch.autograd.grad(
        (out * _t(cot)).sum(), list(enc.parameters()))))
    scale = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        assert float((got[n] - g).abs().max()) <= TOL * scale, n
    kept = enc(*map(_t, args))                     # no uniforms: no dropout
    full = jenc.apply({"params": params}, *args)    # no rng: no dropout
    np.testing.assert_allclose(kept.detach().numpy(), np.asarray(full),
                               atol=TOL, rtol=0)


def test_bernoulli_sample_and_its_straight_through_gradient():
    rng = np.random.default_rng(3)
    probs = rng.uniform(0, 1, (5, 6, 1)).astype(np.float32)
    w = rng.normal(size=probs.shape).astype(np.float32)
    key = jax.random.PRNGKey(9)
    u = jax.random.uniform(key, probs.shape, jnp.float32)
    ref, jgrad = jax.value_and_grad(
        lambda p: jnp.sum(jax_bernoulli(p, key) * w))(jnp.asarray(probs))
    x = _t(probs).requires_grad_(True)
    sample = bernoulli_sample(x, _t(u))
    assert set(np.unique(sample.detach().numpy())) <= {0.0, 1.0}
    np.testing.assert_array_equal(
        sample.detach().numpy(),
        np.asarray(jax_bernoulli(jnp.asarray(probs), key)))
    (grad,) = torch.autograd.grad((sample * _t(w)).sum(), x)
    np.testing.assert_array_equal(grad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(grad.numpy(), w)
    total = float((sample.detach() * _t(w)).sum())
    assert total == pytest.approx(float(ref), rel=1e-6)


def test_uniform_noise_is_the_generators():
    a = uniform_noise(torch.Generator().manual_seed(2), (P, B, 1),
                      torch.device("cpu"))
    b = torch.rand((P, B, 1), generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and a.dtype == torch.float32
