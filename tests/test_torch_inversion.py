"""Embedding inversion (`--inverse_fg/bg/pose`) of the port against the
JAX package's `dpig_tpu.apps.inversion.InversionTool`, on the CPU at the
tiny config: the same params (bridged from JAX's cold start), the same
batch and JAX's own threefry z0 (`r1, r2 = split(key)`, normal * 0.2), the
z and the final loss after 1 step and after 200 (JAX's own test,
tests/test_testers.py:175-187), and after 5 without `invert_bg`; then the
CLI writing `inverted_z.npz`, and 256, where the single-branch code has
no BG part.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpig_tpu.apps.inversion import InversionTool as JaxInversionTool
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.data.synthetic import SyntheticLoader as JaxLoader
from dpig_tpu_torch import main as port_main
from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.apps.inversion import InversionTool
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.data.synthetic import SyntheticLoader

torch.set_num_threads(1)

SMALL = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16)
CPU = torch.device("cpu")
KEY = jax.random.PRNGKey(0)


def _float64(tool):
    """A copy of a port tool whose mappers, targets and z are float64 (the
    encoder's float32 code is cast): what float32 approximates."""
    tool = copy.deepcopy(tool)
    for mapper in tool.mappers.values():
        mapper.double()
        for m in mapper.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
    encode = tool._encode_app
    tool._encode_app = lambda batch: encode(batch).double()
    return tool


@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    """JAX's cold-start tool and the port's on its bridged params, one
    batch, and JAX's z0: its own `invert` at 0 steps returns the start
    it drew, as its jitted graph rounds it (an eager draw differs by an
    ulp)."""
    tmp = str(tmp_path_factory.mktemp("inv"))
    jt = JaxInversionTool(JaxConfig(model_dir=tmp, **SMALL))
    params = jax.tree_util.tree_map(np.array, {
        k: jt.params[k] for k in InversionTool.SUBTREES})
    pt = InversionTool(Config(platform="cpu", model_dir=tmp, **SMALL),
                       params=params_from_flax(params,
                                               InversionTool.SUBTREES))
    batch = next(JaxLoader(4, 32, 16, seed=9))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    zf0, zb0, _ = jt.invert(jb, KEY, steps=0)
    z0 = {"fg": torch.from_numpy(np.array(zf0)),
          "bg": torch.from_numpy(np.array(zb0))}
    return jt, pt, jb, batch_to_device(batch, CPU), z0


def _dist(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("steps,invert_bg,loss_rtol", [
    (1, True, 1e-5), (200, True, 1e-3), (5, False, 1e-5)])
def test_invert_matches_jax(tools, steps, invert_bg, loss_rtol):
    """The final loss within `loss_rtol` of JAX's, and z_fg and z_bg no
    farther from the same inversion run in float64 than JAX's are, up to
    twice that and 1e-6. Adam normalizes each coordinate's gradient, so a
    coordinate whose gradient is near eps (1e-8) moves by what float32
    makes of it, and the run's later gradients carry that: after 1 step
    the float32 runs read 9.1e-5 (port) and 4.9e-4 (JAX) from float64 on
    one coordinate, after 200 steps 0.11 and 0.14, with the losses
    within 1.7e-5 of each other (1.4e-6 after 1 step). Without invert_bg
    (--inverse_fg, --inverse_pose) z_bg comes back as it started on both
    sides. After 200 steps, JAX's own check (tests/test_testers.py:186):
    the loss below half the one-step loss."""
    jt, pt, jb, tb, z0 = tools
    zf_ref, zb_ref, loss_ref = jt.invert(jb, KEY, steps=steps,
                                         invert_bg=invert_bg)
    zf, zb, loss = pt.invert(tb, z0, steps=steps, invert_bg=invert_bg)
    zf64, zb64, _ = _float64(pt).invert(tb, z0, steps=steps,
                                         invert_bg=invert_bg)
    assert zf.shape == (4, 224) and zb.shape == (4, 128)
    for got, ref, exact in ((zf, zf_ref, zf64), (zb, zb_ref, zb64)):
        assert _dist(got, exact) <= 2 * _dist(ref, exact) + 1e-6, (
            _dist(got, exact), _dist(ref, exact))
    np.testing.assert_allclose(float(loss), float(loss_ref),
                               rtol=loss_rtol)
    if not invert_bg:
        assert torch.equal(zb, z0["bg"])
        np.testing.assert_array_equal(np.asarray(zb_ref), z0["bg"].numpy())
    if steps == 200:
        _, _, loss1 = pt.invert(tb, z0, steps=1)
        assert float(loss) < 0.5 * float(loss1)


@pytest.mark.parametrize("flags", [["--inverse_fg=true",
                                    "--inverse_bg=true"],
                                   ["--inverse_pose=true"]],
                         ids=["fg_bg", "pose"])
def test_cli_writes_inverted_z(tmp_path, capsys, flags):
    """The CLI inverts the loader's first batch from z0 drawn from a CPU
    torch.Generator seeded with --random_seed (`draw_noise`), and writes
    z_fg [B, 224] and z_bg [B, 128]; without --inverse_bg the BG code is
    that z0's. The same run through `InversionTool` gives the same z."""
    port_main.main(["--model=11", "--is_train=false", "--platform=cpu",
                    "--synthetic_data=true", f"--model_dir={tmp_path}",
                    "--img_H=32", "--img_W=16", "--batch_size=4",
                    "--conv_hidden_num=16", "--z_num=16", *flags])
    out = np.load(tmp_path / "inverted_z.npz")
    assert out["z_fg"].shape == (4, 224) and out["z_bg"].shape == (4, 128)
    assert "[*] inversion loss" in capsys.readouterr().out
    cfg = Config(platform="cpu", model_dir=str(tmp_path), **SMALL)
    tool = InversionTool(cfg)
    z0 = tool.draw_noise(torch.Generator().manual_seed(cfg.random_seed), 4)
    invert_bg = "--inverse_bg=true" in flags
    zf, zb, _ = tool.invert(batch_to_device(next(SyntheticLoader(
        4, 32, 16, seed=cfg.random_seed)), CPU), z0, invert_bg=invert_bg)
    np.testing.assert_array_equal(out["z_fg"], zf.numpy())
    np.testing.assert_array_equal(out["z_bg"], zb.numpy())
    if not invert_bg:
        np.testing.assert_array_equal(out["z_bg"], z0["bg"].numpy())


def test_inverse_bg_at_256_raises(tmp_path):
    """At 256 the single-branch encoder's 224-d code has no BG part: the
    FG mapper inverts it, and invert_bg raises ValueError (the JAX package
    raises a TypeError there, broadcasting the BG mapper's [B, 128]
    against an empty [B, 0] target)."""
    cfg = Config(platform="cpu", model_dir=str(tmp_path), img_H=256,
                 img_W=256, batch_size=2, conv_hidden_num=4, z_num=4)
    tool = InversionTool(cfg)
    batch = batch_to_device(next(SyntheticLoader(2, 256, 256, seed=9)), CPU)
    z0 = tool.draw_noise(torch.Generator().manual_seed(0), 2)
    with pytest.raises(ValueError, match="no BG part"):
        tool.invert(batch, z0, steps=2)
    zf, zb, loss = tool.invert(batch, z0, steps=2, invert_bg=False)
    assert zf.shape == (2, 224) and torch.equal(zb, z0["bg"])
    assert np.isfinite(float(loss))
