"""One Stage-I (model 1) train step with each `--D_arch` of the port
against the JAX package's jitted step, and `--D_arch` through the CLI.

The step is held to the limits of `tests/test_torch_train.py`, its D
gradients as `test_torch_discriminators._check_d_grads` holds a D's. The
Patch D runs at 64x32 (at 32x16 its logit map is empty:
`tests/test_torch_discriminators.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpig_tpu.apps.stage1_app import Stage1App as JaxStage1App
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.data.synthetic import SyntheticLoader as JaxLoader
from dpig_tpu.losses import gan as jgan
from dpig_tpu_torch import main as port_main
from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.apps.stage1_app import Stage1App
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.models import discriminators as disc
from dpig_tpu_torch.train.parity import recorded_train_step
from test_torch_discriminators import (CLASSES, CPU, LR, SIZES, _bridge_d,
                                       _check_d_grads, _np)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["DCGANRegion", "Patch", "FCDis"])
def jax_step(request):
    """JAX's jitted model-1 step with `D_arch`, from its own fresh state
    (copied to numpy first: the step donates it), on one batch."""
    arch = request.param
    h, w = SIZES[arch]
    small = dict(img_H=h, img_W=w, batch_size=4, conv_hidden_num=16,
                 z_num=16, D_arch=arch)
    japp = JaxStage1App(JaxConfig(**small))
    st = japp.init_state(jax.random.PRNGKey(3))
    init = _np({"g": st.g_params, "d": st.d_params, "s": st.d_stats})
    batch = next(JaxLoader(4, h, w, seed=3))
    new_state, metrics = japp.train_step(
        st, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    new = _np({"g": new_state.g_params, "d": new_state.d_params,
               "s": new_state.d_stats})
    return (arch, small, japp, init, batch, new,
            {k: float(v) for k, v in metrics.items()})


def _state(g, d, s):
    return params_from_flax({"Encoder": g["Encoder"], "ID_AE": g["ID_AE"],
                             "Discriminator": d["Discriminator"],
                             "Discriminator_stats": s})


def test_stage1_step_matches_jax(jax_step):
    """One model-1 step (re-forward D step) with each `--D_arch`, against
    JAX's jitted step from the same params and batch. The port's D step
    starts from JAX's updated G (`g_updated`; Adam's first step is
    sign-like, tests/test_torch_train.py). The five metrics within rtol
    1e-5; the updated G and the updated D within Adam's 2 lr, at most 0.1%
    of the elements more than lr/100 apart; the running statistics within
    2e-5. The D's gradients against jax.grad of JAX's D objective (jitted) on
    the port's own fakes, as `_check_d_grads` (on the fakes of the updated
    G, JAX's own float32 error reads up to ~1e-3 for Patch)."""
    arch, small, japp, init, batch, new, metrics = jax_step
    ref = _state(new["g"], new["d"], new["s"])
    cfg = Config(platform="cpu", **small)
    app = Stage1App(cfg, CPU, state=_state(init["g"], init["d"], init["s"]))
    assert type(app.disc) is CLASSES[arch]
    g_updated = {f"{s}/{k}": v for s in ("Encoder", "ID_AE")
                 for k, v in ref[s].items()}
    rec = recorded_train_step(app, batch, g_updated=g_updated)
    for k, v in metrics.items():
        np.testing.assert_allclose(rec.metrics[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    updated = {"Discriminator": app.disc.state_dict(),
               **{s: {k: rec.g_updated[f"{s}/{k}"] for k in ref[s]}
                  for s in ("Encoder", "ID_AE")}}
    for sub, got in updated.items():
        diffs = torch.cat([(got[k] - v).abs().reshape(-1)
                           for k, v in ref[sub].items()])
        assert float(diffs.max()) <= 2 * LR + 1e-6, sub
        assert float((diffs > LR / 100).float().mean()) <= 1e-3, sub
    for k, v in ref["Discriminator_stats"].items():
        torch.testing.assert_close(rec.d_stats[f"Discriminator/{k}"], v,
                                   rtol=0, atol=2e-5)

    # the port's fakes: its generator at JAX's updated G, as its D step saw
    synced = Stage1App(cfg, CPU, state=_state(new["g"], init["d"],
                                              init["s"]))
    tb = batch_to_device(batch, CPU)
    x, pose, mask, bbox, vis = synced.step_inputs(tb)
    with torch.no_grad():
        fake = synced.g_forward(x, pose, mask, bbox, vis)[0].numpy()

    def d_obj(d_params):
        d_real, s1 = japp._disc_apply(d_params, init["s"], batch["x"])
        return jgan.d_loss("dcgan", d_real,
                           japp._disc_apply(d_params, s1, fake)[0])

    want = _bridge_d(jax.jit(jax.grad(d_obj))(init["d"])["Discriminator"])
    _check_d_grads(synced.disc, batch["x"], fake,
                   {k: rec.grads[f"Discriminator/{k}"] for k in want}, want)


@pytest.mark.parametrize("arch,dtype", [("DCGANRegion", "bfloat16"),
                                        ("Patch", "float32"),
                                        ("FCDis", "bfloat16")])
def test_cli_trains_model_1_with_each_d_arch(tmp_path, arch, dtype):
    """`--D_arch` through the CLI at the tiny config (Patch at 64x32),
    float32 and bfloat16: two steps, finite metrics, a checkpoint whose D
    is that arch's."""
    import json
    h, w = SIZES[arch]
    port_main.main([
        "--model=1", "--platform=cpu", "--synthetic_data=true",
        "--max_step=2", "--log_step=1", f"--model_dir={tmp_path}",
        f"--img_H={h}", f"--img_W={w}", "--batch_size=4",
        "--conv_hidden_num=16", "--z_num=16", f"--D_arch={arch}",
        f"--compute_dtype={dtype}"])
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    state = torch.load(tmp_path / "ckpt" / "step_00000002" / "state.pt",
                       map_location="cpu", weights_only=True)
    want = disc.get_discriminator(arch, h, w).state_dict()
    assert set(state["d_params"]["Discriminator"]) == {
        n for n in want if "running" not in n}
