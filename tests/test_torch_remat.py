"""`--remat` in the port (`torch.utils.checkpoint` around the encoder and
the generator forwards of the Stage-I train step; JAX: `nn.remat` on both,
`dpig_tpu/apps/stage1_app.py:52-58`).

On the CPU a remat step equals the plain step bit for bit: neither net has
BatchNorm or dropout, the recomputed forward runs the same kernels on the
same inputs, and the ROI crop's gathers recompute as they ran. The pose
maps are rendered once, before the encoder, and enter the generator as an
input that the checkpoint saves. Then the port's remat step against the
JAX package's jitted remat step, held to the limits of
`tests/test_torch_train.py`, and `--remat` through the CLI.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpig_tpu.apps.stage1_app import Stage1App as JaxStage1App
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.data.synthetic import SyntheticLoader as JaxLoader
from dpig_tpu_torch import main as port_main
from dpig_tpu_torch.apps.stage1_app import Stage1App
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.data.synthetic import SyntheticLoader
from dpig_tpu_torch.train.parity import recorded_train_step
from test_torch_train import (CPU, LR, METRICS, SMALL, SUBNETS, _bridge,
                              _np_tree)

torch.set_num_threads(1)


def _counting(app):
    """Forward calls of the encoder and the generator modules (counted on
    entry: the recompute stops once it has what the backward needs)."""
    calls = {"encoder": 0, "generator": 0}
    for name in calls:
        getattr(app, name).register_forward_pre_hook(
            lambda *_, name=name: calls.__setitem__(name, calls[name] + 1))
    return calls


@pytest.mark.parametrize("fg_bg", [True, False], ids=["model1", "model101"])
def test_remat_step_equals_the_plain_step(tmp_path, fg_bg):
    """The same step with and without --remat (model 1's FG/BG encoder;
    model 101's single-branch one, at 32x16): metrics, every gradient, the
    G after its update, the D's statistics and the params after the step
    all bit-equal. With remat the G step runs each net's forward twice
    (once more in the backward pass), the re-forward of the D step once:
    3 calls each, against 2."""
    batch = next(SyntheticLoader(4, 32, 16, seed=6))
    recs, calls = {}, {}
    for remat in (False, True):
        app = Stage1App(Config(platform="cpu", remat=remat,
                               model_dir=str(tmp_path), **SMALL), CPU,
                        fg_bg=fg_bg)
        calls[remat] = _counting(app)
        recs[remat] = recorded_train_step(app, batch)
    assert calls == {False: {"encoder": 2, "generator": 2},
                     True: {"encoder": 3, "generator": 3}}
    plain, remat = recs[False], recs[True]
    assert plain.metrics == remat.metrics
    for got, want in ((remat.grads, plain.grads),
                      (remat.g_updated, plain.g_updated),
                      (remat.d_stats, plain.d_stats)):
        assert set(got) == set(want)
        assert all(torch.equal(got[k], v) for k, v in want.items())
    for a, b in zip(plain.state.g_params + plain.state.d_params,
                    remat.state.g_params + remat.state.d_params):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def jax_remat_step():
    japp = JaxStage1App(JaxConfig(remat=True, **SMALL))
    st = japp.init_state(jax.random.PRNGKey(3))
    init = _np_tree({"g": st.g_params, "d": st.d_params, "s": st.d_stats})
    batch = next(JaxLoader(4, 32, 16, seed=3))
    new_state, metrics = japp.train_step(
        st, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    new = _np_tree({"g": new_state.g_params, "d": new_state.d_params,
                    "s": new_state.d_stats})
    return init, batch, _bridge(new["g"], new["d"], new["s"]), {
        k: float(v) for k, v in metrics.items()}


def test_remat_step_matches_jax_remat_step(jax_remat_step):
    """The port's remat step against JAX's jitted remat step from the same
    params and batch: metrics within rtol 1e-5, the updated nets within
    Adam's 2 lr with at most 0.1% of elements more than lr/100 apart, the
    D's statistics within 2e-5 (tests/test_torch_train.py's limits)."""
    init, batch, ref, metrics = jax_remat_step
    app = Stage1App(Config(platform="cpu", remat=True, **SMALL), CPU,
                    state=_bridge(init["g"], init["d"], init["s"]))
    rec = recorded_train_step(app, batch)
    assert set(rec.metrics) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(rec.metrics[k], metrics[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for sub, module in zip(SUBNETS, (app.encoder, app.generator, app.disc)):
        sd = module.state_dict()
        diffs = torch.cat([(sd[k] - v).abs().reshape(-1)
                           for k, v in ref[sub].items()])
        assert float(diffs.max()) <= 2 * LR + 1e-6, sub
        assert float((diffs > LR / 100).float().mean()) <= 1e-3, sub
    sd = app.disc.state_dict()
    for k, v in ref["Discriminator_stats"].items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=2e-5)


@pytest.mark.parametrize("model", [1, 101])
def test_cli_trains_with_remat(tmp_path, model):
    """`--remat=true` through the CLI at the tiny config: two steps with
    finite metrics and the checkpoint written."""
    port_main.main([
        f"--model={model}", "--platform=cpu", "--synthetic_data=true",
        "--remat=true", "--max_step=2", "--log_step=1",
        f"--model_dir={tmp_path}", "--img_H=32", "--img_W=16",
        "--batch_size=4", "--conv_hidden_num=16", "--z_num=16"])
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    assert (tmp_path / "ckpt" / "step_00000002" / "state.pt").exists()
