"""Data parallelism across processes in the port, Stage II and the CLI, on
the CPU with gloo: one model-2 (pose AE) step and one model-3 step
(`fresh` batches) at world size 2 against the port's world-1 step on the
global batch and against the JAX package's step sharded over the
conftest's 8-device mesh; the CLI at world 2 (model 1: two steps, one
checkpoint written by rank 0, a resume); the testers at world 2, one per
rank as in JAX, each with its own model_dir.

Each rank takes its rows of the global batches and of the global noise
(`[1 + CRITIC_ITERS, b, dim]`, drawn once and sliced as JAX's jitted draw
is sharded). Tolerances are stated where they are used; see
tests/test_torch_ddp.py for the rule and tests/test_torch_stage2.py for
the Stage-II limits against JAX.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from dpig_tpu.apps.stage1_pose import Stage1PoseApp as JaxPoseApp
from dpig_tpu.apps.stage2_app import Stage2AppApp as JaxAppApp
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.data.synthetic import SyntheticLoader as JaxLoader
from dpig_tpu.losses import gan as jgan
from dpig_tpu.models.mappers import sample_mapper_noise as jax_noise
from dpig_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.apps.stage1_pose import Stage1PoseApp
from dpig_tpu_torch.apps.stage2_app import Stage2AppApp
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.parallel import dist, ranks, spawn
from dpig_tpu_torch.train.parity import recorded_train_step

torch.set_num_threads(1)

SMALL = dict(img_H=32, img_W=16, conv_hidden_num=16, z_num=16)
GLOBAL_B = 8
CPU = torch.device("cpu")
LR = Config().g_lr
RMS_FLIP = 2 * np.sqrt(10) * LR + 1e-6
C = jgan.CRITIC_ITERS
FG, BG = 7 * 32, 4 * 32
APP_NETS = ("Gaussian_FC_Fg", "Gaussian_FC_Bg", "Fg_FCDis", "Bg_FCDis")
RANK_TIMEOUT = 240.0
CLI = ["--platform=cpu", "--synthetic_data=true", "--img_H=32",
       "--img_W=16", "--batch_size=4", "--conv_hidden_num=16", "--z_num=16",
       "--log_step=1"]


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _flat(tree, names):
    state = params_from_flax(tree, names)
    return {f"{k}/{n}": v for k, v in state.items() for n, v in v.items()}


def _max_diff(got, want):
    return torch.cat([(got[k] - torch.as_tensor(v)).abs().reshape(-1)
                      for k, v in want.items()])


def _host_batches(seed, n):
    loader = JaxLoader(GLOBAL_B, 32, 16, seed=seed)
    return tuple(next(loader) for _ in range(n))


# ------------------------------------------------------------- model 2
def test_pose_ae_step_at_world_2_is_world_1_and_jax_sharded_step():
    """One Adam step of the pose AE on 8 rows: both ranks' losses equal,
    and equal to world 1's and to JAX's sharded step's (rtol 1e-5); the
    averaged gradients within 1e-5 of each tensor's largest of world 1's
    (measured ~1e-7: dense layers, no BatchNorm); the updated params
    within Adam's sign-flip limit (2 lr + 1e-6, at most 0.1% of them more
    than lr / 100 apart) of world 1's and of JAX's."""
    japp = JaxPoseApp(JaxConfig(batch_size=GLOBAL_B, **SMALL))
    st = japp.init_state(jax.random.PRNGKey(4))
    init = params_from_flax(_np(st.g_params), ("PoseAE",))
    batch = next(JaxLoader(GLOBAL_B, 32, 16, seed=5))
    mesh = make_mesh()
    new, metrics = japp.train_step(replicate(st, mesh),
                                   shard_batch(batch, mesh),
                                   jax.random.PRNGKey(0))
    jax_new = {f"PoseAE/{k}": v for k, v in params_from_flax(
        _np(new.g_params), ("PoseAE",))["PoseAE"].items()}

    app = Stage1PoseApp(Config(platform="cpu", batch_size=GLOBAL_B, **SMALL),
                        CPU, init)
    state = app.init_state()
    grads = {}
    apply = state.g_opt.apply
    state.g_opt.apply = lambda g: (grads.update(zip(state.g_opt.params, g)),
                                   apply(g))
    one = app.train_step(state, batch_to_device(batch, CPU))
    one_params = {k: v.detach() for k, v in state.g_opt.params.items()}

    two = ranks.run("pose_ae", {"cfg": dict(batch_size=GLOBAL_B, **SMALL),
                                "params": init, "batch": batch}, n=2,
                    timeout=RANK_TIMEOUT)
    assert two[0]["metrics"] == two[1]["metrics"]
    for k in ("reconstruct_loss", "loss"):
        for ref in (float(one[k]), float(metrics[k])):
            np.testing.assert_allclose(two[0]["metrics"][k], ref, rtol=1e-5,
                                       err_msg=k)
    for n, ref in grads.items():
        assert float((two[0]["grads"][n] - ref).abs().max()) <= (
            1e-5 * float(ref.abs().max())), n
    for want in (one_params, jax_new):
        diffs = _max_diff(two[0]["params"], want)
        assert float(diffs.max()) <= 2 * LR + 1e-6
        assert float((diffs > LR / 100).float().mean()) <= 1e-3
    for k, v in two[0]["params"].items():
        assert torch.equal(v, two[1]["params"][k]), k


# ------------------------------------------------------------- model 3
def _app_noise(rng, b):
    """The noise JAX's model-3 step draws (stage2_app.py:101-107, 145, 163)
    for the global batch, as the port's [1+C, b, FG+BG] step noise
    (tests/test_torch_stage2.py)."""
    rngs = jax.random.split(rng, 2 + 2 * C)
    draws = []
    for r in [rngs[0]] + [rngs[2 + i] for i in range(C)]:
        rf, rb = jax.random.split(r)
        draws.append(np.concatenate([np.asarray(jax_noise(rf, b, FG)),
                                     np.asarray(jax_noise(rb, b, BG))], -1))
    return torch.from_numpy(np.stack(draws))


@pytest.fixture(scope="module")
def model3_steps():
    """One model-3 step on 1 + C global batches of 8, the same weights and
    the global noise: JAX's jitted step sharded over the 8-device mesh, the
    port at world 1 (recorded) and at world 2 (the ranks' G and critics
    set to world 1's after the G update and after each clip, as
    tests/test_torch_stage2.py syncs the port to JAX)."""
    japp = JaxAppApp(JaxConfig(batch_size=GLOBAL_B, **SMALL))
    st = japp.init_state(jax.random.PRNGKey(1))
    init = _np({"g": st.g_params, "d": st.d_params, "f": st.frozen_params})
    host = _host_batches(6, 1 + C)
    rng = jax.random.PRNGKey(8)
    mesh = make_mesh()
    new, metrics = japp.train_step(
        replicate(st, mesh), tuple(shard_batch(b, mesh) for b in host), rng)
    jax_ref = ({k: float(v) for k, v in metrics.items() if np.ndim(v) == 0},
               _np({"g": new.g_params, "d": new.d_params}))

    frozen = params_from_flax(init["f"], ("Encoder", "ID_AE"))
    nets = params_from_flax({**init["g"], **init["d"]}, APP_NETS)
    noise = _app_noise(rng, GLOBAL_B)
    app = Stage2AppApp(Config(platform="cpu", batch_size=GLOBAL_B, **SMALL),
                       CPU, frozen)
    for name, net in {**app.mappers, **app.critics}.items():
        net.load_state_dict(nets[name], strict=True)
    one = recorded_train_step(app, host, noise=noise)
    two = ranks.run("stage2", {
        "cls": "Stage2AppApp", "cfg": dict(batch_size=GLOBAL_B, **SMALL),
        "frozen": frozen, "params": nets, "batches": host, "noise": noise,
        "g_updated": one.g_updated, "d_clipped": one.d_clipped}, n=2,
        timeout=RANK_TIMEOUT)
    return jax_ref, one, two


def test_model3_step_at_world_2_is_the_world_1_step(model3_steps):
    """World 2 against world 1 of the port: the four losses the same on
    both ranks and within 1e-5 relative of world 1's; the `hist/`
    embeddings gathered in rank order, the fakes within 1e-6 and the real
    ones within 1e-5 (the frozen encoder on 4 rows, measured ~1e-7);
    the averaged gradients of the G update and of each critic iteration
    within 1e-5 of each tensor's largest (measured ~1e-7); the updates
    within RMSProp's sign-flip limit (2 sqrt(10) lr + 1e-6, at most 0.1%
    of the elements more than lr / 100 apart); the critics within +-0.01
    and equal on both ranks."""
    _, one, two = model3_steps
    r0, r1 = two
    assert r0["metrics"] == r1["metrics"]
    for k, v in one.metrics.items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=1e-5,
                                   err_msg=k)
    for k, v in one.arrays.items():
        assert r0["arrays"][k].shape == v.shape == (
            GLOBAL_B, FG if k.endswith("fg") else BG)
        assert torch.equal(r0["arrays"][k], r1["arrays"][k])
        torch.testing.assert_close(r0["arrays"][k], v, rtol=0,
                                   atol=1e-5 if "real" in k else 1e-6)
    for n, ref in one.grads.items():
        assert float((r0["grads"][n] - ref).abs().max()) <= (
            1e-5 * float(ref.abs().max())), n
    for got, want in ((r0["g_updated"], one.g_updated),
                      *zip(r0["d_clipped"], one.d_clipped)):
        diffs = _max_diff(got, want)
        assert float(diffs.max()) <= RMS_FLIP
        assert float((diffs > LR / 100).float().mean()) <= 1e-3
    for k, v in r0["d_params"].items():
        assert float(v.abs().max()) <= 0.01
        assert torch.equal(v, r1["d_params"][k]), k


def test_model3_step_at_world_2_is_jax_sharded_step(model3_steps):
    """World 2 against JAX's jitted step sharded over the 8-device mesh on
    the same global noise: the G losses within 1e-5 relative (before any
    update), the mappers after their update within RMSProp's sign-flip
    limit, and the critics after the 5 clipped iterations within it too
    (their own iterations: JAX's are not synced to the port's)."""
    (jax_metrics, jax_new), _, two = model3_steps
    r0 = two[0]
    for k in ("g_loss_embs_fg", "g_loss_embs_bg"):
        np.testing.assert_allclose(r0["metrics"][k], jax_metrics[k],
                                   rtol=1e-5, err_msg=k)
    for got, want in ((r0["g_updated"], _flat(jax_new["g"], APP_NETS[:2])),
                      (r0["d_clipped"][-1], _flat(jax_new["d"],
                                                  APP_NETS[2:]))):
        diffs = _max_diff(got, want)
        assert float(diffs.max()) <= RMS_FLIP
        assert float((diffs > LR / 100).float().mean()) <= 1e-3


@pytest.mark.parametrize("rank", [0, 1])
def test_trainer_feeds_each_rank_its_rows_of_the_global_noise(tmp_path,
                                                              monkeypatch,
                                                              rank):
    """At rank r of 2 with --batch_size=8, the Trainer draws the whole
    step's noise for the global batch, [1+C, 8, dim], from its generator
    (the same on every rank) and gives the step rows 4r..4r+3 of each
    draw, beside the rank's loader batches of 4."""
    from dpig_tpu_torch.apps.stage2_pose import POSE_Z, Stage2PoseApp
    from dpig_tpu_torch.data.synthetic import SyntheticLoader
    from dpig_tpu_torch.train.harness import Trainer
    monkeypatch.setattr(dist, "rank", lambda: rank)
    monkeypatch.setattr(dist, "world", lambda: 2)
    cfg = Config(platform="cpu", model_dir=str(tmp_path), max_step=2,
                 log_step=1, **SMALL, batch_size=GLOBAL_B)
    app = Stage2PoseApp(cfg, CPU)
    seen = []
    step = app.train_step
    app.train_step = lambda state, batch, noise: (
        seen.append((batch, noise)), step(state, batch, noise))[1]
    Trainer(cfg, app, SyntheticLoader(4, 32, 16, seed=3)).train()
    gen = torch.Generator().manual_seed(cfg.random_seed)
    assert len(seen) == 2
    for batch, noise in seen:
        assert len(batch) == 1 + C and batch[0]["x"].shape[0] == 4
        full = torch.randn(((1 + C) * GLOBAL_B, POSE_Z),
                           generator=gen).mul(0.2).view(1 + C, GLOBAL_B,
                                                        POSE_Z)
        assert torch.equal(noise, full[:, 4 * rank:4 * rank + 4])
    written = os.listdir(tmp_path)
    assert ("metrics.jsonl" in written) == (rank == 0)


# ------------------------------------------------------------ the CLI
def _cli_ranks(model_dirs, *flags, n=2):
    port = dist.free_port()
    return spawn.run_ranks([spawn.python_argv(
        "dpig_tpu_torch.main", *CLI, *flags, f"--model_dir={d}",
        f"--num_processes={n}", f"--process_id={r}",
        f"--coordinator_address=127.0.0.1:{port}")
        for r, d in enumerate(model_dirs)], timeout=RANK_TIMEOUT)


def test_cli_trains_model_1_at_world_2_writes_once_and_resumes(tmp_path):
    """`python -m dpig_tpu_torch.main --model=1 --num_processes=2
    --process_id=<r> --coordinator_address=127.0.0.1:<port>` on gloo:
    rank 0 alone writes metrics.jsonl (one line per logged step, the
    global batch's imgs_per_sec), the previews and one checkpoint per save;
    rank 1 prints nothing of it. A second run to step 4 auto-resumes both
    ranks from step 2."""
    d = str(tmp_path / "m1")
    outs = _cli_ranks([d, d], "--model=1", "--max_step=2")
    assert "[1] g_loss=" in outs[0] and "g_loss=" not in outs[1]
    with open(os.path.join(d, "metrics.jsonl")) as f:
        assert [json.loads(ln)["step"] for ln in f] == [0, 1]
    assert sorted(os.listdir(os.path.join(d, "ckpt"))) == ["step_00000002"]
    assert os.listdir(os.path.join(d, "ckpt", "step_00000002")) == [
        "state.pt"]
    assert sorted(f for f in os.listdir(d) if "_G_ssim" in f)[0].startswith(
        "0_")
    outs = _cli_ranks([d, d], "--model=1", "--max_step=4")
    assert "auto-resumed from" in outs[0] and "(step 2)" in outs[0]
    with open(os.path.join(d, "metrics.jsonl")) as f:
        assert [json.loads(ln)["step"] for ln in f] == [0, 1, 2, 3]
    assert sorted(os.listdir(os.path.join(d, "ckpt"))) == [
        "step_00000002", "step_00000004"]
    state = torch.load(os.path.join(d, "ckpt", "step_00000004", "state.pt"),
                       weights_only=True)
    assert state["step"] == 4


def test_testers_at_world_2_refuse_a_shared_model_dir(tmp_path):
    """Two JAX testers on one host write the same PNG names into one
    model_dir (testers.py:77-85, :407): the port raises on every rank
    before writing."""
    d = str(tmp_path / "t")
    with pytest.raises(spawn.RanksFailed, match="share a --model_dir"):
        _cli_ranks([d, d], "--model=12", "--is_train=false",
                   "--test_batch_num=1")
    assert not os.path.exists(d)


def test_testers_at_world_2_serve_each_ranks_share(tmp_path):
    """Model 12 at world 2, each rank with its own model_dir: each writes
    its 2 rows of each batch under its own indices, as each JAX process
    does with its host shard."""
    dirs = [str(tmp_path / f"t{r}") for r in range(2)]
    _cli_ranks(dirs, "--model=12", "--is_train=false", "--test_batch_num=2")
    for d in dirs:
        names = sorted(os.listdir(os.path.join(d, "test_result", "x")))
        assert names == ["00000.png", "00001.png", "00004.png",
                         "00005.png"], names
