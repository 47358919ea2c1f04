"""The orbax importer (`scripts/orbax_to_torch.py`): checkpoints written by
the JAX package's own `save_checkpoint` inside the test, at the tiny size,
imported into the port's format, then served, resumed and composed by the
port against the JAX package on the same orbax checkpoints.

The optimizer states are a step old when saved (one optax update on
random gradients from the apps' own cold starts, with moved D statistics),
so the resumed step exercises the imported moments, counts and
statistics. Limits are those of the files named where they are used.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpig_tpu.apps.stage1_app import Stage1App as JaxStage1App
from dpig_tpu.apps.stage1_pose import Stage1PoseApp as JaxPoseApp
from dpig_tpu.apps.stage2_app import Stage2AppApp as JaxAppApp
from dpig_tpu.apps.stage2_pose import Stage2PoseApp as JaxPoseSampler
from dpig_tpu.apps.testers import ConditionalTransferTester as JaxTransfer
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.data.synthetic import SyntheticLoader as JaxLoader
from dpig_tpu.train import checkpoint as jckpt
from dpig_tpu_torch import main as port_main
from dpig_tpu_torch.apps import testers
from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.apps.stage2_app import Stage2AppApp
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.train import checkpoint as ckpt
from dpig_tpu_torch.train.parity import recorded_train_step
from scripts.orbax_to_torch import import_checkpoint, main as importer_main
from test_torch_stage2 import APP_NETS, C, RMS_FLIP, _app_noise, _jax_step

torch.set_num_threads(1)

SMALL = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16)
CPU = torch.device("cpu")
LR = Config().g_lr  # 8e-5, every net here
SEED = 3


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _stepped(state, seed):
    """`state` one optax update later, on random gradients (and, for a D
    with BatchNorm, moved running statistics): a mid-run state."""
    rng = np.random.default_rng(seed)

    def update(tx, params, opt_state):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape) * 1e-2,
                                  jnp.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    g, g_opt = update(state.g_tx, state.g_params, state.g_opt_state)
    kw = dict(step=jnp.asarray(1, jnp.int32), g_params=g, g_opt_state=g_opt)
    if state.d_params is not None:
        kw["d_params"], kw["d_opt_state"] = update(
            state.d_tx, state.d_params, state.d_opt_state)
    if state.d_stats:
        kw["d_stats"] = jax.tree_util.tree_map(
            lambda s: s + jnp.asarray(rng.uniform(0.1, 0.5, s.shape),
                                      jnp.float32), state.d_stats)
    return state.replace(**kw)


@pytest.fixture(scope="module")
def model1(tmp_path_factory):
    """A JAX model-1 state a step into training, saved by the JAX package
    and imported: (JAX app, JAX state as numpy, orbax dir, port dir)."""
    root = tmp_path_factory.mktemp("m1")
    japp = JaxStage1App(JaxConfig(**SMALL))
    st = _stepped(japp.init_state(jax.random.PRNGKey(SEED)), 0)
    jckpt.save_checkpoint(str(root / "jax"), 1, st)
    port = import_checkpoint(str(root / "jax"), str(root / "port"))
    return japp, _np(st), str(root / "jax"), port


@pytest.fixture(scope="module")
def model3(tmp_path_factory):
    root = tmp_path_factory.mktemp("m3")
    japp = JaxAppApp(JaxConfig(critic_batch_mode="reused", **SMALL))
    st = _stepped(japp.init_state(jax.random.PRNGKey(1)), 1)
    jckpt.save_checkpoint(str(root / "jax"), 1, st)
    port = import_checkpoint(str(root / "jax"), str(root / "port"))
    return japp, st, str(root / "jax"), port


def _flat(tree):
    return {f"{k}/{n}": t for k, d in params_from_flax(
        tree, list(tree)).items() for n, t in d.items()}


def test_import_writes_the_port_format(model1):
    """The keys of train/checkpoint.py; params, D statistics, Adam's mu,
    nu and count and the step exactly the JAX values, mapped as the bridge
    maps params; the CLI form prints the directory it wrote."""
    _, st, jax_dir, port_dir = model1
    tree = ckpt.load_tree(port_dir)
    assert port_dir.endswith(os.path.join("ckpt", "step_00000001"))
    assert set(tree) == {"step", "g_params", "d_params", "g_opt_state",
                         "d_opt_state", "d_stats"}
    assert tree["step"] == 1
    want_g = params_from_flax(st.g_params, ["Encoder", "ID_AE"])
    for k in want_g:
        for n, t in want_g[k].items():
            assert torch.equal(tree["g_params"][k][n], t), n
    stats = params_from_flax({"D_stats": st.d_stats}, ["D_stats"])["D_stats"]
    assert set(tree["d_stats"]) == {"Discriminator"}
    assert set(stats) == set(tree["d_stats"]["Discriminator"])
    for n, t in stats.items():
        assert torch.equal(tree["d_stats"]["Discriminator"][n], t), n
    for side, opt in (("g", st.g_opt_state), ("d", st.d_opt_state)):
        got = tree[f"{side}_opt_state"]
        adam, sched = opt
        assert got["count"] == int(adam.count) == int(sched.count) == 1
        for m in ("mu", "nu"):
            want = _flat(getattr(adam, m))
            assert set(got[m]) == set(want)
            for n, t in want.items():
                assert torch.equal(got[m][n], t), (m, n)


def test_importer_cli(model1, tmp_path, capsys):
    _, _, jax_dir, _ = model1
    importer_main([jax_dir, str(tmp_path)])
    out = capsys.readouterr().out.strip()
    assert out == os.path.join(str(tmp_path), "ckpt", "step_00000001")
    assert os.path.exists(os.path.join(out, "state.pt"))


def _model12_matches_jax(jax_dir, port_dir, cfg_kw, batch, model_dir,
                         img_tol, score_tol):
    """Port model 12 on the imported checkpoint against JAX's on the orbax
    one: `--pretrained_path` (no D: scores 0 on both sides), then the
    checkpoint's D as well (its scores)."""
    jt = JaxTransfer(JaxConfig(model_dir=model_dir, pretrained_path=jax_dir,
                               **cfg_kw))
    t = testers.ConditionalTransferTester(Config(
        model_dir=model_dir, platform="cpu", pretrained_path=port_dir,
        **cfg_kw))
    assert t.stage1.disc is None
    tree = jckpt.restore_tree(jax_dir)
    jparams = {**jt.params, "Discriminator": tree["d_params"][
        "Discriminator"], "Discriminator_stats": tree["d_stats"]}
    port_tree = ckpt.load_tree(port_dir)
    t_d = testers.ConditionalTransferTester(
        Config(model_dir=model_dir, platform="cpu", **cfg_kw),
        params={**port_tree["g_params"], **port_tree["d_params"],
                "Discriminator_stats": port_tree["d_stats"][
                    "Discriminator"]})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for tester, params in ((t, jt.params), (t_d, jparams)):
        g_ref, pose_ref, score_ref = jt.transfer_step(params, jb)
        g, pose, score = tester.transfer_step(batch_to_device(batch, CPU))
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref),
                                   atol=img_tol, rtol=0)
        np.testing.assert_array_equal(pose.numpy(), np.asarray(pose_ref))
        np.testing.assert_allclose(score.numpy(), np.asarray(score_ref),
                                   atol=score_tol, rtol=0)
    assert float(np.abs(np.asarray(score_ref)).max()) > 0


def test_imported_model1_serves_model12_as_jax(model1, tmp_path):
    """tests/test_torch_transfer.py's limits: 2e-2 on [0,255] (the 1e-4
    bound on g_raw times 127.5), 1e-4 on the score, pose maps equal."""
    _, _, jax_dir, port_dir = model1
    _model12_matches_jax(jax_dir, port_dir, SMALL,
                         next(JaxLoader(4, 32, 16, seed=5)), str(tmp_path),
                         2e-2, 1e-4)


def test_resumed_model1_step_matches_jax(model1, tmp_path):
    """`--ckpt_path` on the imported directory, one step through the CLI,
    against one JAX step from the orbax state (restore_into_state), on
    the same synthetic batch, under tests/test_torch_train.py's limits:
    metrics within 1e-5 relative, updated params within 2 lr + 1e-6 with
    at most 0.1% more than lr / 100 apart, D statistics within 2e-5; the
    step and both optimizer counts 2."""
    japp, _, jax_dir, port_dir = model1
    loader = JaxLoader(4, 32, 16, seed=SEED)
    next(loader)  # the Trainer's fixed preview batch
    batch = next(loader)
    st = jckpt.restore_into_state(jax_dir, japp.init_state(
        jax.random.PRNGKey(0)))
    new, metrics = japp.train_step(
        st, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    port_main.main([
        "--model=1", "--platform=cpu", "--synthetic_data=true",
        f"--random_seed={SEED}", f"--ckpt_path={port_dir}", "--max_step=2",
        "--log_step=1", f"--model_dir={tmp_path}", "--img_H=32",
        "--img_W=16", "--batch_size=4", "--conv_hidden_num=16",
        "--z_num=16"])
    with open(tmp_path / "metrics.jsonl") as f:
        rec = [json.loads(line) for line in f]
    assert [r["step"] for r in rec] == [1]
    for k, v in metrics.items():
        np.testing.assert_allclose(rec[0][k], float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    tree = ckpt.load_tree(str(tmp_path))
    assert tree["step"] == int(new.step) == 2
    assert tree["g_opt_state"]["count"] == tree["d_opt_state"]["count"] == 2
    new = _np(new)
    for side in ("g", "d"):
        want = params_from_flax(getattr(new, f"{side}_params"),
                                list(getattr(new, f"{side}_params")))
        for k, d in want.items():
            diffs = torch.cat([(tree[f"{side}_params"][k][n] - t).abs()
                               .reshape(-1) for n, t in d.items()])
            assert float(diffs.max()) <= 2 * LR + 1e-6, k
            assert float((diffs > LR / 100).float().mean()) <= 1e-3, k
    stats = params_from_flax({"D_stats": new.d_stats}, ["D_stats"])
    for n, t in stats["D_stats"].items():
        torch.testing.assert_close(tree["d_stats"]["Discriminator"][n], t,
                                   rtol=0, atol=2e-5)


def test_resumed_model3_step_matches_jax(model3, monkeypatch):
    """The appearance samplers (RMSProp: nu and the schedule's count, no
    mu; the frozen Stage-I nets), resumed from the imported checkpoint,
    against JAX's step body run eagerly on the orbax state with JAX's own
    noise, synced after the G update and each clip as
    tests/test_torch_stage2.py does: losses within 1e-5 relative, each
    update within 2 sqrt(10) lr + 1e-6 with at most 0.1% more than lr /
    100 apart; the frozen nets equal JAX's; the step and the G count go
    from 1 to 2, the D count from 1 to 1 + CRITIC_ITERS."""
    japp, st0, jax_dir, port_dir = model3
    st = jckpt.restore_into_state(jax_dir, st0)
    batch = next(JaxLoader(4, 32, 16, seed=6))
    rng = jax.random.PRNGKey(8)
    ref, _, clipped, new = _jax_step(
        japp, st, [{k: jnp.asarray(v) for k, v in batch.items()}], rng,
        japp.real_embs, monkeypatch)
    cfg = Config(platform="cpu", critic_batch_mode="reused", **SMALL)
    app = Stage2AppApp(cfg, CPU, ckpt.restore_subtrees(port_dir, [
        "Encoder", "ID_AE"]))
    frozen = params_from_flax(_np(st.frozen_params), ["Encoder", "ID_AE"])
    for k, m in app.frozen.items():
        for n, t in m.state_dict().items():
            assert torch.equal(t, frozen[k][n]), (k, n)

    def resumed(app, state, batch, noise, mark):
        ckpt.restore_into_state(port_dir, state)
        assert (state.step, state.g_opt.count, state.d_opt.count) == (
            1, 1, 1)
        return type(app).train_step(app, state, batch, noise, mark=mark)

    rec = recorded_train_step(
        app, batch, step_fn=resumed, noise=_app_noise(rng),
        g_updated=_flat({k: new.g_params[k] for k in APP_NETS[:2]}),
        d_clipped=[_flat({k: c[k] for k in APP_NETS[2:]}) for c in clipped])
    for k, v in rec.metrics.items():
        np.testing.assert_allclose(v, float(ref[k]), rtol=1e-5, err_msg=k)
    updates = [(rec.g_updated, _flat({k: _np(new.g_params[k])
                                      for k in APP_NETS[:2]}))]
    updates += [(got, _flat({k: want[k] for k in APP_NETS[2:]}))
                for got, want in zip(rec.d_clipped, clipped)]
    assert len(rec.d_clipped) == len(clipped) == C
    for got, want in updates:
        diffs = torch.cat([(got[n] - v).abs().reshape(-1)
                           for n, v in want.items()])
        assert float(diffs.max()) <= RMS_FLIP
        assert float((diffs > LR / 100).float().mean()) <= 1e-3
    state = rec.state
    assert state.step == int(new.step) == 2
    assert (state.g_opt.count, state.d_opt.count) == (2, 1 + C)


def test_model11_composes_imported_checkpoints(model1, model3, tmp_path,
                                               capsys):
    """All four `--pretrained_*` flags on imported directories (models 1
    and 3 above, and JAX cold starts of models 2 and 4): no RANDOM line,
    no D (scores 0), and the tester's nets are the JAX checkpoints'."""
    dirs = {"pretrained_path": model1[3], "pretrained_appSample_path":
            model3[3]}
    wanted = {}
    for flag, app, key in (
            ("pretrained_poseAE_path", JaxPoseApp, "PoseAE"),
            ("pretrained_poseSample_path", JaxPoseSampler, "PoseGaussian")):
        japp = app(JaxConfig(**SMALL))
        st = japp.init_state(jax.random.PRNGKey(4))
        jckpt.save_checkpoint(str(tmp_path / key), 0, st)
        dirs[flag] = import_checkpoint(str(tmp_path / key),
                                       str(tmp_path / f"port_{key}"))
        wanted[key] = params_from_flax(_np(st.g_params), [key])[key]
    capsys.readouterr()
    out = port_main.test_model(port_main.get_config([
        "--model=11", "--is_train=false", "--sample_app=true",
        "--pose_source=sampled", "--platform=cpu", "--synthetic_data=true",
        "--test_batch_num=1", "--img_H=32", "--img_W=16", "--batch_size=4",
        "--conv_hidden_num=16", "--z_num=16", f"--model_dir={tmp_path}",
        *(f"--{k}={v}" for k, v in dirs.items())]))
    assert "RANDOM" not in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(out, "G"))) == [
        f"{i:05d}_score0.000.png" for i in range(4)]
    t = testers.FullSamplingTester(Config(
        platform="cpu", **SMALL, **{k: os.path.dirname(os.path.dirname(v))
                                    for k, v in dirs.items()}))
    state = t.cpu_state()
    wanted["Encoder"] = params_from_flax(model1[1].g_params,
                                         ["Encoder"])["Encoder"]
    wanted["Gaussian_FC_Fg"] = params_from_flax(
        _np(model3[1].g_params), ["Gaussian_FC_Fg"])["Gaussian_FC_Fg"]
    for k, want in wanted.items():
        assert set(state[k]) == set(want), k
        for n, v in want.items():
            assert torch.equal(state[k][n], v), (k, n)


@pytest.mark.slow
def test_full_width_model12_on_an_imported_checkpoint(tmp_path):
    """Default Config() (Market 128x64, hidden 128, z 64), batch 2, CPU:
    a JAX cold start saved by the JAX package, imported, served by both
    packages: max |diff| <= 1e-3 on [0,255] (a probe outside the tests
    read 1.5e-4 on bridged weights), scores within 1e-4."""
    japp = JaxStage1App(JaxConfig())
    jckpt.save_checkpoint(str(tmp_path / "jax"), 0,
                          japp.init_state(jax.random.PRNGKey(0)))
    port = import_checkpoint(str(tmp_path / "jax"), str(tmp_path / "port"))
    batch = next(JaxLoader(2, 128, 64, seed=1))
    _model12_matches_jax(str(tmp_path / "jax"), port, {"batch_size": 2},
                         batch, str(tmp_path), 1e-3, 1e-4)
