"""Data parallelism across processes in the port (`dpig_tpu_torch/parallel/`)
against the JAX package, on the CPU with gloo: BatchNorm over a global
batch, one model-1 step, the per-host loaders, the dry run's five graphs,
and the process-group plumbing.

The rule held here is the JAX package's: a step at world size 2 on two
local batches computes what the world-1 step computes on their
concatenation (GSPMD over the conftest's 8-device CPU mesh, or one process
of the port). Each world-2 run spawns two rank processes
(`parallel.ranks.run`, one thread each, a free port, its own timeout).

Tolerances are stated where they are used. World 2 against world 1 of the
port: float32 sums in another order (two partial BatchNorm sums, two
local means averaged), measured at most ~1e-6 relative; against JAX, the
limits tests/test_torch_train.py holds the port's world-1 step to, with
the updated params from JAX's jitted step (Adam's sign-like first step,
2 * lr for an element whose gradient sign the two sides round apart).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jax_main
from dpig_tpu.apps.stage1_app import Stage1App as JaxStage1App
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.config import get_config as jax_get_config
from dpig_tpu.data.synthetic import SyntheticLoader as JaxLoader
from dpig_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from dpig_tpu_torch import main as port_main
from dpig_tpu_torch.apps.stage1_app import Stage1App
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.data.synthetic import write_synthetic_tfrecords
from dpig_tpu_torch.parallel import dist, dryrun, ranks, spawn
from dpig_tpu_torch.train.parity import recorded_train_step

torch.set_num_threads(1)

SMALL = dict(img_H=32, img_W=16, conv_hidden_num=16, z_num=16)
GLOBAL_B = 8  # one row per device of the conftest's mesh, 4 per rank
CPU = torch.device("cpu")
LR = Config().g_lr
METRICS = ("g_loss", "g_loss_only", "d_loss", "L1Loss", "PoseMaskLoss")
BN_FED_BIASES = {f"Discriminator/Conv_{i}.bias" for i in (1, 2, 3)}
RANK_TIMEOUT = 240.0


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _bridge(g, d, s):
    return params_from_flax({"Encoder": g["Encoder"], "ID_AE": g["ID_AE"],
                             "Discriminator": d["Discriminator"],
                             "Discriminator_stats": s})


def _assert_updates_close(got, want, what):
    """Adam's first update moves a parameter by about +-lr: an element
    whose gradient sign the two runs round apart lands 2 * lr away (1e-6
    on top for the rest); at most 0.1% of the elements more than lr / 100
    apart (the limit of tests/test_torch_train.py)."""
    diffs = torch.cat([(got[k] - torch.as_tensor(v)).abs().reshape(-1)
                       for k, v in want.items()])
    assert float(diffs.max()) <= 2 * LR + 1e-6, what
    assert float((diffs > LR / 100).float().mean()) <= 1e-3, what


# ------------------------------------------------------------- BatchNorm
def test_batchnorm_at_world_2_is_flax_batchnorm_on_the_global_batch():
    """Two chained updating passes (the D step's real and fake passes) on
    two ranks of 2 rows each, against flax's BatchNorm on the 4 rows (its
    mutable apply): the output, the gradient of sum(y * ct) with respect to
    the input, the scale and the bias (the ranks' parameter gradients
    summed), and the running mean and biased variance. float32; the
    output within 1e-5 as tests/test_torch_train.py holds the port's
    world-1 BatchNorm, the rest within 1e-5 relative to each tensor's
    largest (measured ~1e-7)."""
    from flax import linen as nn
    rng = np.random.default_rng(4)
    xs = [rng.normal(m, s, (4, 5, 3, 6)).astype(np.float32)
          for m, s in ((0.5, 2.0), (-1.0, 0.5))]
    cts = [rng.standard_normal((4, 5, 3, 6)).astype(np.float32)
           for _ in xs]
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9)
    stats = bn.init(jax.random.PRNGKey(0), xs[0])["batch_stats"]
    ref = []
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    for x, ct in zip(xs, cts):
        def f(x, p, stats=stats):
            return bn.apply({"params": p, "batch_stats": stats}, x,
                            mutable=["batch_stats"])
        y, new = f(jnp.asarray(x), p)
        _, vjp = jax.vjp(lambda x, p: f(x, p)[0], jnp.asarray(x), p)
        dx, dp = vjp(jnp.asarray(ct))
        stats = new["batch_stats"]
        ref.append((y, dx, dp, stats))

    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        a.transpose(0, 3, 1, 2)))
    outs = ranks.run("batchnorm", {
        "x": [nchw(x) for x in xs], "ct": [nchw(c) for c in cts],
        "weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
        n=2, timeout=RANK_TIMEOUT)
    for i, (y, dx, dp, stats) in enumerate(ref):
        got_y = torch.cat([o["y"][i] for o in outs]).permute(0, 2, 3, 1)
        got_dx = torch.cat([o["dx"][i] for o in outs]).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(y), atol=1e-5,
                                   rtol=0)
        for got, want in ((got_dx.numpy(), dx),
                          (sum(o["dweight"][i] for o in outs).numpy(),
                           dp["scale"]),
                          (sum(o["dbias"][i] for o in outs).numpy(),
                           dp["bias"])):
            want = np.asarray(want)
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        for o in outs:  # every rank holds the global statistics
            np.testing.assert_allclose(o["running_mean"][i].numpy(),
                                       np.asarray(stats["mean"]), atol=1e-6)
            np.testing.assert_allclose(o["running_var"][i].numpy(),
                                       np.asarray(stats["var"]), atol=1e-6)


# ------------------------------------------------------- a model-1 step
@pytest.fixture(scope="module")
def model1_steps():
    """One model-1 step from the same weights on one global batch of 8:
    JAX's jitted step sharded over the conftest's 8-device mesh (as
    tests/test_stage1.py:41 runs it), the port at world 1 (recorded), and
    the port at world 2 (two gloo ranks of 4 rows, the D step started
    from world 1's updated G, as tests/test_torch_train.py starts the
    card's)."""
    cfg = dict(batch_size=GLOBAL_B, **SMALL)
    japp = JaxStage1App(JaxConfig(**cfg))
    st = japp.init_state(jax.random.PRNGKey(3))
    init = _np_tree({"g": st.g_params, "d": st.d_params, "s": st.d_stats})
    batch = next(JaxLoader(GLOBAL_B, 32, 16, seed=5))
    mesh = make_mesh()
    assert len(jax.devices()) == 8
    new_state, metrics = japp.train_step(replicate(st, mesh),
                                         shard_batch(batch, mesh),
                                         jax.random.PRNGKey(0))
    new = _np_tree({"g": new_state.g_params, "d": new_state.d_params,
                    "s": new_state.d_stats})
    jax_ref = ({k: float(v) for k, v in metrics.items()},
               _bridge(new["g"], new["d"], new["s"]))

    params = _bridge(init["g"], init["d"], init["s"])
    one = recorded_train_step(
        Stage1App(Config(platform="cpu", **cfg), CPU, state=params), batch)
    two = ranks.run("stage1", {"cfg": cfg, "params": params, "batch": batch,
                               "g_updated": one.g_updated}, n=2,
                    timeout=RANK_TIMEOUT)
    return jax_ref, one, two


def _flat(state, subs):
    return {f"{s}/{k}": v for s in subs for k, v in state[s].items()}


def test_model1_ranks_report_the_global_metrics(model1_steps):
    """The twin of tests/test_multihost.py:84: both ranks return the same
    metrics, bit for bit (the same all-reduce), equal to world 1's within
    float32 sums in another order (rtol 1e-5; measured ~1e-7) and to JAX's
    sharded step's (rtol 1e-5, atol 1e-6, tests/test_torch_train.py's)."""
    (jax_metrics, _), one, two = model1_steps
    assert two[0]["metrics"] == two[1]["metrics"]
    assert set(two[0]["metrics"]) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(two[0]["metrics"][k], one.metrics[k],
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(two[0]["metrics"][k], jax_metrics[k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_model1_step_at_world_2_is_the_world_1_step(model1_steps):
    """World 2 against world 1 of the port on the same global batch: the
    averaged gradients within 1e-4 of each tensor's largest, the limit
    tests/test_torch_train.py holds the port's gradients to against JAX's
    (measured 1.5e-5 in the encoder: the world-1 D normalizes by
    F.batch_norm's variance, world 2 by flax's E[x^2] - E[x]^2 of the
    global sums; the D's conv biases ahead of a BatchNorm, whose gradient
    is 0 in exact arithmetic, under 1e-5 of the D's largest), the G after its
    update and the D after its update within Adam's sign-flip limit, the
    D's running statistics (global) within 1e-6, the same on both ranks;
    the ranks' D params equal (replicated)."""
    _, one, two = model1_steps
    r0, r1 = two
    d_scale = max(float(g.abs().max()) for n, g in one.grads.items()
                  if n.startswith("Discriminator/"))
    for name, ref in one.grads.items():
        g = r0["grads"][name]
        assert torch.equal(g, r1["grads"][name]), name
        if name in BN_FED_BIASES:
            assert max(float(g.abs().max()), float(ref.abs().max())) <= (
                1e-5 * d_scale), name
            continue
        assert float((g - ref).abs().max()) <= 1e-4 * float(
            ref.abs().max()), name
    _assert_updates_close(r0["g_updated"], one.g_updated, "G")
    d_params = {k: v.detach() for k, v in one.state.d_opt.params.items()}
    _assert_updates_close(r0["d_params"], d_params, "D")
    for k, ref in one.d_stats.items():
        torch.testing.assert_close(r0["d_stats"][k], ref, rtol=0, atol=1e-6)
        assert torch.equal(r0["d_stats"][k], r1["d_stats"][k])
    for k, v in r0["d_params"].items():
        assert torch.equal(v, r1["d_params"][k]), k


# The whole step in float64 (the embedding-stem sum, the nets' outputs and
# the ROI crop too): the CPU read at most 2.2e-15 (the D gradients); the
# same step with each rank's own BatchNorm statistics 4.3e-3 and up.
FLOAT64_TOL = {"g_step_losses": 1e-12, "d_loss": 1e-12, "Encoder": 1e-12,
               "ID_AE": 1e-12, "Discriminator": 1e-12, "d_stats": 1e-12}


def test_model1_float64_step_at_world_2_is_world_1_to_round_off():
    """In float64 the rule holds to round-off: world 2 (4 rows a rank)
    against world 1 on the 8 rows within FLOAT64_TOL, rank 1's record
    (gradients, statistics, updated params) bit-equal to rank 0's (its
    digest: `lean`); per-rank BatchNorm statistics break the limits."""
    from dpig_tpu_torch.train.parity import step_errors, to_float64
    cfg = dict(batch_size=GLOBAL_B, **SMALL)
    app = Stage1App(Config(platform="cpu", **cfg), CPU)
    params = {name: {k: v.clone() for k, v in m.state_dict().items()}
              for name, m in (("Encoder", app.encoder),
                              ("ID_AE", app.generator),
                              ("Discriminator", app.disc))}
    batch = next(JaxLoader(GLOBAL_B, 32, 16, seed=7))
    one = recorded_train_step(to_float64(app, stem=True, outputs=True),
                              batch)
    job = {"cfg": cfg, "params": params, "batch": batch,
           "g_updated": one.g_updated, "float64": True, "stem64": True,
           "outputs64": True, "lean": True}
    two, local_bn = ranks.run_many(
        [("stage1", job), ("stage1", dict(job, local_bn=True))], n=2,
        timeout=RANK_TIMEOUT)
    assert two[0]["digest"] == two[1]["digest"]
    assert "grads" in two[0] and "grads" not in two[1]
    assert two[0]["metrics"] == two[1]["metrics"]
    errs = step_errors(one, ranks.as_record(two[0]))
    print(f"float64, world 2 against world 1: {errs}")
    assert all(errs[k] <= t for k, t in FLOAT64_TOL.items()), errs
    errs = step_errors(one, ranks.as_record(local_bn[0]))
    print(f"control, per-rank BatchNorm: {errs}")
    assert any(errs[k] > t for k, t in FLOAT64_TOL.items()), errs


def test_model1_step_at_world_2_is_jax_sharded_step(model1_steps):
    """World 2 against JAX's step sharded over the 8-device mesh: the G
    after its update and the D after its update within Adam's sign-flip
    limit, the D's running statistics within 2e-5
    (tests/test_torch_train.py's limits)."""
    (_, new_ref), _, two = model1_steps
    r0 = two[0]
    _assert_updates_close(r0["g_updated"],
                          _flat(new_ref, ("Encoder", "ID_AE")), "G")
    _assert_updates_close(r0["d_params"], _flat(new_ref, ("Discriminator",)),
                          "D")
    for k, ref in _flat(new_ref, ("Discriminator_stats",)).items():
        got = r0["d_stats"][k.replace("Discriminator_stats/",
                                      "Discriminator/")]
        torch.testing.assert_close(got, ref, rtol=0, atol=2e-5)


# --------------------------------------------------------------- loaders
def _jax_loader(flags, host, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(jax, "process_index", lambda: host)
        m.setattr(jax, "process_count", lambda: 2)
        return jax_main.make_loader(jax_get_config(flags))


def _port_loader(flags, host, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(dist, "rank", lambda: host)
        m.setattr(dist, "world", lambda: 2)
        return port_main.make_loader(port_main.get_config(
            [*flags, "--platform=cpu"]))


@pytest.mark.parametrize("host", [0, 1])
@pytest.mark.parametrize("source", ["synthetic", "tfrecords"])
def test_make_loader_at_host_of_2_matches_jax(tmp_path, monkeypatch, source,
                                              host):
    """The port's make_loader at host `host` of 2, batch for batch against
    the JAX CLI's (root main.py:21-40) given the same host_id / host_count:
    batch_size / 2 rows, synthetic batches seeded random_seed + host, or
    the host's share of the tfrecord pairs (round-robin over one shard);
    bit-equal."""
    flags = ["--model=1", "--img_H=32", "--img_W=16", "--batch_size=4",
             "--random_seed=7", f"--model_dir={tmp_path / 'm'}"]
    if source == "synthetic":
        flags.append("--synthetic_data=true")
    else:
        write_synthetic_tfrecords(str(tmp_path / "d" / "Market1501"),
                                  "test", 12, 32, 16, seed=5, n_shards=1)
        flags += [f"--data_dir={tmp_path / 'd'}", "--dataset=Market1501",
                  "--is_train=false"]
    ref = _jax_loader(flags, host, monkeypatch)
    got = _port_loader(flags, host, monkeypatch)
    for _ in range(2):
        want, have = next(ref), next(got)
        assert set(have) == set(want)
        for k in want:
            assert have[k].shape[0] == 2, k
            np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    for ld in (ref, got):
        getattr(ld, "close", lambda: None)()


def test_a_batch_that_does_not_split_over_the_processes_raises(
        tmp_path, monkeypatch):
    flags = ["--model=1", "--batch_size=5", "--synthetic_data=true",
             f"--model_dir={tmp_path}"]
    for make in (_jax_loader, _port_loader):
        with pytest.raises(ValueError, match="must be divisible by the "
                                             "process count"):
            make(flags, 0, monkeypatch)


# ----------------------------------------------------- the plumbing
def test_one_process_without_an_address_starts_no_group(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert dist.init_distributed("", 1, -1, platform="cpu") is False
    assert not dist.is_distributed()
    assert (dist.rank(), dist.world()) == (0, 1)
    g = [torch.ones(3)]
    assert dist.average_gradients(g)[0] is g[0]  # nothing to average
    x = torch.arange(6)
    assert torch.equal(dist.local_rows(x), x)


def test_one_of_several_processes_without_a_rank_raises(monkeypatch):
    """torchrun's WORLD_SIZE with an explicit --process_id and no address:
    a run alone would race its siblings for the model_dir."""
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="WORLD_SIZE=2"):
        dist.init_distributed("", 1, 0, platform="cpu")
    assert not dist.is_distributed()


def test_process_id_from_the_environment_needs_rank(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="RANK"):
        dist.init_distributed("127.0.0.1:1", 2, -1, platform="cpu")
    with pytest.raises(ValueError, match="not a rank"):
        dist.init_distributed("127.0.0.1:1", 2, 2, platform="cpu")


def test_a_failed_rendezvous_raises_within_its_timeout():
    """Rank 1 of 2 whose rank 0 never comes raises within its timeout (3
    s here), and the group's own timeout ends it regardless."""
    port = dist.free_port()
    code = ("import datetime\n"
            "from dpig_tpu_torch.parallel import dist\n"
            f"dist.init_distributed('127.0.0.1:{port}', 2, 1, "
            "platform='cpu', timeout=datetime.timedelta(seconds=3))\n")
    with pytest.raises(spawn.RanksFailed, match="rank 0 exited"):
        spawn.run_ranks([[sys.executable, "-c", code]], timeout=60)


def test_a_hung_group_is_ended_at_the_timeout():
    with pytest.raises(spawn.RanksFailed, match="did not finish within"):
        spawn.run_ranks([[sys.executable, "-c", "import time; "
                          "time.sleep(60)"]] * 2, timeout=2)


def test_local_rows_slice_the_global_batch_by_rank(monkeypatch):
    x = torch.arange(24).view(2, 12)
    monkeypatch.setattr(dist, "world", lambda: 3)
    for r in range(3):
        monkeypatch.setattr(dist, "rank", lambda r=r: r)
        assert torch.equal(dist.local_rows(x, dim=1), x[:, 4 * r:4 * r + 4])
    with pytest.raises(ValueError, match="do not split"):
        dist.local_rows(x)


def test_no_backend_is_picked_in_place_of_another():
    with pytest.raises(ValueError, match="--platform"):
        dist.init_distributed("127.0.0.1:1", 2, 0, platform="tpu")


# -------------------------------------------------------------- dry run
def test_dryrun_multichip_2_prints_the_five_graphs():
    """The twin of __graft_entry__.py:dryrun_multichip on 2 gloo ranks:
    one `dryrun_multichip(2) <graph> OK:` line per graph of
    MULTICHIP_r05.json, in its order, with the global batch's shapes."""
    proc = subprocess.run(
        [sys.executable, "-m", "dpig_tpu_torch.parallel.dryrun", "--n=2"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("dryrun_multichip(2)")]
    assert [ln.split()[1] for ln in lines] == list(dryrun.GRAPHS)
    assert all(" OK: " in ln for ln in lines)
    assert "G(4, 32, 16, 3)" in lines[2] and "G(4, 32, 16, 3)" in lines[4]
