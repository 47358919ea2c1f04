"""The CLI twin at world size 2 on the CPU (gloo, one process per rank) for
every training model: `python -m dpig_tpu_torch.main --model=<m>
--platform=cpu --num_processes=2 --process_id=<r>
--coordinator_address=127.0.0.1:<port>`, Market models 2, 3, 4 at 32x16
and the DeepFashion models 101-104 at 256x256 narrow, one step each; and
torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) with
--process_id=-1, with and without --num_processes. Model 1 runs in
tests/test_torch_ddp_stage2.py.
"""
import json
import os

import pytest
import torch

from dpig_tpu_torch.parallel import dist, spawn

torch.set_num_threads(1)

MARKET = ["--img_H=32", "--img_W=16", "--conv_hidden_num=16", "--z_num=16"]
DF256 = ["--img_H=256", "--img_W=256", "--conv_hidden_num=4", "--z_num=4"]
COMMON = ["--platform=cpu", "--synthetic_data=true", "--batch_size=4",
          "--max_step=1", "--log_step=1"]


def _check_run(d, outs, model):
    """Rank 0 wrote metrics.jsonl (step 0, finite), params.json and the
    final checkpoint; rank 1 logged nothing."""
    assert f"MODEL dir: {d}" in outs[0] and "MODEL dir" not in outs[1]
    with open(os.path.join(d, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["step"] for r in recs] == [0], model
    assert all(v == v and abs(v) < float("inf") for v in recs[0].values())
    assert os.path.exists(os.path.join(d, "ckpt", "step_00000001",
                                       "state.pt"))


@pytest.mark.parametrize("model", [2, 3, 4, 101, 102, 103, 104])
def test_cli_trains_at_world_2(tmp_path, model):
    d = str(tmp_path / f"m{model}")
    size = DF256 if model > 100 else MARKET
    port = dist.free_port()
    outs = spawn.run_ranks([spawn.python_argv(
        "dpig_tpu_torch.main", f"--model={model}", *COMMON, *size,
        f"--model_dir={d}", "--num_processes=2", f"--process_id={r}",
        f"--coordinator_address=127.0.0.1:{port}") for r in range(2)],
        timeout=240)
    _check_run(d, outs, model)


@pytest.mark.parametrize("flags", [["--num_processes=2"], []])
def test_cli_takes_the_rank_from_torchruns_environment(tmp_path, flags):
    """--process_id=-1 (the default) with RANK / WORLD_SIZE / MASTER_ADDR /
    MASTER_PORT set per process, as torchrun sets them, and no address;
    with --num_processes=2 or without it (the world size from
    WORLD_SIZE)."""
    d = str(tmp_path / "m2")
    port = dist.free_port()
    argv = spawn.python_argv("dpig_tpu_torch.main", "--model=2", *COMMON,
                             *MARKET, f"--model_dir={d}", *flags)
    outs = spawn.run_ranks([argv, argv], timeout=240, rank_env=[
        {"RANK": str(r), "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
         "MASTER_PORT": str(port)} for r in range(2)])
    _check_run(d, outs, 2)
