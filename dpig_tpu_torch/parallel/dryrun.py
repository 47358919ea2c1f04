"""`dryrun_multichip(n)`: the five graphs of the JAX package's data-parallel
dry run (`__graft_entry__.py:dryrun_multichip`, recorded in
MULTICHIP_r05.json) on n ranks of a process group, at its tiny shapes
(32x16 images, batch 2 per rank, hidden 16, z 16): one Stage-I step, one
Stage-II WGAN step (`fresh` batches), a model-11 sampling step, one pose-AE
step and a model-12 transfer step. Every rank holds its rows of one global
batch made from a seed and the same parameters; the serving graphs run
each rank's rows, their D scores normalized by the global batch as on the
JAX package's mesh. Rank 0 prints one `dryrun_multichip(n) <graph> OK:`
line per graph.

    python -m dpig_tpu_torch.parallel.dryrun --n=2          # gloo, CPU
    python -m dpig_tpu_torch.parallel.dryrun --n=2 --platform=   # NCCL
"""
from __future__ import annotations

import argparse
import tempfile
from typing import List

import numpy as np
import torch

from . import dist, spawn

MODULE = "dpig_tpu_torch.parallel.dryrun"
GRAPHS = ("stage1", "stage2-wgan", "model11-sample", "pose-ae",
          "model12-transfer")


def dryrun_multichip(n: int, backend: str = "gloo", platform: str = "cpu",
                     timeout: float = 600.0) -> List[str]:
    """Run the five graphs on n rank processes (`backend`, on `platform`:
    'cpu', or '' for the card) and print rank 0's lines; returns them.
    Raises if a rank fails or the group takes longer than `timeout` s."""
    port = dist.free_port()
    outs = spawn.run_ranks(
        [spawn.python_argv(MODULE, f"--n={n}", f"--rank={r}",
                           f"--port={port}", f"--backend={backend}",
                           f"--platform={platform}") for r in range(n)],
        timeout)
    lines = [ln for ln in outs[0].splitlines()
             if ln.startswith(f"dryrun_multichip({n})")]
    print("\n".join(lines), flush=True)
    if len(lines) != len(GRAPHS):
        raise RuntimeError(f"rank 0 printed {len(lines)} of "
                           f"{len(GRAPHS)} graphs:\n{outs[0][-3000:]}")
    return lines


def _rank_main(n: int, rank: int, port: int, backend: str,
               platform: str) -> None:
    from ..apps.common import select_device

    torch.set_num_threads(1)
    dist.init_distributed(f"127.0.0.1:{port}", n, rank, platform=platform,
                          backend=backend)
    try:
        with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
            _graphs(n, rank, select_device(platform), platform, tmp)
    finally:
        dist.shutdown()


def _graphs(n: int, rank: int, device: torch.device, platform: str,
            tmp: str) -> None:
    """Rank `rank`'s part of the five graphs, model_dir `tmp`."""
    from ..apps.common import batch_to_device
    from ..apps.stage1_app import Stage1App
    from ..apps.stage1_pose import Stage1PoseApp
    from ..apps.stage2_app import Stage2AppApp
    from ..apps.testers import ConditionalTransferTester, FullSamplingTester
    from ..config import Config
    from ..data.synthetic import synthetic_batch

    cfg = Config(img_H=32, img_W=16, batch_size=2 * n, conv_hidden_num=16,
                 z_num=16, model_dir=tmp, platform=platform)
    b = cfg.batch_size

    def local(seed):
        """This rank's rows of the global batch drawn with `seed`."""
        full = synthetic_batch(np.random.default_rng(seed), b, cfg.img_H,
                               cfg.img_W)
        return batch_to_device({k: dist.local_rows(torch.from_numpy(v))
                                .numpy() for k, v in full.items()}, device)

    def say(graph, text):
        if rank == 0:
            print(f"dryrun_multichip({n}) {graph} OK: {text}", flush=True)

    def scalars(metrics, digits):
        out = {k: round(float(v), digits) for k, v in metrics.items()
               if v.dim() == 0}
        for k, v in metrics.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"{k} is not finite: {v}")
        return out

    batch = local(0)
    app = Stage1App(cfg, device)
    state = app.init_state()
    dist.replicate(state.tensors())
    say("stage1", scalars(app.train_step(state, batch), 4))

    s2 = Stage2AppApp(cfg, device, {"Encoder": app.encoder.state_dict(),
                                    "ID_AE": app.generator.state_dict()})
    s2_state = s2.init_state()
    dist.replicate(s2_state.tensors())
    noise = dist.local_rows(s2.step_noise(torch.Generator().manual_seed(3),
                                          b), dim=1)
    batches = tuple(local(10 + i) for i in range(s2.batches_per_step))
    say("stage2-wgan", scalars(s2.train_step(s2_state, batches, noise), 4))

    def served(images, score):
        images, score = dist.gather_rows(images), dist.gather_rows(score)
        if not (torch.isfinite(images).all() and torch.isfinite(score).all()):
            raise AssertionError("non-finite serving outputs")
        if tuple(images.shape) != (b, cfg.img_H, cfg.img_W, 3):
            raise AssertionError(f"images {tuple(images.shape)}")
        return (f"G{tuple(images.shape)} "
                f"score_mean={float(score.mean()):.4f}")

    tester = FullSamplingTester(cfg)
    dist.replicate(_tensors(tester))
    draw = tester.draw_noise(torch.Generator().manual_seed(4), b)
    with torch.inference_mode(), dist.global_batch_stats():
        g, _, score, _ = tester.sample_step(
            batch, {k: dist.local_rows(v) for k, v in draw.items()},
            "sampled")
    say("model11-sample", served(g, score))

    pa = Stage1PoseApp(cfg, device)
    pa_state = pa.init_state()
    dist.replicate(pa_state.tensors())
    say("pose-ae", scalars(pa.train_step(pa_state, batch), 6))

    tt = ConditionalTransferTester(cfg)
    dist.replicate(_tensors(tt))
    with dist.global_batch_stats():
        g12, _, score12 = tt.transfer_step(batch)
    say("model12-transfer", served(g12, score12))


def _tensors(tester) -> List[torch.Tensor]:
    return [t for m in tester.nets().values()
            for t in (*m.parameters(), *m.buffers())]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=2)
    p.add_argument("--rank", type=int, default=-1,
                   help="run one rank (the launcher sets it)")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--backend", default="gloo")
    p.add_argument("--platform", default="cpu")
    a = p.parse_args(argv)
    if a.rank < 0:
        dryrun_multichip(a.n, a.backend, a.platform)
    else:
        _rank_main(a.n, a.rank, a.port, a.backend, a.platform)


if __name__ == "__main__":
    main()
