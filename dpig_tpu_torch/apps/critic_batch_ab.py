"""Stage-2 critic-batch equivalence A/B: the port's twin of
`scripts/critic_batch_ab.py`.

The reference pulls a FRESH queue batch for every critic sess.run
(trainer.py:821-845); the `reused` step reuses the step's batch across the
5 critic iterations (fresh mapper noise each). This trains the WGAN
embedding samplers (model 3, `apps/stage2_app.py`) both ways from
identical init and seeds and compares the critic's Wasserstein estimate
and the fake-vs-real embedding moment match.

  python -m dpig_tpu_torch.apps.critic_batch_ab [steps] [batch_size] \
      [seed] [--platform=cpu]

`seed` (default 0) offsets every random stream (init, loader, noise), so
independent replications are cheap. The config is the JAX script's tiny
one (32x16, hidden 16, z 16); all cost is in the frozen-encoder forward
(6x per step in fresh mode vs 1x reused). It runs on the card unless
`--platform=cpu` is given. The noise comes from two CPU torch.Generators
seeded from `seed` (the steps', then the moment match's), so the card and
the CPU draw the same numbers; JAX draws its own with threefry.
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

MOMENT_SAMPLES = 512


def run(mode: str, steps: int, batch_size: int, seed: int = 0,
        platform: str = "", params: Optional[Mapping] = None,
        noise: Optional[Callable[[str, int], torch.Tensor]] = None
        ) -> Dict[str, float]:
    """Train `steps` steps in `mode` ('fresh' or 'reused') and return the
    W tails and the moment gaps over MOMENT_SAMPLES embeddings.

    `params` ({sub-tree: state dict}: Encoder, ID_AE, the two mappers and
    the two critics) replaces the fresh init drawn from `seed`, and
    `noise(kind, i)` the drawn noise: kind 'step' gives step i's
    [1+CRITIC_ITERS, b, noise_dim] (`Stage2AppApp.step_noise`), kind
    'sample' the moment match's draw i, [b, noise_dim]. The tests hand
    the port the JAX package's init and threefry noise through them."""
    from ..config import Config
    from ..data.synthetic import SyntheticLoader
    from ..losses import gan
    from ..models.mappers import sample_mapper_noise
    from .common import batch_to_device, select_device
    from .stage2_app import Stage2AppApp

    if mode not in ("fresh", "reused"):
        raise ValueError(f"mode must be 'fresh' or 'reused', got {mode!r}")
    cfg = Config(img_H=32, img_W=16, batch_size=batch_size,
                 conv_hidden_num=16, z_num=16, synthetic_data=True,
                 critic_batch_mode=mode, random_seed=100 * seed,
                 platform=platform)
    device = select_device(platform)
    app = Stage2AppApp(cfg, device, params)
    if params is not None:
        for name, net in {**app.mappers, **app.critics}.items():
            net.load_state_dict(params[name], strict=True)
    state = app.init_state()
    loader = SyntheticLoader(batch_size, cfg.img_H, cfg.img_W, seed=7 + seed)
    step_gen = torch.Generator().manual_seed(100 * seed + 1)
    sample_gen = torch.Generator().manual_seed(100 * seed + 2)

    n_per_step = 1 + gan.CRITIC_ITERS if mode == "fresh" else 1
    curve = []
    for i in range(steps):
        bs = [batch_to_device(next(loader), device)
              for _ in range(n_per_step)]
        z = (noise("step", i).to(device) if noise is not None
             else app.step_noise(step_gen, batch_size))
        m = app.train_step(state, bs if mode == "fresh" else bs[0], z)
        # WGAN critic loss = E[D(fake)] - E[D(real)]; its negative is the
        # Wasserstein estimate the reference logs per critic.
        curve.append((float(m["d_loss_embs_fg"]), float(m["d_loss_embs_bg"])))
        if i % 200 == 199:
            w = np.asarray(curve[-200:])
            print(f"  [{i}] W_fg={-w[:, 0].mean():.4f} "
                  f"W_bg={-w[:, 1].mean():.4f}", flush=True)

    # moment match: 512 fake embeddings vs 512 real embeddings, the
    # draws in JAX's order (noise i, then loader batch i) and each side
    # through its nets in one batch
    n = max(1, -(-MOMENT_SAMPLES // batch_size))
    zs = [noise("sample", i) if noise is not None
          else sample_mapper_noise(sample_gen, batch_size, app.noise_dim,
                                   torch.device("cpu")) for i in range(n)]
    real_batches = [next(loader) for _ in range(n)]
    with torch.no_grad():
        fakes = app.sample_embs(torch.cat(zs).to(device))
        reals = app.real_embs(batch_to_device(
            {k: np.concatenate([b[k] for b in real_batches])
             for k in real_batches[0]}, device))
    fakes = dict(zip(("fg", "bg"), (f.cpu().numpy() for f in fakes)))
    reals = dict(zip(("fg", "bg"), (r.cpu().numpy() for r in reals)))
    out = {}
    for name in ("fg", "bg"):
        fk = fakes[name][:MOMENT_SAMPLES]
        rl = reals[name][:MOMENT_SAMPLES]
        out[f"mean_gap_{name}"] = float(
            np.abs(fk.mean(0) - rl.mean(0)).mean())
        out[f"std_gap_{name}"] = float(
            np.abs(fk.std(0) - rl.std(0)).mean())
    w = np.asarray(curve[-max(200, steps // 4):])
    out["W_fg_tail"] = float(-w[:, 0].mean())
    out["W_bg_tail"] = float(-w[:, 1].mean())
    loader.close()
    return out


def main(argv=None) -> Dict[str, Dict[str, float]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", nargs="?", type=int, default=2000)
    ap.add_argument("batch_size", nargs="?", type=int, default=16)
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("--platform", default="",
                    help="'cpu' to run on the CPU; the card by default")
    a = ap.parse_args(argv)
    results = {}
    for mode in ("reused", "fresh"):
        print(f"=== mode={mode} ({a.steps} steps, bs{a.batch_size}, "
              f"seed{a.seed})", flush=True)
        results[mode] = run(mode, a.steps, a.batch_size, a.seed, a.platform)
    print(f"\n{'metric':16s} {'reused':>10s} {'fresh':>10s}")
    for k in results["reused"]:
        print(f"{k:16s} {results['reused'][k]:10.4f} "
              f"{results['fresh'][k]:10.4f}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
