"""Training harness (port of `dpig_tpu/train/harness.py`; the reference's
train() loop, trainer.py:326-366): fixed-batch previews, periodic metrics
logging, periodic checkpoints, auto-resume. The LR schedule lives in the
optimizers (`train/state.py`).

Observability: metrics go to `<model_dir>/metrics.jsonl` and stdout, the
`hist/` embedding arrays of the Stage-II samplers as their mean and
standard deviation (harness.py:71-82), previews to PNG grids with the mean
SSIM in the file name (trainer.py:522-524). The same scalars (`loss/<k>`)
and histograms go to a TensorBoard event file in model_dir
(`train/events.py`, no TensorFlow needed), as the JAX package writes them
through tf.summary where TF imports (harness.py:37-46,84-92).

Across processes (`parallel.dist`) every rank runs the same loop on its
own loader's batches (its rows of the global batch) and its rows of the
global step noise; the steps return the global metrics. Rank 0 alone
writes metrics.jsonl, the previews and the checkpoints; every rank runs
the previews' forwards, so the noise generator stays the same on every
rank.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..apps.common import batch_to_device
from ..config import Config
from ..eval.metrics import ssim_images
from ..ops.pose import render_pose_maps
from ..parallel import dist
from ..utils import spans
from ..utils.viz import pose_to_gray, save_image
from . import checkpoint as ckpt
from .events import EventWriter
from .state import GanState


class Trainer:
    """Drives an app exposing `device`, `init_state()` and
    `train_step(state, batch)` on the loader's numpy batches. An app with
    `batches_per_step` n > 1 gets a tuple of n batches per step; an app
    with `step_noise(gen, b)` (the Stage-II samplers) also gets each step's
    noise, drawn from `noise_gen`, one CPU generator seeded with
    `cfg.random_seed` (the previews draw from it too)."""

    def __init__(self, cfg: Config, app: Any,
                 loader: Iterator[Dict[str, np.ndarray]]):
        self.cfg = cfg
        self.app = app
        self.loader = loader
        self.noise_gen = torch.Generator().manual_seed(cfg.random_seed)
        os.makedirs(cfg.model_dir, exist_ok=True)
        self.metrics_path = os.path.join(cfg.model_dir, "metrics.jsonl")
        self.events: Optional[EventWriter] = None  # opened by the first log

    # ------------------------------------------------------------- state
    def init_state(self) -> GanState:
        """The app's state, restored from --ckpt_path or auto-resumed from
        the newest checkpoint in model_dir. Across ranks every rank
        restores, the ranks must agree on the step, and rank 0's
        parameters, buffers and optimizer moments are given to all."""
        state = self.app.init_state()
        if self.cfg.ckpt_path:
            state = ckpt.restore_into_state(self.cfg.ckpt_path, state)
        else:
            # Preemption-safe auto-resume from the newest checkpoint in
            # model_dir (the reference needs --ckpt_path + --start_step).
            latest = ckpt.latest_checkpoint(self.cfg.model_dir)
            if latest:
                state = ckpt.restore_into_state(latest, state)
                if dist.rank() == 0:
                    print(f"[*] auto-resumed from {latest} (step "
                          f"{state.step})", flush=True)
        dist.same_on_all_ranks(state.step, "the step to resume from")
        dist.replicate(state.tensors())
        return state

    # --------------------------------------------------------------- log
    def log_metrics(self, step: int, metrics: Dict[str, float],
                    hists: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Scalars, and each array of `hists` as `<name>_mean` /
        `<name>_std` (float64, as the JAX package), to metrics.jsonl and
        stdout; the scalars as `loss/<k>` and each array as a histogram to
        the event file."""
        if dist.rank() != 0:
            return
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        for name, arr in (hists or {}).items():
            flat = np.asarray(arr, np.float64).ravel()
            rec[f"{name}_mean"] = float(flat.mean())
            rec[f"{name}_std"] = float(flat.std())
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.events is None:
            self.events = EventWriter(self.cfg.model_dir)
        self.events.scalars(step, {f"loss/{k}": v for k, v in rec.items()
                                   if k != "step"})
        for name, arr in (hists or {}).items():
            self.events.histogram(step, name, arr)
        self.events.flush()
        print(f"[{step}] " + " ".join(f"{k}={v:.4f}" for k, v in rec.items()
                                      if k != "step"), flush=True)

    # ------------------------------------------------------------ loop
    def train(self, preview_fn: Optional[Callable] = None) -> GanState:
        """Steps from the state's step to cfg.max_step. `preview_fn(state,
        fixed_batch, step)` runs at step 0 and every 3*log_step steps."""
        cfg = self.cfg
        state = self.init_state()

        fixed_batch = next(self.loader)
        self._save_fixed_previews(fixed_batch)

        start = state.step
        t_last = time.time()
        last_logged = start - 1  # the first interval covers its own steps
        for step in range(start, cfg.max_step):
            metrics = self.step(state)

            if step == 0 or step % cfg.log_step == cfg.log_step - 1:
                # Host floats first: the steps are queued on the card, and
                # reading the losses waits for them, so the rate below
                # covers finished steps. It counts batch_size images per
                # step, as the JAX package does, whatever the step reads.
                vals = {k: float(v) for k, v in metrics.items()
                        if not k.startswith("hist/")}
                hists = {k[5:]: v.cpu().numpy() for k, v in metrics.items()
                         if k.startswith("hist/")}
                now = time.time()
                ips = (cfg.batch_size * (step - last_logged)
                       / max(now - t_last, 1e-9))
                t_last = now
                last_logged = step
                self.log_metrics(step, {**vals, "imgs_per_sec": ips}, hists)

            every = cfg.log_step * 3
            if preview_fn is not None and (step == 0
                                           or step % every == every - 1):
                preview_fn(state, fixed_batch, step)

            if step % (cfg.log_step * 30) == cfg.log_step * 30 - 1:
                ckpt.save_checkpoint(cfg.model_dir, step, state)

        ckpt.save_checkpoint(cfg.model_dir, cfg.max_step, state)
        if self.events is not None:
            self.events.close()
        return state

    def step(self, state: GanState) -> Dict[str, Any]:
        """One train step on the next loader batch (a tuple of
        `batches_per_step` batches, and the step's noise, where the app
        takes them), copied to the app's device (the span `trainer.step`
        around it all)."""
        app = self.app
        n = getattr(app, "batches_per_step", 1)
        with spans.span("trainer.step"):
            batch = tuple(batch_to_device(next(self.loader), app.device)
                          for _ in range(n))
            args = (batch if n > 1 else batch[0],)
            if hasattr(app, "step_noise"):  # this rank's rows of the draw
                args += (dist.local_rows(app.step_noise(
                    self.noise_gen, self.cfg.batch_size), dim=1),)
            return app.train_step(state, *args)

    # ------------------------------------------------------- previews
    def _save_fixed_previews(self, batch: Dict[str, np.ndarray]) -> None:
        """x, x_target, mask and the pose map (rendered on the app's
        device) of the fixed preview batch; rank 0's."""
        if dist.rank() != 0:
            return
        cfg, d = self.cfg, self.cfg.model_dir
        save_image((batch["x"] + 1.0) * 127.5, f"{d}/x_fixed.png")
        save_image((batch["x_target"] + 1.0) * 127.5,
                   f"{d}/x_target_fixed.png")
        rcv = batch_to_device({"pose_rcv": batch["pose_rcv"]},
                              self.app.device)["pose_rcv"]
        pose = render_pose_maps(rcv, cfg.img_H, cfg.img_W, cfg.keypoint_num,
                                radius=4, normalized=False)
        save_image(pose_to_gray(pose.cpu().numpy()), f"{d}/pose_fixed.png")
        save_image(batch["mask_r6"] * 255.0, f"{d}/mask_fixed.png")

    def preview_with_ssim(self, images_0_255: np.ndarray,
                          x_ref: np.ndarray, step: int,
                          tag: str = "G") -> Optional[str]:
        """Save a preview grid with the mean grayscale SSIM against x in
        the filename (rank 0; the others return None)."""
        if dist.rank() != 0:
            return None
        ssim_mean = float(np.mean(ssim_images(
            images_0_255, (x_ref + 1.0) * 127.5)))
        path = os.path.join(self.cfg.model_dir,
                            f"{step}_{tag}_ssim{ssim_mean:.4f}.png")
        save_image(images_0_255, path)
        print(f"[*] Samples saved: {path}", flush=True)
        return path
