"""Stage-II appearance samplers, model 3 (port of
`dpig_tpu/apps/stage2_app.py:42-220`; reference trainer.py:715-867
DPIG_Encoder_subSampleAppNetFgBg_GAN_BodyROI), and the WGAN schedule that
the pose sampler (`stage2_pose.py`, model 4) shares.

Two Gaussian -> embedding mappers (FG: 7*32-d out, hidden 512; BG: 128-d
out, hidden 256) trained adversarially in embedding space against the
frozen Stage-I encoder's embeddings: WGAN, RMSProp, one G update of the
mappers, then CRITIC_ITERS critic iterations, each on fresh fakes from the
updated mappers, each followed by clipping every critic parameter to
+-0.01. Market only (the FG/BG split); DeepFashion's single mapper (model
103) is `stage2_app_single.py`.

Batch forms, as in the JAX package: a sequence of 1+CRITIC_ITERS batches
(`--critic_batch_mode=fresh`, the default: batches[0] feeds the G update
and the hists, batches[1+i] critic iteration i) or one batch (`reused`:
every critic iteration reuses it). Noise: JAX draws it inside its jitted
step with threefry, which torch cannot reproduce, so the step takes the
whole step's mapper noise as one tensor (`step_noise`: G draw, then one
draw per critic iteration), which the Trainer draws from one CPU
generator and copies to the card at once.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..config import Config
from ..losses import gan
from ..models.discriminators import FCDiscriminator
from ..models.layers import init_weights
from ..models.mappers import GaussianMapper, sample_mapper_noise
from ..parallel import dist
from ..train.state import GanState
from .common import critic_batches_per_step, pose_maps_from_batch, select_parts
from .stage1_app import Stage1App, full_float32

GAN_MODE = "wgan"  # trainer.py:720-725, 875
STAGE2_PHASES = ("real_embs", "g_forward_backward", "g_update",
                 "critic_forward_backward", "d_update", "clip")

Batch = Mapping[str, torch.Tensor]


class WganSamplerApp:
    """The Stage-II WGAN schedule over named mappers and critics, one
    critic per mapper. A subclass builds `mappers` and `critics` (dicts in
    the same order, mapper i trained against critic i), `frozen` (the
    nets the state carries untrained) and `noise_dims` (each mapper's
    noise width), and defines `real_embs(batch)` -> one tensor per
    critic."""

    mappers: Dict[str, torch.nn.Module]
    critics: Dict[str, torch.nn.Module]
    frozen: Dict[str, torch.nn.Module]
    noise_dims: Tuple[int, ...]

    def __init__(self, cfg: Config, device: torch.device):
        self.cfg = cfg
        self.device = device
        # How many loader batches the Trainer feeds train_step.
        self.batches_per_step = critic_batches_per_step(cfg)

    def _init_nets(self) -> None:
        """Fresh mappers (Xavier) and critics (normal(0.02)) from a CPU
        generator seeded with `cfg.random_seed`, in that order, then on the
        device, frozen until `init_state`."""
        gen = torch.Generator().manual_seed(self.cfg.random_seed)
        for m in (*self.mappers.values(), *self.critics.values()):
            init_weights(m, gen)
            m.to(self.device).eval().requires_grad_(False)

    def real_embs(self, batch: Batch) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    # --------------------------------------------------------------- noise
    @property
    def noise_dim(self) -> int:
        return sum(self.noise_dims)

    def step_noise(self, gen: torch.Generator, b: int) -> torch.Tensor:
        """[1+CRITIC_ITERS, b, noise_dim] mapper noise for one step, drawn
        from `gen` and copied to the device in one copy."""
        return sample_mapper_noise(gen, (1 + gan.CRITIC_ITERS) * b,
                                   self.noise_dim, self.device).view(
                                       1 + gan.CRITIC_ITERS, b, -1)

    @full_float32()
    def sample_embs(self, noise: torch.Tensor) -> List[torch.Tensor]:
        """noise [b, noise_dim] -> each mapper's embeddings."""
        zs = torch.split(noise, list(self.noise_dims), dim=-1)
        return [m(z) for m, z in zip(self.mappers.values(), zs)]

    # --------------------------------------------------------------- train
    def init_state(self) -> GanState:
        """Make the mappers and critics trainable and wrap them with
        RMSProp; the frozen nets ride along untrained."""
        cfg = self.cfg
        for m in (*self.mappers.values(), *self.critics.values()):
            m.requires_grad_(True)
        return GanState.create(
            g_nets=self.mappers, d_nets=self.critics,
            frozen_nets=self.frozen, mode=GAN_MODE, g_lr=cfg.g_lr,
            d_lr=cfg.d_lr, lr_update_step=cfg.lr_update_step,
            step=cfg.start_step)

    @full_float32()
    def wgan_step(self, state: GanState,
                  batch: Batch | Sequence[Batch], noise: torch.Tensor,
                  mark: Optional[Callable[[str], None]] = None):
        """One G update of every mapper on the sum of their critics' WGAN G
        losses, then CRITIC_ITERS critic iterations (stage2_app.py:140-183,
        stage2_pose.py:111-144), in place on `state`; state.step += 1.
        Returns (G losses, last iteration's D losses, batch 0's real
        embeddings, last iteration's fakes), one entry per critic.
        Across ranks (`parallel.dist`) the batches and the noise are this
        rank's rows of the global ones (the Trainer draws the global noise
        on every rank and slices it), the optimizers average the
        gradients, and the clip follows the averaged update, so the
        critics stay replicated; the train steps return the global
        metrics.
        `mark(phase)`, if given, is called after each phase of
        STAGE2_PHASES is enqueued, the last three once per iteration."""
        mark = mark or (lambda phase: None)
        batches = (tuple(batch) if isinstance(batch, (list, tuple))
                   else (batch,))
        critics = list(self.critics.values())
        with torch.no_grad():  # not inference_mode: the critics save them
            reals = [self.real_embs(b) for b in batches]
        critic_reals = reals[1:] or reals * gan.CRITIC_ITERS
        mark("real_embs")

        fakes = self.sample_embs(noise[0])
        g_losses = [gan.g_loss(GAN_MODE, d(f)) for d, f in zip(critics, fakes)]
        g_grads = torch.autograd.grad(sum(g_losses), state.g_params)
        mark("g_forward_backward")
        state.g_opt.step(g_grads)
        mark("g_update")

        for i in range(gan.CRITIC_ITERS):
            with torch.no_grad():
                fakes = self.sample_embs(noise[1 + i])
            d_losses = [gan.d_loss(GAN_MODE, d(r), d(f))
                        for d, r, f in zip(critics, critic_reals[i], fakes)]
            d_grads = torch.autograd.grad(sum(d_losses), state.d_params)
            mark("critic_forward_backward")
            state.d_opt.step(d_grads)
            mark("d_update")
            gan.clip_params(state.d_params)
            mark("clip")
        state.step += 1
        return g_losses, d_losses, reals[0], fakes


class Stage2AppApp(WganSamplerApp):
    """Model 3: the FG and BG appearance samplers against the frozen
    Stage-I `Encoder` (and `ID_AE` for the previews), taken from `frozen`
    (`restore_subtrees(--pretrained_path, ['Encoder', 'ID_AE'])`) or fresh
    from `cfg.random_seed` on a cold start."""

    def __init__(self, cfg: Config, device: torch.device,
                 frozen: Optional[Mapping] = None):
        super().__init__(cfg, device)
        self.stage1 = Stage1App(cfg, device, state=frozen, disc=False)
        self.fg_dim = cfg.roi_part_num * cfg.roi_z_num          # 224
        self.bg_dim = cfg.roi_z_num * 4                          # 128
        self.noise_dims = (self.fg_dim, self.bg_dim)
        self.mappers = {
            "Gaussian_FC_Fg": GaussianMapper(self.fg_dim, self.fg_dim, 512),
            "Gaussian_FC_Bg": GaussianMapper(self.bg_dim, self.bg_dim, 256)}
        self.critics = {"Fg_FCDis": FCDiscriminator(self.fg_dim),
                        "Bg_FCDis": FCDiscriminator(self.bg_dim)}
        self.frozen = {"Encoder": self.stage1.encoder,
                       "ID_AE": self.stage1.generator}
        self._init_nets()

    def real_embs(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Frozen-encoder embeddings split FG/BG (trainer.py:741-742)."""
        bbox, vis = select_parts(batch["part_bbox"], batch["part_vis"],
                                 self.cfg.roi_part_num)
        embs = self.stage1._encode(batch["x"], batch["mask_r6"], bbox, vis)
        return embs[:, :self.fg_dim], embs[:, self.fg_dim:]

    def train_step(self, state: GanState, batch: Batch | Sequence[Batch],
                   noise: torch.Tensor,
                   mark: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step (see `wgan_step`) -> the G losses, the last critic
        iteration's D losses and the four `hist/` embedding arrays, the
        fake ones being the last critic iteration's fakes, as in JAX."""
        (gl_fg, gl_bg), (dl_fg, dl_bg), (real_fg, real_bg), (
            fake_fg, fake_bg) = self.wgan_step(state, batch, noise, mark)
        metrics = {"g_loss_embs_fg": gl_fg, "g_loss_embs_bg": gl_bg,
                   "d_loss_embs_fg": dl_fg, "d_loss_embs_bg": dl_bg,
                   "hist/embs_real_fg": real_fg, "hist/embs_fake_fg": fake_fg,
                   "hist/embs_real_bg": real_bg, "hist/embs_fake_bg": fake_bg}
        return dist.global_metrics({k: v.detach() for k, v in metrics.items()})

    @torch.inference_mode()
    def preview_step(self, batch: Batch, noise: torch.Tensor) -> torch.Tensor:
        """Fix-FG / vary-BG composition through the frozen generator under
        the batch's pose maps (stage2_app.py:197-220; trainer.py:779-793):
        the first half of the batch holds sample 0's FG code with varying
        BG, the second half varies FG under sample 0's BG. noise [b,
        noise_dim] -> images in [0, 255]."""
        b = batch["x"].shape[0]
        pose = pose_maps_from_batch(batch, self.cfg)
        fg, bg = self.sample_embs(noise)
        half = b // 2
        app = torch.cat([
            torch.cat([fg[:1].expand(half, -1), fg[half:]], 0),
            torch.cat([bg[half:], bg[:1].expand(half, -1)], 0)], -1)
        g_raw = self.stage1._generate(app, pose)
        return torch.clamp((g_raw + 1.0) * 127.5, 0.0, 255.0)
