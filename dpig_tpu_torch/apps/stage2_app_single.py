"""Stage-II appearance sampler with one mapper, model 103 (port of
`dpig_tpu/apps/stage2_app_single.py:27-139`; reference
trainer_256.py:266-403 DPIG_Encoder_subSampleAppNet_GAN_BodyROI_256).

DeepFashion has no FG/BG split: one Gaussian -> embedding mapper
(`Gaussian_FC`, 7*32-d out, hidden 512) is trained adversarially against
the frozen single-branch Stage-I encoder's whole appearance code, with one
FC critic (`FCDis`), on the WGAN schedule of
`stage2_app.WganSamplerApp` (RMSProp, 5 critic iterations, the +-0.01
clip, `fresh` or `reused` batches). The step's noise is one tensor
`[1+CRITIC_ITERS, b, 224]` (`step_noise`), as for model 3.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..config import Config
from ..models.discriminators import FCDiscriminator
from ..models.mappers import GaussianMapper
from ..parallel import dist
from ..train.state import GanState
from .common import pose_maps_from_batch, select_parts
from .stage1_app import Stage1App
from .stage2_app import Batch, WganSamplerApp


class Stage2AppSingleApp(WganSamplerApp):
    """Model 103: the single appearance sampler against the frozen
    Stage-I `Encoder` (and `ID_AE` for the previews), taken from `frozen`
    (`restore_subtrees(--pretrained_path, ['Encoder', 'ID_AE'])`) or
    fresh from `cfg.random_seed` on a cold start."""

    def __init__(self, cfg: Config, device: torch.device,
                 frozen: Optional[Mapping] = None):
        super().__init__(cfg, device)
        self.stage1 = Stage1App(cfg, device, state=frozen, disc=False,
                                fg_bg=False)
        self.app_dim = cfg.roi_part_num * cfg.roi_z_num          # 224
        self.noise_dims = (self.app_dim,)
        self.mappers = {"Gaussian_FC": GaussianMapper(self.app_dim,
                                                      self.app_dim, 512)}
        self.critics = {"FCDis": FCDiscriminator(self.app_dim)}
        self.frozen = {"Encoder": self.stage1.encoder,
                       "ID_AE": self.stage1.generator}
        self._init_nets()

    def real_embs(self, batch: Batch) -> Tuple[torch.Tensor]:
        """The frozen encoder's appearance codes (stage2_app_single.py:
        64-70)."""
        bbox, vis = select_parts(batch["part_bbox"], batch["part_vis"],
                                 self.cfg.roi_part_num)
        return (self.stage1._encode(batch["x"], batch["mask_r6"], bbox,
                                    vis),)

    def train_step(self, state: GanState, batch: Batch | Sequence[Batch],
                   noise: torch.Tensor,
                   mark: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step (see `WganSamplerApp.wgan_step`) -> `g_loss_embs` and
        the last critic iteration's `d_loss_embs`, the two metrics JAX's
        step returns (stage2_app_single.py:133)."""
        (g_l,), (d_l,), _, _ = self.wgan_step(state, batch, noise, mark)
        return dist.global_metrics({"g_loss_embs": g_l.detach(),
                                    "d_loss_embs": d_l.detach()})

    @torch.inference_mode()
    def preview_step(self, batch: Batch, noise: torch.Tensor) -> torch.Tensor:
        """Sampled appearance codes through the frozen generator under the
        batch's pose maps (stage2_app_single.py:135-146). noise [b, 224]
        -> images in [0, 255]."""
        pose = pose_maps_from_batch(batch, self.cfg)
        (app,) = self.sample_embs(noise)
        g_raw = self.stage1._generate(app, pose)
        return torch.clamp((g_raw + 1.0) * 127.5, 0.0, 255.0)
