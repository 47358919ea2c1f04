"""Stage-II pose sampler, models 4 and 104 (port of
`dpig_tpu/apps/stage2_pose.py:36-178`; reference trainer.py:870-1033
DPIG_subnetSamplePoseRCV_GAN_BodyROI).

A Gaussian -> pose-code mapper ("PoseGaussian", 32-d, hidden 512) trained
adversarially against the frozen pose AE encoder's codes of the real poses,
with the WGAN schedule of `stage2_app.WganSamplerApp`; the frozen pose AE
decoder turns sampled codes into (r,c,v) poses, rendered on the device
(the CUDA pose kernel on the card) for previews through the frozen
Stage-I nets.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..config import Config
from ..models.discriminators import FCDiscriminator
from ..models.mappers import GaussianMapper
from ..ops.pose import pose_rcv_normalize, render_pose_maps
from ..parallel import dist
from ..train.state import GanState
from .common import select_parts
from .stage1_app import Stage1App
from .stage1_pose import POSE_Z, Stage1PoseApp
from .stage2_app import Batch, WganSamplerApp


class Stage2PoseApp(WganSamplerApp):
    """Model 4: the pose sampler against the frozen `PoseAE`, with the
    frozen Stage-I `Encoder` / `ID_AE` for previews, each taken from
    `frozen` (`restore_subtrees` of --pretrained_poseAE_path and
    --pretrained_path) or fresh from `cfg.random_seed`."""

    def __init__(self, cfg: Config, device: torch.device,
                 frozen: Optional[Mapping] = None):
        super().__init__(cfg, device)
        self.pose_ae = Stage1PoseApp(cfg, device, frozen)
        self.stage1 = Stage1App(cfg, device, state=frozen, disc=False,
                                fg_bg=cfg.img_H < 256)
        self.noise_dims = (POSE_Z,)
        self.mappers = {"PoseGaussian": GaussianMapper(POSE_Z, POSE_Z, 512)}
        self.critics = {"Pose_emb_FCDis": FCDiscriminator(POSE_Z)}
        self.frozen = {"PoseAE": self.pose_ae.nets,
                       "Encoder": self.stage1.encoder,
                       "ID_AE": self.stage1.generator}
        self._init_nets()

    def real_embs(self, batch: Batch) -> Tuple[torch.Tensor]:
        """The frozen pose AE encoder's codes of the batch's normalized
        poses (stage2_pose.py:73-79)."""
        cfg = self.cfg
        rcv_norm = pose_rcv_normalize(batch["pose_rcv"], cfg.img_H, cfg.img_W)
        return (self.pose_ae.encode(rcv_norm.reshape(rcv_norm.shape[0], -1)),)

    def train_step(self, state: GanState, batch: Batch | Sequence[Batch],
                   noise: torch.Tensor,
                   mark: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step (see `WganSamplerApp.wgan_step`) -> `g_loss_embs`,
        `d_loss_embs` (the last critic iteration's) and the two `hist/`
        arrays. JAX's `hist/embs_fake` maps rngs[-1], which is the last
        critic iteration's key, with the G params it already used: the last
        iteration's fakes bit for bit, reused here, not recomputed."""
        (g_l,), (d_l,), (real,), (fake,) = self.wgan_step(state, batch,
                                                          noise, mark)
        metrics = {"g_loss_embs": g_l, "d_loss_embs": d_l,
                   "hist/embs_real": real, "hist/embs_fake": fake}
        return dist.global_metrics({k: v.detach() for k, v in metrics.items()})

    @torch.inference_mode()
    def sample_poses(self, noise: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """noise [b, POSE_Z] -> (decoded rcv [b, K, 3], normalized; its
        radius-4 pose maps), rendered on the device (stage2_pose.py:153-161;
        the pose AE's radius-0 preview is not rendered, nothing reads it)."""
        cfg = self.cfg
        (z,) = self.sample_embs(noise)
        rcv = self.pose_ae.decode_rcv(z)
        return rcv, render_pose_maps(rcv, cfg.img_H, cfg.img_W,
                                     cfg.keypoint_num, radius=4,
                                     normalized=True)

    @torch.inference_mode()
    def preview_step(self, batch: Batch, noise: torch.Tensor) -> torch.Tensor:
        """The batch's people under sampled poses through the frozen
        Stage-I nets (stage2_pose.py:163-178) -> images in [0, 255]."""
        _, pose_maps = self.sample_poses(noise)
        bbox, vis = select_parts(batch["part_bbox"], batch["part_vis"],
                                 self.cfg.roi_part_num)
        embs = self.stage1._encode(batch["x"], batch["mask_r6"], bbox, vis)
        g_raw = self.stage1._generate(embs, pose_maps)
        return torch.clamp((g_raw + 1.0) * 127.5, 0.0, 255.0)
