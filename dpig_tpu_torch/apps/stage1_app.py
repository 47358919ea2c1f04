"""Stage-I appearance reconstruction, inference half (port of
`dpig_tpu/apps/stage1_app.py:34-112,166-176`; reference trainer.py:567-625).

Market 128x64 family: FG/BG two-branch ROI encoder -> 352-d embedding +
18-ch pose map -> U-net generator; DCGAN image discriminator. The training
step (`train_step`) comes with the training slice.
"""
from __future__ import annotations

import contextlib
from typing import Mapping, Optional, Tuple

import torch

from ..bridge import load_state
from ..config import Config
from ..models.discriminators import get_discriminator
from ..models.encoders import RoiEncoderFgBg
from ..models.generator import UAEGenerator
from ..models.layers import init_weights


@contextlib.contextmanager
def full_float32():
    """cuDNN convs and cuBLAS matmuls in float32, not TF32, inside the block
    whatever the caller's flags (PyTorch lets cuDNN convs use TF32 by
    default); the flags are restored after. Also a decorator."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


class Stage1App:
    """Encoder, generator and D of Stage I on `device`, in eval mode.

    Weights are fresh (Xavier / normal(0.02), from a CPU torch.Generator
    seeded with `cfg.random_seed`, so the CPU and the card get the same
    numbers) unless `state` from `bridge.params_from_flax` is given. The
    app owns the precision: `compute_dtype` float32 runs every forward
    under `full_float32`.
    """

    def __init__(self, cfg: Config, device: torch.device,
                 state: Optional[Mapping] = None):
        if cfg.img_H >= 256:
            raise NotImplementedError(
                "the 256x256 family (models 101-104/1001/1002) is not ported "
                "to dpig_tpu_torch yet")
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"--compute_dtype={cfg.compute_dtype}: dpig_tpu_torch runs "
                "float32 only so far")
        self.cfg = cfg
        self.device = device
        self.encoder = RoiEncoderFgBg(
            cfg.img_H, cfg.img_W, part_num=cfg.roi_part_num,
            z_num=cfg.roi_z_num, repeat_num=cfg.repeat_num,
            hidden_num=cfg.conv_hidden_num, roi_size=48)
        self.generator = UAEGenerator(
            cfg.img_H, cfg.img_W,
            emb_dim=cfg.roi_part_num * cfg.roi_z_num + cfg.roi_z_num * 4,
            pose_ch=cfg.keypoint_num, out_channels=3, z_num=cfg.z_num,
            repeat_num=cfg.repeat_num, hidden_num=cfg.conv_hidden_num)
        self.disc = get_discriminator(cfg.D_arch, cfg.img_H, cfg.img_W,
                                      n_stages=4)
        modules = (self.encoder, self.generator, self.disc)
        if state is None:
            gen = torch.Generator().manual_seed(cfg.random_seed)
            for m in modules:
                init_weights(m, gen)
        else:
            load_state(*modules, state)
        for m in modules:
            m.to(device).eval().requires_grad_(False)

    # ------------------------------------------------------------ forward
    @full_float32()
    def _encode(self, x, mask, bbox, vis) -> torch.Tensor:
        return self.encoder(x, mask, bbox, vis)

    @full_float32()
    def _generate(self, embs, pose) -> torch.Tensor:
        g_raw, _ = self.generator(embs, pose)
        return g_raw

    def g_forward(self, x, pose, mask, bbox, vis
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (g_raw [B,H,W,3] float32, embs [B,352])."""
        embs = self._encode(x, mask, bbox, vis)
        return self._generate(embs, pose), embs

    @full_float32()
    def _disc_apply(self, img, train: bool = True) -> torch.Tensor:
        return self.disc(img, train=train)

    # ----------------------------------------------------------- generate
    @torch.inference_mode()
    def generate_step(self, x, pose, mask, bbox, vis) -> torch.Tensor:
        """Reconstruction preview -> [0,255] images (trainer.py:514-526)."""
        g_raw, _ = self.g_forward(x, pose, mask, bbox, vis)
        return torch.clamp((g_raw + 1.0) * 127.5, 0.0, 255.0)

    def transfer_step(self, x, pose_target, mask, bbox, vis) -> torch.Tensor:
        """PG2-style conditional transfer (tester.py:677-681): encode the
        source appearance, decode under the *target* pose."""
        return self.generate_step(x, pose_target, mask, bbox, vis)
