"""Inference testers (port of `dpig_tpu/apps/testers.py`, float32): model
11 full sampling, model 12 pose transfer, model 13 factor sampling (Market
only) and factor interpolation.

Each writes the PNG directory tree that score.py consumes. Weights come
from `params` (a `bridge.params_from_flax` state holding the tester's
`SUBTREES`) or else from the port checkpoints the `--pretrained_*` flags
name (`train.checkpoint.compose_pretrained`); sub-trees the tester needs
and neither gives are fresh, loudly. As in the JAX package, the D scores
the images only if a `Discriminator` was given or the nets are fresh;
otherwise the scores are zeros (testers.py:94-106,277-284).

Random draws: the JAX package draws mapper noise with threefry from
PRNGKey(0); the port cannot reproduce those numbers, so the sampling steps
take their noise as tensors (`draw_noise`), and `run()` draws it from one
CPU torch.Generator seeded 0, so the card and the CPU write the same trees
from the same weights.

`pose_source` (model 11) selects the pose the generator sees:
  'real'          — the dataset pose, rendered from pixel coords
                    (reference sample_pose=False);
  'reconstructed' — the pose AE's decoding of the real pose's code
                    (reference sample_pose=True, tester.py:93-95);
  'sampled'       — the pose AE's decoding of PoseGaussian(noise), the
                    paper's intended sampler (trainer.py:894-904).

Each `run()` takes `n` batches with `next(loader)`, as the JAX package's
do: a finite test split that ends first raises StopIteration out of
`run()`, after the batches it had were written.

Work whose result a step does not use is not done (XLA drops it from the
JAX package's jitted steps): the ROI encoder when every appearance code is
sampled, the mappers when none is, and the pose AE's radius-0 preview.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from ..bridge import STAGE1_SUBTREES
from ..config import Config
from ..eval.metrics import ssim_images
from ..models.layers import init_weights
from ..models.mappers import GaussianMapper, sample_mapper_noise
from ..ops.image import slerp
from ..ops.pose import pose_rcv_normalize, render_pose_maps
from ..train.checkpoint import compose_pretrained
from ..utils.viz import pose_to_gray, save_image
from .common import (batch_to_device, pose_maps_from_batch,
                     select_device, select_parts)
from .stage1_app import Stage1App, full_float32
from .stage1_pose import POSE_Z, Stage1PoseApp


def _save_dir_tree(root: str, names) -> Dict[str, str]:
    dirs = {}
    for n in names:
        d = os.path.join(root, n)
        os.makedirs(d, exist_ok=True)
        dirs[n] = d
    return dirs


def _save_batch_pngs(dirs: Dict[str, str], arrays: Dict[str, np.ndarray],
                     start_idx: int) -> None:
    for name, arr in arrays.items():
        for j in range(arr.shape[0]):
            img = np.clip(arr[j], 0, 255).astype(np.uint8)
            if img.ndim == 3 and img.shape[-1] == 1:
                img = img[..., 0]
            Image.fromarray(img).save(
                os.path.join(dirs[name], f"{start_idx + j:05d}.png"))


class _TesterBase:
    """Stage-I nets on the device `cfg.platform` names ('' = the card), and
    the sampling nets its `SUBTREES` name: the pose AE (`PoseAE`) and the
    Gaussian mappers (`PoseGaussian`, `Gaussian_FC_Fg`, `Gaussian_FC_Bg`).
    A sampling net missing from the weights is fresh from one CPU
    torch.Generator seeded with `cfg.random_seed`, in that order, so the
    card and the CPU get the same numbers."""

    SUBTREES = STAGE1_SUBTREES
    MAPPERS = ("PoseGaussian", "Gaussian_FC_Fg", "Gaussian_FC_Bg")

    def __init__(self, cfg: Config, params: Optional[Mapping] = None):
        if cfg.inference_dtype == "int8":
            raise NotImplementedError(
                "--inference_dtype=int8 needs models/quant.py and its s8 conv "
                "kernel, not ported to dpig_tpu_torch yet (ROADMAP §1, "
                '"The int8 serving path")')
        self.cfg = cfg
        self.device = select_device(cfg.platform)
        if params is None:
            params = compose_pretrained(cfg)
        missing = sorted(s for s in self.SUBTREES if s not in params
                         and not s.startswith("Discriminator"))
        if missing:
            # Cold start (tests / smoke runs): loudly, so a production run
            # with forgotten --pretrained_* flags is obvious.
            print(f"[!] {type(self).__name__}: no pretrained weights for "
                  f"{missing} — using RANDOM init (pass the --pretrained_* "
                  "flags for real inference)", flush=True)
        self.stage1 = Stage1App(cfg, self.device, state=params,
                                disc=bool(missing)
                                or "Discriminator" in params)
        self.fg_dim = cfg.roi_part_num * cfg.roi_z_num
        gen = torch.Generator().manual_seed(cfg.random_seed)
        if "PoseAE" in self.SUBTREES:
            self.pose_ae = Stage1PoseApp(cfg, self.device, params, gen)
        widths = {"PoseGaussian": (POSE_Z, 512),            # trainer.py:754-758
                  "Gaussian_FC_Fg": (self.fg_dim, 512),
                  "Gaussian_FC_Bg": (cfg.roi_z_num * 4, 256)}
        self.mappers = {}
        for name in self.MAPPERS:
            if name in self.SUBTREES:
                dim, hidden = widths[name]
                mapper = GaussianMapper(dim, dim, hidden)
                if name in params:
                    mapper.load_state_dict(params[name], strict=True)
                else:
                    init_weights(mapper, gen)
                self.mappers[name] = mapper.to(self.device).eval(
                ).requires_grad_(False)

    def cpu_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """This tester's weights as a `params` state on the CPU (the D's
        running statistics inside `Discriminator`), to build a twin of it
        on another device."""
        s1 = self.stage1
        nets = {"Encoder": s1.encoder, "ID_AE": s1.generator, **self.mappers}
        if s1.disc is not None:
            nets["Discriminator"] = s1.disc
        if "PoseAE" in self.SUBTREES:
            nets["PoseAE"] = self.pose_ae.nets
        return {name: {k: v.cpu() for k, v in net.state_dict().items()}
                for name, net in nets.items()}

    def draw_noise(self, gen: torch.Generator, b: int
                   ) -> Dict[str, torch.Tensor]:
        """Mapper inputs for one batch of `b`, scaled by the Gaussian's 0.2,
        drawn from `gen` in a fixed order (FG, BG, pose) whether or not a
        step uses them, and put on the tester's device."""
        dev = self.device
        return {"fg": sample_mapper_noise(gen, b, self.fg_dim, dev),
                "bg": sample_mapper_noise(gen, b, self.cfg.roi_z_num * 4, dev),
                "pose": sample_mapper_noise(gen, b, POSE_Z, dev)}

    # shared forward pieces ------------------------------------------------
    def _encode_app(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        bbox, vis = select_parts(batch["part_bbox"], batch["part_vis"],
                                 cfg.roi_part_num)
        return self.stage1._encode(batch["x"], batch["mask_r6"], bbox, vis)

    def _generate(self, embs: torch.Tensor,
                  pose_maps: torch.Tensor) -> torch.Tensor:
        return self.stage1._generate(embs, pose_maps)

    @full_float32()
    def _map(self, name: str, noise: torch.Tensor) -> torch.Tensor:
        """The Gaussian mapper `name` on its noise (testers.py:265-275 does
        FG and BG at once for the int8 calibration, not ported)."""
        return self.mappers[name](noise)

    def _disc_score(self, g_raw: torch.Tensor) -> torch.Tensor:
        """D logits of the generated batch, normalized by its own batch
        statistics (flax train=True with the updated stats discarded), or
        zeros without a D (testers.py:277-284)."""
        if self.stage1.disc is None:
            return torch.zeros(g_raw.shape[0], device=g_raw.device)
        return self.stage1._disc_apply(g_raw, train=True)

    def _pose_z(self, batch: Mapping[str, torch.Tensor],
                z_noise: Optional[torch.Tensor],
                pose_source: str) -> torch.Tensor:
        """The pose code to decode: the pose AE's code of the real pose
        ('reconstructed') or the pose mapper's sample ('sampled')."""
        cfg = self.cfg
        if pose_source == "reconstructed":
            rcv_norm = pose_rcv_normalize(batch["pose_rcv"], cfg.img_H,
                                          cfg.img_W)
            return self.pose_ae.encode(rcv_norm.reshape(rcv_norm.shape[0],
                                                        -1))
        if pose_source == "sampled":
            return self._map("PoseGaussian", z_noise)
        raise ValueError(f"pose_source must be 'real', 'reconstructed' or "
                         f"'sampled', got {pose_source!r}")

    def _pose_maps(self, batch: Mapping[str, torch.Tensor],
                   z_noise: torch.Tensor, pose_source: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(testers.py:286-312) -> (radius-4 pose maps in {-1,+1}, the rcv
        they were rendered from: the batch's pixel coords for 'real', else
        the decoded normalized ones)."""
        cfg = self.cfg
        if pose_source == "real":
            return pose_maps_from_batch(batch, cfg), batch["pose_rcv"]
        rcv = self.pose_ae.decode_rcv(self._pose_z(batch, z_noise,
                                                   pose_source))
        return render_pose_maps(rcv, cfg.img_H, cfg.img_W, cfg.keypoint_num,
                                radius=4, normalized=True), rcv


class FullSamplingTester(_TesterBase):
    """Model 11 (tester.py:256-416): sample FG/BG appearance (+ pose),
    generate, write PNG trees + discriminator scores."""

    SUBTREES = STAGE1_SUBTREES + _TesterBase.MAPPERS + ("PoseAE",)
    DEFAULT_BATCHES = 751  # tester.py:311

    @torch.inference_mode()
    def sample_step(self, batch: Mapping[str, torch.Tensor],
                    noise: Mapping[str, torch.Tensor],
                    pose_source: str = "real"):
        """(testers.py:335-363) Batch and `draw_noise` tensors on the
        device -> (images [B,H,W,3] in [0,255], pose maps [B,H,W,K], D
        scores [B], rcv). `sample_app` draws FG and BG from the mappers;
        `one_app_per_batch` holds the FG of sample 0 (sampled or real)
        across the batch (tester.py:381-387)."""
        cfg = self.cfg
        b = batch["x"].shape[0]
        if cfg.sample_app:  # the encoder's output is dead: not computed
            fg = self._map("Gaussian_FC_Fg", noise["fg"])
            bg = self._map("Gaussian_FC_Bg", noise["bg"])
        else:
            embs = self._encode_app(batch)
            fg, bg = embs[:, :self.fg_dim], embs[:, self.fg_dim:]
        if cfg.one_app_per_batch:
            fg = fg[:1].expand(b, -1)
        embs = torch.cat([fg, bg], -1)
        pose_maps, rcv = self._pose_maps(batch, noise["pose"], pose_source)
        g_raw = self._generate(embs, pose_maps)
        score = self._disc_score(g_raw)
        return torch.clamp((g_raw + 1) * 127.5, 0, 255), pose_maps, score, rcv

    def run(self, loader: Iterator, test_batch_num: Optional[int] = None,
            pose_source: str = "real") -> str:
        cfg = self.cfg
        n = test_batch_num or cfg.test_batch_num or self.DEFAULT_BATCHES
        out_root = os.path.join(
            cfg.model_dir,
            f"test_result_SampleApp{cfg.sample_app}Pose-{pose_source}"
            f"_{n}x{cfg.batch_size}")
        # Full reference output tree (tester.py:139-147,178-195): input
        # pair + masks + input/target/generated pose renderings.
        dirs = _save_dir_tree(out_root, ["x", "x_target", "G", "pose",
                                         "pose_target", "G_pose", "mask",
                                         "mask_target"])
        gen = torch.Generator().manual_seed(0)  # tf.set_random_seed(0)
        for i in range(n):
            batch = next(loader)  # a finite split ends: StopIteration
            jb = batch_to_device(batch, self.device)
            noise = self.draw_noise(gen, batch["x"].shape[0])
            g, pose_maps, score, g_rcv = self.sample_step(jb, noise,
                                                          pose_source)
            with torch.inference_mode():
                pose_s = pose_maps_from_batch(jb, cfg)
                pose_t = (pose_maps_from_batch(jb, cfg, "pose_rcv_target")
                          if "pose_rcv_target" in jb else None)
            arrays = {"x": (batch["x"] + 1) * 127.5,
                      "pose": pose_to_gray(pose_s.cpu().numpy()),
                      "G_pose": pose_to_gray(pose_maps.cpu().numpy())}
            if "x_target" in batch:
                arrays["x_target"] = (batch["x_target"] + 1) * 127.5
            if pose_t is not None:
                arrays["pose_target"] = pose_to_gray(pose_t.cpu().numpy())
            if "mask_r6" in batch:
                arrays["mask"] = batch["mask_r6"] * 255.0
            if "mask_r6_target" in batch:
                arrays["mask_target"] = batch["mask_r6_target"] * 255.0
            _save_batch_pngs(dirs, arrays, i * cfg.batch_size)
            # The coordinates the G_pose renderings were built from (the
            # decoded/sampled rcv, not the input batch's), for the scoring
            # and re-id tooling.
            if i < 4:
                np.save(os.path.join(dirs["G_pose"], f"pose_rcv_{i:04d}.npy"),
                        g_rcv.cpu().numpy())
            # G filenames carry the discriminator score (tester.py:185)
            g_np, s_np = g.cpu().numpy(), score.cpu().numpy()
            for j in range(g_np.shape[0]):
                idx = i * cfg.batch_size + j
                Image.fromarray(np.clip(g_np[j], 0, 255).astype(
                    np.uint8)).save(os.path.join(
                        dirs["G"], f"{idx:05d}_score{float(s_np[j]):.3f}.png"))
        return out_root


class FactorSamplingTester(_TesterBase):
    """Model 13 (tester.py:419-613), Market: independently toggle
    sample_fg / sample_bg / sample_pose; a factor not sampled is sample 0's
    across the batch. Model 1002 (DeepFashion's single mapper) is the 256
    family, not ported yet (ROADMAP §1, "The 256 family")."""

    SUBTREES = FullSamplingTester.SUBTREES
    DEFAULT_BATCHES = 400  # tester.py:475

    @torch.inference_mode()
    def sample_step(self, batch: Mapping[str, torch.Tensor],
                    noise: Mapping[str, torch.Tensor]):
        """(testers.py:459-502) -> (images [0,255], pose maps, D scores).
        Without `sample_pose`, the real pose of sample 0 is normalized and
        rendered in normalized mode (testers.py:494-499), as in JAX."""
        cfg = self.cfg
        b = batch["x"].shape[0]
        if not (cfg.sample_fg and cfg.sample_bg):
            embs = self._encode_app(batch)
        fg = (self._map("Gaussian_FC_Fg", noise["fg"]) if cfg.sample_fg
              else embs[:1, :self.fg_dim].expand(b, -1))  # tester.py:541-543
        bg = (self._map("Gaussian_FC_Bg", noise["bg"]) if cfg.sample_bg
              else embs[:1, self.fg_dim:].expand(b, -1))
        embs = torch.cat([fg, bg], -1)
        if cfg.sample_pose:
            pose_maps, _ = self._pose_maps(batch, noise["pose"],
                                           "reconstructed")
        else:  # one real pose across the batch (tester.py:506-508)
            rcv_norm = pose_rcv_normalize(batch["pose_rcv"], cfg.img_H,
                                          cfg.img_W)
            pose_maps = render_pose_maps(rcv_norm[:1].expand(b, -1, -1),
                                         cfg.img_H, cfg.img_W,
                                         cfg.keypoint_num, radius=4,
                                         normalized=True)
        g_raw = self._generate(embs, pose_maps)
        score = self._disc_score(g_raw)
        return torch.clamp((g_raw + 1) * 127.5, 0, 255), pose_maps, score

    def run(self, loader: Iterator, test_batch_num: Optional[int] = None) -> str:
        cfg = self.cfg
        n = test_batch_num or cfg.test_batch_num or self.DEFAULT_BATCHES
        out_root = os.path.join(
            cfg.model_dir,
            f"test_result_ROI7_SampleFg{cfg.sample_fg}SampleBg{cfg.sample_bg}"
            f"SamplePose{cfg.sample_pose}_pretrain_{n}x{cfg.batch_size}")
        dirs = _save_dir_tree(out_root, ["x", "G", "pose"])
        gen = torch.Generator().manual_seed(0)
        for i in range(n):
            batch = next(loader)
            jb = batch_to_device(batch, self.device)
            g, pose_maps, _ = self.sample_step(
                jb, self.draw_noise(gen, batch["x"].shape[0]))
            _save_batch_pngs(dirs, {
                "x": (batch["x"] + 1) * 127.5,
                "G": g.cpu().numpy(),
                "pose": pose_to_gray(pose_maps.cpu().numpy()),
            }, i * cfg.batch_size)
        return out_root


class ConditionalTransferTester(_TesterBase):
    """Model 12 (tester.py:616-767): PG2-style pose transfer — source
    appearance + target pose -> image; writes the directory tree score.py
    consumes (x, x_target, G, pose, pose_target, mask, mask_target)."""

    DEFAULT_BATCHES = 600  # tester.py:650

    @torch.inference_mode()
    def transfer_step(self, batch: Mapping[str, torch.Tensor]):
        """Batch of device tensors -> (images [B,H,W,3] in [0,255],
        target pose maps [B,H,W,K], D scores [B])."""
        cfg = self.cfg
        embs = self._encode_app(batch)
        pose_t = pose_maps_from_batch(batch, cfg, "pose_rcv_target")
        g_raw = self._generate(embs, pose_t)
        score = self._disc_score(g_raw)
        return torch.clamp((g_raw + 1) * 127.5, 0, 255), pose_t, score

    def run(self, loader: Iterator, test_batch_num: Optional[int] = None) -> str:
        cfg = self.cfg
        n = test_batch_num or cfg.test_batch_num or self.DEFAULT_BATCHES
        out_root = os.path.join(cfg.model_dir, "test_result")
        dirs = _save_dir_tree(out_root, ["x", "x_target", "G", "pose",
                                         "pose_target", "mask", "mask_target"])
        ssims = []
        for i in range(n):
            batch = next(loader)
            jb = batch_to_device(batch, self.device)
            g, pose_t, _score = self.transfer_step(jb)
            with torch.inference_mode():
                pose_s = pose_maps_from_batch(jb, cfg)
            g = g.cpu().numpy()
            x_target = (batch["x_target"] + 1) * 127.5
            _save_batch_pngs(dirs, {
                "x": (batch["x"] + 1) * 127.5,
                "x_target": x_target,
                "G": g,
                "pose": pose_to_gray(pose_s.cpu().numpy()),
                "pose_target": pose_to_gray(pose_t.cpu().numpy()),
                "mask": batch["mask_r4"] * 255.0,
                "mask_target": batch["mask_r4_target"] * 255.0,
            }, i * cfg.batch_size)
            ssims.extend(ssim_images(g, x_target))
        print(f"[*] transfer SSIM vs x_target: {np.mean(ssims):.4f} "
              f"over {len(ssims)} images")
        return out_root


class InterpolationTester(_TesterBase):
    """Factor interpolation (testers.py:583-655; the reference's
    interpolate_fg/bg/pose flags, config.py:70-77, with utils.py:91-97
    slerp in embedding space): the toggled factor goes from sample 0 to
    sample 1 of a batch in `n_steps`, the others held at sample 0's, one
    image per step."""

    SUBTREES = STAGE1_SUBTREES + ("PoseAE",)

    @torch.inference_mode()
    def _embed(self, batch: Mapping[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (appearance codes [B, 352], pose codes [B, POSE_Z])."""
        return (self._encode_app(batch),
                self._pose_z(batch, None, "reconstructed"))

    @torch.inference_mode()
    def _decode(self, embs: torch.Tensor, pose_z: torch.Tensor
                ) -> torch.Tensor:
        """Codes -> images [B,H,W,3] in [0,255]."""
        cfg = self.cfg
        rcv = self.pose_ae.decode_rcv(pose_z)
        pose_maps = render_pose_maps(rcv, cfg.img_H, cfg.img_W,
                                     cfg.keypoint_num, radius=4,
                                     normalized=True)
        g_raw = self._generate(embs, pose_maps)
        return torch.clamp((g_raw + 1) * 127.5, 0, 255)

    def run(self, loader: Iterator, n_steps: int = 8,
            use_slerp: bool = True) -> str:
        cfg = self.cfg
        fg_dim = self.fg_dim
        embs, pose_z = (t.cpu().numpy() for t in self._embed(
            batch_to_device(next(loader), self.device)))
        lerp = slerp if use_slerp else (lambda t, a, b: (1 - t) * a + t * b)
        rows = []
        for i in range(n_steps):
            t = i / max(n_steps - 1, 1)
            e = embs[0].copy()
            pz = pose_z[0].copy()
            if cfg.interpolate_fg or cfg.interpolate_fg_up \
                    or cfg.interpolate_fg_down:
                e[:fg_dim] = lerp(t, embs[0, :fg_dim], embs[1, :fg_dim])
            if cfg.interpolate_bg:
                e[fg_dim:] = lerp(t, embs[0, fg_dim:], embs[1, fg_dim:])
            if cfg.interpolate_pose:
                pz = lerp(t, pose_z[0], pose_z[1])
            rows.append((e, pz))
        e_all = torch.from_numpy(np.stack([r[0] for r in rows]))
        pz_all = torch.from_numpy(np.stack([r[1] for r in rows]))
        imgs = self._decode(e_all.to(self.device),
                            pz_all.to(self.device)).cpu().numpy()
        out_root = os.path.join(cfg.model_dir, "test_result_interpolate")
        os.makedirs(out_root, exist_ok=True)
        save_image(imgs, os.path.join(out_root, "interpolation.png"),
                   nrow=n_steps)
        return out_root
