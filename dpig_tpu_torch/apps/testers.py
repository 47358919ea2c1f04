"""Inference testers (port of `dpig_tpu/apps/testers.py`, float32): model
11 full sampling, model 12 pose transfer, model 13 factor sampling and
factor interpolation, and at 256x256 their DeepFashion twins, model 1001
(transfer) and model 1002 (factor sampling with the single appearance
mapper `Gaussian_FC`), whose Stage-I nets are the single-branch encoder
and the generator at repeat_num-1 (`Stage1App(fg_bg=img_H < 256)`, as
testers.py:91).

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

Precision (testers.py:148-257): `--compute_dtype=bfloat16` runs the
Stage-I nets in bfloat16 and the generator as `quant.uae_forward_bf16`;
`--inference_dtype=int8` (models 11, 12, 13, 1001, 1002) calibrates an
int8 generator and, for the FG/BG encoder of the 128x64 family, an int8
ROI encoder on the first batch in `run()` (`_inference_params`; the
sampling testers add a batch of mapper-sampled embeddings drawn from a
CPU torch.Generator seeded with `--random_seed`, or the noise the caller
passes) and prints the SSIM of the int8 output against the float one on
that batch (`--int8_selfcheck`). Interpolation has no int8 path, as in
JAX.
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
from ..models import quant as quant_mod
from ..models.mappers import GaussianMapper, sample_mapper_noise
from ..ops.image import slerp
from ..ops.pose import pose_rcv_normalize, render_pose_maps
from ..train.checkpoint import compose_pretrained
from ..utils.viz import pose_to_gray, save_image
from .common import (batch_to_device, pose_maps_from_batch,
                     select_device, select_parts)
from .stage1_app import Stage1App, full_float32
from .stage1_pose import POSE_Z, Stage1PoseApp


def _parse_int8_calibration(cfg: Config) -> Dict:
    """--int8_calibration -> QuantizedGenerator calibration kwargs
    (testers.py:42-53)."""
    spec = cfg.int8_calibration or "channel"
    if spec.startswith("percentile:"):
        return {"calib_method": "percentile",
                "calib_percentile": float(spec.split(":", 1)[1])}
    if spec == "channel":
        return {"calib_granularity": "channel"}
    if spec in ("absmax", "entropy"):
        return {"calib_method": spec}
    raise ValueError(f"unknown --int8_calibration {spec!r} (expected "
                     "absmax | percentile:<p> | entropy | channel)")


def _parse_int8_fallback(cfg: Config) -> Tuple[frozenset, frozenset]:
    """--int8_fallback_layers -> (encoder, generator) name sets: 'stem/',
    'fg/' and 'bg/' names are the encoder's (testers.py:56-65)."""
    names = frozenset(n.strip() for n in cfg.int8_fallback_layers.split(",")
                      if n.strip())
    enc = frozenset(n for n in names
                    if n.split("/")[0] in ("stem", "fg", "bg"))
    return enc, names - enc


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
    Gaussian mappers (`PoseGaussian`, `Gaussian_FC_Fg`, `Gaussian_FC_Bg`,
    and DeepFashion's `Gaussian_FC`).
    A sampling net missing from the weights is fresh from one CPU
    torch.Generator seeded with `cfg.random_seed`, in that order, so the
    card and the CPU get the same numbers."""

    SUBTREES = STAGE1_SUBTREES
    MARKET_MAPPERS = ("PoseGaussian", "Gaussian_FC_Fg", "Gaussian_FC_Bg")
    MAPPERS = MARKET_MAPPERS + ("Gaussian_FC",)

    def __init__(self, cfg: Config, params: Optional[Mapping] = None):
        self.cfg = cfg
        self.quant_enc: Optional[Dict] = None  # int8 tables, `run()` sets
        self.quant_gen: Optional[Dict] = None
        self.device = select_device(cfg.platform)
        if params is None:
            params = compose_pretrained(cfg)
        missing = sorted(s for s in self.SUBTREES if s not in params
                         and not s.startswith("Discriminator"))
        if missing:
            self._warn_cold_start(missing)
        self.stage1 = Stage1App(cfg, self.device, state=params,
                                disc=bool(missing)
                                or "Discriminator" in params,
                                fg_bg=cfg.img_H < 256)
        self.fg_dim = cfg.roi_part_num * cfg.roi_z_num
        gen = torch.Generator().manual_seed(cfg.random_seed)
        if "PoseAE" in self.SUBTREES:
            self.pose_ae = Stage1PoseApp(cfg, self.device, params, gen)
        widths = {"PoseGaussian": (POSE_Z, 512),            # trainer.py:754-758
                  "Gaussian_FC_Fg": (self.fg_dim, 512),
                  "Gaussian_FC_Bg": (cfg.roi_z_num * 4, 256),
                  "Gaussian_FC": (self.fg_dim, 512)}
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

    def _warn_cold_start(self, missing) -> None:
        """Cold start (tests / smoke runs): loudly, so a production run with
        forgotten --pretrained_* flags is obvious."""
        print(f"[!] {type(self).__name__}: no pretrained weights for "
              f"{missing} — using RANDOM init (pass the --pretrained_* "
              "flags for real inference)", flush=True)

    def nets(self) -> Dict[str, torch.nn.Module]:
        """This tester's nets by sub-tree name."""
        s1 = self.stage1
        nets = {"Encoder": s1.encoder, "ID_AE": s1.generator, **self.mappers}
        if s1.disc is not None:
            nets["Discriminator"] = s1.disc
        if "PoseAE" in self.SUBTREES:
            nets["PoseAE"] = self.pose_ae.nets
        return nets

    def cpu_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """This tester's weights as a `params` state on the CPU (the D's
        running statistics inside `Discriminator`), to build a twin of it
        on another device."""
        return {name: {k: v.cpu() for k, v in net.state_dict().items()}
                for name, net in self.nets().items()}

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
        if self.quant_enc is not None:
            with full_float32():
                return quant_mod.roi_fgbg_forward(
                    self.stage1.encoder, batch["x"], batch["mask_r6"], bbox,
                    vis, cfg.repeat_num, cfg.conv_hidden_num,
                    part_num=cfg.roi_part_num, quant=self.quant_enc)
        return self.stage1._encode(batch["x"], batch["mask_r6"], bbox, vis)

    @full_float32()
    def _generate(self, embs: torch.Tensor,
                  pose_maps: torch.Tensor) -> torch.Tensor:
        """(testers.py:148-177) The int8 generator, chained or, for a
        fallback set under --int8_fallback_mode=legacy, the per-layer
        graph; else the bfloat16 raw-param forward; else the module."""
        cfg = self.cfg
        gen, repeat = self.stage1.generator, self.stage1.gen_repeat
        if self.quant_gen is not None:
            _, gen_fb = _parse_int8_fallback(cfg)
            g_raw, _ = quant_mod.uae_forward(
                gen, embs, pose_maps, repeat, cfg.conv_hidden_num,
                quant=self.quant_gen, chained=not gen_fb
                or cfg.int8_fallback_mode == "island")
            return g_raw
        if self.stage1.dtype == torch.bfloat16:
            g_raw, _ = quant_mod.uae_forward_bf16(
                gen, embs, pose_maps, repeat, cfg.conv_hidden_num)
            return g_raw
        return self.stage1._generate(embs, pose_maps)

    @torch.inference_mode()
    def _inference_params(self, first_batch: Mapping[str, torch.Tensor],
                          calib_noise: Optional[Mapping] = None) -> None:
        """With --inference_dtype=int8 (testers.py:179-257): calibrate the
        int8 ROI encoder (the FG/BG one only: at 256 the single-branch
        encoder stays in the compute dtype, and encoder fallback names
        raise ValueError, as in JAX) and then the int8 generator at its
        own depth on the first batch
        (device tensors), the generator also on mapper-sampled embeddings
        where this tester samples them (`_sampled_calib_embs`, from
        `calib_noise`, else `draw_noise` of a CPU generator seeded with
        --random_seed), set `quant_enc` / `quant_gen`, and print the
        int8-vs-float SSIM on the batch (--int8_selfcheck). Otherwise
        nothing."""
        cfg = self.cfg
        if cfg.inference_dtype != "int8":
            return
        enc_fallback, gen_fallback = _parse_int8_fallback(cfg)
        calib = _parse_int8_calibration(cfg)
        if cfg.int8_fallback_mode not in ("island", "legacy"):
            raise ValueError(f"unknown --int8_fallback_mode "
                             f"{cfg.int8_fallback_mode!r}")
        bbox, vis = select_parts(first_batch["part_bbox"],
                                 first_batch["part_vis"], cfg.roi_part_num)
        if self.stage1.fg_bg:
            with full_float32():
                qe = quant_mod.QuantizedEncoder(
                    self.stage1.encoder, cfg.repeat_num, cfg.conv_hidden_num,
                    part_num=cfg.roi_part_num, bf16_layers=enc_fallback,
                    calib_granularity=calib.get("calib_granularity",
                                                "tensor"))
                qe.calibrate([(first_batch["x"], first_batch["mask_r6"],
                               bbox, vis)])
            self.quant_enc = qe.quant
        elif enc_fallback:
            # testers.py:204-212: no int8 encoder exists on this path
            raise ValueError(
                f"--int8_fallback_layers names {sorted(enc_fallback)} "
                "target the int8 encoder, but this tester "
                f"({type(self).__name__}, img_H={cfg.img_H}, "
                f"fg_bg={self.stage1.fg_bg}) runs its encoder in "
                f"{cfg.compute_dtype} already; drop the stem/fg/bg names")
        embs = self._encode_app(first_batch)
        pose = pose_maps_from_batch(first_batch, cfg)
        b = first_batch["x"].shape[0]
        if calib_noise is None:
            calib_noise = self.draw_noise(
                torch.Generator().manual_seed(cfg.random_seed), b)
        calib_embs, calib_pose = [embs], [pose]
        sampled = self._sampled_calib_embs(calib_noise)
        if sampled is not None:
            calib_embs.append(sampled)
            calib_pose.append(pose)
        with full_float32():
            qg = quant_mod.QuantizedGenerator(
                self.stage1.generator, self.stage1.gen_repeat,
                cfg.conv_hidden_num, bf16_layers=gen_fallback, **calib)
            qg.calibrate(calib_embs, calib_pose)
        self.quant_gen = qg.quant
        print(f"[*] {type(self).__name__}: int8 PTQ inference "
              f"(calibrated on the first batch)", flush=True)
        if cfg.int8_selfcheck:
            g_q = self._generate(embs, pose).cpu().numpy()
            with full_float32():
                g_f = quant_mod.uae_forward(
                    self.stage1.generator, embs, pose,
                    self.stage1.gen_repeat,
                    cfg.conv_hidden_num)[0].cpu().numpy()
            to255 = lambda a: np.clip((a + 1.0) * 127.5, 0, 255)  # noqa: E731
            self.int8_fidelity = float(ssim_images(to255(g_q),
                                                   to255(g_f)).mean())
            print(f"[*] int8 self-check: SSIM(int8,float)="
                  f"{self.int8_fidelity:.4f} on the calibration batch",
                  flush=True)

    def _sampled_calib_embs(self, noise: Mapping[str, torch.Tensor]
                            ) -> Optional[torch.Tensor]:
        """An extra int8-calibration batch of mapper-sampled appearance
        codes where this tester feeds them (testers.py:259-263,265-275);
        None: the encoder's alone."""
        return None

    def _market_mapper_embs(self, noise: Mapping[str, torch.Tensor]
                            ) -> torch.Tensor:
        return torch.cat([self._map("Gaussian_FC_Fg", noise["fg"]),
                          self._map("Gaussian_FC_Bg", noise["bg"])], -1)

    @full_float32()
    def _map(self, name: str, noise: torch.Tensor) -> torch.Tensor:
        """The Gaussian mapper `name` on its noise."""
        return self.mappers[name](noise)

    def _disc_score(self, g_raw: torch.Tensor) -> torch.Tensor:
        """D logits of the generated batch in the D's own shape ([B] for
        DCGAN, a map for the other `--D_arch`s), normalized by its own
        batch statistics (flax train=True with the updated stats
        discarded), or zeros [B] without a D (testers.py:277-284)."""
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

    SUBTREES = STAGE1_SUBTREES + _TesterBase.MARKET_MAPPERS + ("PoseAE",)
    DEFAULT_BATCHES = 751  # tester.py:311

    def _sampled_calib_embs(self, noise):
        if not (self.cfg.sample_app or self.cfg.one_app_per_batch):
            return None
        return self._market_mapper_embs(noise)

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
        first = next(loader)
        self._inference_params(batch_to_device(first, self.device))
        for i in range(n):
            # a finite split ends: StopIteration
            batch = first if i == 0 else next(loader)
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
    """Models 13 and 1002 (tester.py:419-613): independently toggle
    sample_fg / sample_bg / sample_pose; a factor not sampled is sample 0's
    across the batch. At 256 (model 1002) one mapper, `Gaussian_FC`,
    samples the whole appearance code under `sample_fg` or `sample_app`
    (testers.py:466-472; `sample_bg` has nothing to sample there)."""

    SUBTREES = FullSamplingTester.SUBTREES
    SUBTREES_256 = STAGE1_SUBTREES + ("PoseGaussian", "Gaussian_FC",
                                      "PoseAE")
    DEFAULT_BATCHES = 400  # tester.py:475

    def __init__(self, cfg: Config, params: Optional[Mapping] = None):
        self.is_256 = cfg.img_H >= 256
        if self.is_256:  # testers.py:436-441
            self.SUBTREES = self.SUBTREES_256
        super().__init__(cfg, params)

    def _sampled_calib_embs(self, noise):
        cfg = self.cfg
        if not (cfg.sample_fg or cfg.sample_bg or cfg.sample_app):
            return None
        if self.is_256:
            return self._map("Gaussian_FC", noise["fg"])
        return self._market_mapper_embs(noise)

    @torch.inference_mode()
    def sample_step(self, batch: Mapping[str, torch.Tensor],
                    noise: Mapping[str, torch.Tensor]):
        """(testers.py:459-502) -> (images [0,255], pose maps, D scores).
        Without `sample_pose`, the real pose of sample 0 is normalized and
        rendered in normalized mode (testers.py:494-499), as in JAX."""
        cfg = self.cfg
        b = batch["x"].shape[0]
        if self.is_256:
            embs = (self._map("Gaussian_FC", noise["fg"])
                    if cfg.sample_fg or cfg.sample_app
                    else self._encode_app(batch)[:1].expand(b, -1))
        else:
            if not (cfg.sample_fg and cfg.sample_bg):
                embs = self._encode_app(batch)
            fg = (self._map("Gaussian_FC_Fg", noise["fg"]) if cfg.sample_fg
                  else embs[:1, :self.fg_dim].expand(b, -1))  # :541-543
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
        first = next(loader)
        self._inference_params(batch_to_device(first, self.device))
        for i in range(n):
            batch = first if i == 0 else next(loader)
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
    """Models 12 and 1001 (tester.py:616-767): PG2-style pose transfer —
    source appearance + target pose -> image; writes the directory tree
    score.py consumes (x, x_target, G, pose, pose_target, mask,
    mask_target)."""

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
        first = next(loader)
        self._inference_params(batch_to_device(first, self.device))
        for i in range(n):
            batch = first if i == 0 else next(loader)
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
        """-> (appearance codes [B, 352] (224 at 256), pose codes
        [B, POSE_Z])."""
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
