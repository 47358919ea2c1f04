"""Stage-I appearance reconstruction, models 1 and 101 (port of
`dpig_tpu/apps/stage1_app.py`; reference trainer.py:567-625,
trainer_256.py:10-265).

Market 128x64 family (model 1): FG/BG two-branch ROI encoder -> 352-d
embedding + 18-ch pose map -> U-net generator; the `--D_arch` image
discriminator (DCGAN by default; DCGANRegion, Patch and the per-pixel
FCDis score maps, whose losses average over the map); G loss = adv +
20*L1; 1 critic iteration per G iteration. DeepFashion 256x256 family
(model 101): the single-branch ROI encoder (224-d, ROI 64, repeat_num+1
stages), the generator at repeat_num-1 and a 5-stage DCGAN D, with the
same loss recipe. `--remat` rematerializes the encoder and the generator
in the train step's backward pass. `train_step` is one G update
then one D update on the nets in place; `generate_step` /
`transfer_step` are the inference half the testers use.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import Config
from ..losses import gan
from ..models.discriminators import get_discriminator
from ..models.encoders import RoiEncoder, RoiEncoderFgBg
from ..models.generator import UAEGenerator
from ..models.layers import init_weights
from ..parallel import dist
from ..train.state import GanState
from ..utils import spans
from .common import l1_loss, masked_l1_loss, pose_maps_from_batch, select_parts

GAN_MODE = "dcgan"  # trainer.py:257
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TRAIN_PHASES = ("inputs", "g_forward", "g_backward", "g_update",
                "g_reforward", "d_forward_backward", "d_update")


@contextlib.contextmanager
def full_float32():
    """cuDNN convs and cuBLAS matmuls in float32, not TF32, inside the block
    whatever the caller's flags (PyTorch lets cuDNN convs use TF32 by
    default); the flags are restored after. Also a decorator. The flags are
    global, so they also hold for backward passes that autograd runs on its
    device threads while the block is open."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


class Stage1App:
    """Encoder, generator and (with `disc`) D of Stage I on `device`,
    frozen until `init_state` makes them trainable.

    Each net whose sub-tree ('Encoder', 'ID_AE', 'Discriminator' with its
    'Discriminator_stats') is in `state`, the format of
    `bridge.params_from_flax` and `train.checkpoint.restore_subtrees`, is
    loaded from it; the others get fresh weights (Xavier / normal(0.02),
    from a CPU torch.Generator seeded with `cfg.random_seed`, so the CPU
    and the card get the same numbers). `disc=False` builds no D (the
    Stage-II samplers, and the testers given every sub-tree they need but
    no D). The app owns the precision: `--compute_dtype` is the compute
    dtype of every Stage-I net (stage1_app.py:39-63; the parameters, the
    gradients and the optimizer stay float32), and every forward, and the
    whole train step with its backward passes and optimizer updates, runs
    under `full_float32`, so the float32 path is float32. The embeddings,
    g_raw and the D logits come back in float32 (exact: every consumer of
    the JAX package's bfloat16 ones promotes them to float32 first).
    """

    def __init__(self, cfg: Config, device: torch.device,
                 state: Optional[Mapping] = None, disc: bool = True,
                 fg_bg: bool = True):
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"--compute_dtype must be one of "
                             f"{sorted(COMPUTE_DTYPES)}, got "
                             f"{cfg.compute_dtype!r}")
        self.cfg = cfg
        self.device = device
        self.out_dtype = torch.float32  # the nets' outputs, as in JAX
        self.dtype = dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        # stage1_app.py:41-63: the FG/BG encoder exists only for the
        # 128x64 family, so fg_bg is normalized as JAX does it; model 101
        # at 128x64 gets the single branch at Market depths.
        is_256 = cfg.img_H >= 256
        self.fg_bg = fg_bg = fg_bg and not is_256
        self.enc_repeat = cfg.repeat_num + 1 if is_256 else cfg.repeat_num
        self.gen_repeat = cfg.repeat_num - 1 if is_256 else cfg.repeat_num
        roi_size = 64 if is_256 else 48
        self.emb_dim = cfg.roi_part_num * cfg.roi_z_num
        if fg_bg:
            self.encoder = RoiEncoderFgBg(
                cfg.img_H, cfg.img_W, part_num=cfg.roi_part_num,
                z_num=cfg.roi_z_num, repeat_num=self.enc_repeat,
                hidden_num=cfg.conv_hidden_num, roi_size=roi_size,
                dtype=dtype)
            self.emb_dim += cfg.roi_z_num * 4
        else:
            self.encoder = RoiEncoder(
                part_num=cfg.roi_part_num, z_num=cfg.roi_z_num,
                repeat_num=self.enc_repeat, hidden_num=cfg.conv_hidden_num,
                roi_size=roi_size, dtype=dtype)
        self.generator = UAEGenerator(
            cfg.img_H, cfg.img_W, emb_dim=self.emb_dim,
            pose_ch=cfg.keypoint_num, out_channels=3, z_num=cfg.z_num,
            repeat_num=self.gen_repeat, hidden_num=cfg.conv_hidden_num,
            dtype=dtype)
        modules = {"Encoder": self.encoder, "ID_AE": self.generator}
        self.disc = None
        if disc:
            self.disc = get_discriminator(cfg.D_arch, cfg.img_H, cfg.img_W,
                                          n_stages=5 if is_256 else 4,
                                          mode=GAN_MODE, dtype=dtype)
            modules["Discriminator"] = self.disc
        state = state or {}
        gen = torch.Generator().manual_seed(cfg.random_seed)
        for name, m in modules.items():
            if name in state:  # strict: missing or extra keys raise
                m.load_state_dict({**state[name],
                                   **state.get(f"{name}_stats", {})},
                                  strict=True)
            else:
                init_weights(m, gen)
            m.to(device).eval().requires_grad_(False)

    # ------------------------------------------------------------ forward
    @full_float32()
    def _encode(self, x, mask, bbox, vis) -> torch.Tensor:
        """The appearance code; the fg mask is read by the FG/BG encoder
        only (stage1_app.py:96-99)."""
        if self.fg_bg:
            return self.encoder(x, mask, bbox, vis).to(self.out_dtype)
        return self.encoder(x, bbox, vis).to(self.out_dtype)

    @full_float32()
    def _generate(self, embs, pose) -> torch.Tensor:
        g_raw, _ = self.generator(embs, pose)
        return g_raw.to(self.out_dtype)

    def g_forward(self, x, pose, mask, bbox, vis, remat: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (g_raw [B,H,W,3] float32, embs [B, emb_dim]: 352 FG/BG, 224
        single-branch). `remat` (--remat, stage1_app.py:52-58) keeps
        neither net's activations for the backward pass, which runs each
        forward again instead (`torch.utils.checkpoint`). Neither net has
        BatchNorm or dropout, so the second forward gives the same
        activations; the pose maps are its input, rendered once.

        Spans (`utils/spans.py`): `encoder` and `generator` around the two
        forwards; with the recorder on and grad enabled, the coming
        backward pass is split into `generator.backward` (from g_raw's
        gradient) and `encoder.backward` (from the embeddings'), which
        the caller ends with `spans.end_backward()`."""
        with spans.span("encoder"):
            embs = (checkpoint(self._encode, x, mask, bbox, vis,
                               use_reentrant=False) if remat
                    else self._encode(x, mask, bbox, vis))
        with spans.span("generator"):
            g_raw = (checkpoint(self._generate, embs, pose,
                                use_reentrant=False) if remat
                     else self._generate(embs, pose))
        if spans.enabled() and torch.is_grad_enabled():
            spans.split_backward((g_raw, "generator.backward"),
                                 (embs, "encoder.backward"))
        return g_raw, embs

    @full_float32()
    def _disc_apply(self, img, train: bool = True,
                    update_stats: bool = False) -> torch.Tensor:
        return self.disc(img, train=train,
                         update_stats=update_stats).to(self.out_dtype)

    # --------------------------------------------------------------- train
    def init_state(self) -> GanState:
        """Make the nets trainable and wrap them with their optimizers
        (stage1_app.py:66-93). `train_step` takes the returned state."""
        cfg = self.cfg
        for m in (self.encoder, self.generator, self.disc):
            m.requires_grad_(True)
        return GanState.create(
            g_nets={"Encoder": self.encoder, "ID_AE": self.generator},
            d_nets={"Discriminator": self.disc}, mode=GAN_MODE,
            g_lr=cfg.g_lr, d_lr=cfg.d_lr, lr_update_step=cfg.lr_update_step,
            step=cfg.start_step)

    def step_inputs(self, batch: Mapping[str, torch.Tensor]):
        """Device batch -> (x, pose maps, fg mask, part bboxes, part vis)."""
        bbox, vis = select_parts(batch["part_bbox"], batch["part_vis"],
                                 self.cfg.roi_part_num)
        return (batch["x"], pose_maps_from_batch(batch, self.cfg),
                batch["mask_r6"], bbox, vis)

    def g_loss(self, x, pose, mask, bbox, vis
               ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """G objective adv + L1Loss_weight * L1 (trainer.py:605-623), with
        the D normalizing by batch statistics and its running statistics
        left alone -> (loss, g_raw, the other metrics). With --remat the
        encoder and the generator are rematerialized in the backward pass."""
        g_raw, _ = self.g_forward(x, pose, mask, bbox, vis,
                                  remat=self.cfg.remat)
        adv = gan.g_loss(GAN_MODE, self._disc_apply(g_raw))
        l1 = l1_loss(g_raw, x)
        loss = adv + self.cfg.L1Loss_weight * l1
        pose_mask_loss = masked_l1_loss(g_raw.detach(), x, mask)
        return loss, g_raw, {"g_loss_only": adv, "L1Loss": l1,
                             "PoseMaskLoss": pose_mask_loss}

    def d_loss(self, x, fake) -> torch.Tensor:
        """D objective on the real batch, then the fake one; each pass moves
        the D's running statistics, the fake pass from where the real pass
        left them (stage1_app.py:151-154)."""
        d_real = self._disc_apply(x, update_stats=True)
        d_fake = self._disc_apply(fake, update_stats=True)
        return gan.d_loss(GAN_MODE, d_real, d_fake)

    @full_float32()
    @dist.global_batch_stats()
    def train_step(self, state: GanState, batch: Mapping[str, torch.Tensor],
                   mark: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One G update, then one D update (stage1_app.py:115-163), in
        place on the nets, the D's running statistics and the optimizers of
        `state` (from this app's `init_state`); state.step += 1. Returns the
        five metrics as 0-d tensors on the device (reading them syncs).

        Gradients are taken w.r.t. one net's parameters at a time
        (`autograd.grad(..., inputs)`), so no `.grad` accumulates anywhere.
        The D step scores fakes from a re-forward with the updated G
        (reference-faithful, trainer.py:337-345), or with
        `--fast_gan_step` the G step's own output. `mark(phase)`, if given,
        is called after each phase of TRAIN_PHASES is enqueued (the
        profiler's CUDA events).

        Across ranks (`parallel.dist`) `batch` is this rank's rows of the
        global batch, the D's BatchNorm takes the global batch's
        statistics, the optimizers average the gradients, and the metrics
        are the global batch's, the same on every rank."""
        mark = mark or (lambda phase: None)
        x, pose, mask, bbox, vis = self.step_inputs(batch)
        mark("inputs")
        g_total, g_raw, aux = self.g_loss(x, pose, mask, bbox, vis)
        mark("g_forward")
        g_grads = torch.autograd.grad(g_total, state.g_params)
        spans.end_backward()
        mark("g_backward")
        state.g_opt.step(g_grads)
        mark("g_update")

        if self.cfg.fast_gan_step:
            fake = g_raw.detach()
        else:
            with torch.no_grad():
                fake, _ = self.g_forward(x, pose, mask, bbox, vis)
        mark("g_reforward")
        d_total = self.d_loss(x, fake)
        d_grads = torch.autograd.grad(d_total, state.d_params)
        mark("d_forward_backward")
        state.d_opt.step(d_grads)
        state.step += 1
        mark("d_update")
        metrics = {"g_loss": g_total, "d_loss": d_total, **aux}
        return dist.global_metrics({k: v.detach() for k, v in metrics.items()})

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
