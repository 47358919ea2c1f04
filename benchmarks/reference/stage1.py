"""Plain PyTorch reference of a Stage-I training step and of a pose-transfer
batch (models 1 / 101 and 12 / 1001 of Disentangled Person Image
Generation), on the nets of `nets.py`.

Training step (the published trainer's order): G forward, G loss =
sigmoid cross-entropy of the D's logits on the fakes against 1 (the D
normalizing by the fakes' batch statistics) + L1 weight * mean |G(x) - x|;
Adam on the encoder and the generator; the updated G forwards the batch
again, and the D loss, (CE(D(fake), 0) + CE(D(real), 1)) / 2, takes an
Adam step on the D. Adam is optax's, in float32: moments from zero,
mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, update lr *
(mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps); the learning rate
halves every `lr_update_step` updates.

Transfer batch: the appearance code of x, the pose map of the target pose,
the generator, and the D's logits on the generated images (batch
statistics) -> images in [0, 255].

Everything runs in the dtype of the weights and the batch it is given:
the check runs it in float64, the control in float32 with TF32 on.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping

import numpy as np
import torch

from . import nets
from .pose import render_pose_maps

Params = Dict[str, torch.Tensor]


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 in cuBLAS and cuDNN on or off inside the block, restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def sigmoid_ce(logits: torch.Tensor, label: float) -> torch.Tensor:
    """-label log s(l) - (1 - label) log(1 - s(l)), in its stable form."""
    return (torch.clamp(logits, min=0) - logits * label
            + torch.log1p(torch.exp(-logits.abs())))


def pose_maps(cfg: Mapping, rcv: torch.Tensor) -> torch.Tensor:
    n = cfg["nets"]
    return render_pose_maps(rcv, n["img_H"], n["img_W"], n["keypoints"],
                            n["pose_radius"])


def g_forward(cfg: Mapping, p: Mapping[str, Params],
              batch: Mapping[str, torch.Tensor],
              pose_key: str = "pose_rcv") -> torch.Tensor:
    n = cfg["nets"]
    embs = nets.encode(p["Encoder"], n["encoder"], batch["x"],
                       batch["mask_r6"], batch["part_bbox"],
                       batch["part_vis"])
    pose = pose_maps(cfg, batch[pose_key]).to(batch["x"].dtype)
    return nets.generate(p["ID_AE"], n["generator"], n["hidden"], embs, pose)


def g_loss(cfg: Mapping, p: Mapping[str, Params],
           batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The G loss and its parts: the adversarial term, the L1 term and the
    L1 inside the mask (reported, not optimized)."""
    g_raw = g_forward(cfg, p, batch)
    d = nets.discriminate(p["Discriminator"], cfg["nets"]["discriminator"],
                          g_raw)
    err = torch.abs(g_raw - batch["x"])
    adv, l1 = torch.mean(sigmoid_ce(d, 1.0)), torch.mean(err)
    return {"g_loss": adv + cfg["config"]["L1Loss_weight"] * l1,
            "g_loss_only": adv, "L1Loss": l1,
            "PoseMaskLoss": torch.mean(err.detach() * batch["mask_r6"])}


def d_loss(cfg: Mapping, pd: Params, real: torch.Tensor,
           fake: torch.Tensor) -> torch.Tensor:
    dcfg = cfg["nets"]["discriminator"]
    d_real = nets.discriminate(pd, dcfg, real)
    d_fake = nets.discriminate(pd, dcfg, fake)
    return (torch.mean(sigmoid_ce(d_fake, 0.0))
            + torch.mean(sigmoid_ce(d_real, 1.0))) / 2.0


class Adam:
    """optax.adam(lr schedule, b1, b2, eps) in float32 over a dict of
    tensors, updated in place."""

    def __init__(self, params: Params, lr: float, b1: float, b2: float,
                 interval: int, eps: float = 1e-8):
        self.params = params
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.interval = interval
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> None:
        f32 = np.float32
        t = f32(self.count + 1)
        c1 = float(f32(1) - f32(self.b1) ** t)
        c2 = float(f32(1) - f32(self.b2) ** t)
        lr = float(f32(self.lr) * f32(0.5) ** f32(self.count // self.interval))
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k] = self.b1 * self.mu[k] + (1 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1 - self.b2) * g * g
            u = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps)
            p.sub_(lr * u)
        self.count += 1


def _leaves(cfg: Mapping, p: Mapping[str, Params], nets_: List[str]
            ) -> Params:
    """The trainable weights of `nets_` by leaf name (not the running
    statistics that a weights dict may also hold)."""
    specs = nets.param_specs(cfg)
    return {f"{net}/{name}": p[net][name] for net in nets_
            for name, _, _ in specs[net]}


G_NETS, D_NETS = ["Encoder", "ID_AE"], ["Discriminator"]


class TrainStep:
    """The reference trainer on `params` (modified in place): `step(batch)`
    runs one G update then one D update and returns the losses as 0-d
    tensors ('g_loss' with its parts, 'd_loss'); the gradients that each
    optimizer took are left in `last_grads` by leaf name ('Encoder/...',
    'Discriminator/...')."""

    def __init__(self, cfg: Mapping, params: Mapping[str, Params]):
        t = cfg["config"]
        self.cfg, self.p = cfg, params
        self.g_leaves = _leaves(cfg, params, G_NETS)
        self.d_leaves = _leaves(cfg, params, D_NETS)
        for v in (*self.g_leaves.values(), *self.d_leaves.values()):
            v.requires_grad_(True)
        self.g_opt = Adam(self.g_leaves, t["g_lr"], t["beta1"], t["beta2"],
                          t["lr_update_step"])
        self.d_opt = Adam(self.d_leaves, t["d_lr"], t["beta1"], t["beta2"],
                          t["lr_update_step"])
        self.last_grads: Params = {}

    def step(self, batch: Mapping[str, torch.Tensor]):
        cfg, p = self.cfg, self.p
        losses = g_loss(cfg, p, batch)
        g_grads = dict(zip(self.g_leaves, torch.autograd.grad(
            losses["g_loss"], list(self.g_leaves.values()))))
        self.g_opt.step(g_grads)
        with torch.no_grad():
            fake = g_forward(cfg, p, batch)
        d_total = d_loss(cfg, p["Discriminator"], batch["x"], fake)
        d_grads = dict(zip(self.d_leaves, torch.autograd.grad(
            d_total, list(self.d_leaves.values()))))
        self.d_opt.step(d_grads)
        self.last_grads = {**g_grads, **d_grads}
        return {**{k: v.detach() for k, v in losses.items()},
                "d_loss": d_total.detach()}


@torch.no_grad()
def transfer(cfg: Mapping, p: Mapping[str, Params],
             batch: Mapping[str, torch.Tensor]):
    """-> (images [B,H,W,3] in [0, 255], target pose maps [B,H,W,K], D
    logits [B])."""
    g_raw = g_forward(cfg, p, batch, pose_key="pose_rcv_target")
    score = nets.discriminate(p["Discriminator"],
                              cfg["nets"]["discriminator"], g_raw)
    images = torch.clamp((g_raw + 1.0) * 127.5, 0.0, 255.0)
    return images, pose_maps(cfg, batch["pose_rcv_target"]), score


def to_device(batch: Mapping[str, np.ndarray], device,
              dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """A host batch on `device`, its floating-point arrays in `dtype`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, dtype if v.dtype.kind == "f" else None)
        for k, v in batch.items()}
