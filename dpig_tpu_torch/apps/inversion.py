"""Embedding inversion, the `--inverse_fg/bg/pose` modes (port of
`dpig_tpu/apps/inversion.py:25-74`; the capability behind the reference's
inverse flags, config.py:74-77).

Given a real image, find the Gaussian-mapper inputs z such that
mapper(z) ~= encoder(image) for the toggled factors: Adam on
||mapper(z) - emb||^2, the encoder run once and the mappers frozen, so
only z takes gradients. The optimizer is the port's optax-exact Adam
(`train/state.py`) with optax.adam's defaults; the JAX package's
`lax.fori_loop` is a Python loop here. The start z0 is an argument: the
JAX package draws it with threefry inside the step, the CLI here draws it
from a CPU torch.Generator seeded with --random_seed (`draw_noise`), and
tests pass JAX's own draw.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch

from ..bridge import STAGE1_SUBTREES
from ..train.state import Adam
from .stage1_app import full_float32
from .testers import _TesterBase


class InversionTool(_TesterBase):
    """The Stage-I nets and the two Market appearance mappers
    (`Gaussian_FC_Fg`: 224 -> 224, hidden 512; `Gaussian_FC_Bg`: 128 ->
    128, hidden 256), as the JAX package's REQUIRED set names them. At
    256 the single-branch encoder gives a 224-d code with no BG part:
    the FG mapper inverts it as in JAX, and `invert_bg` raises (JAX fails
    there on a broadcast of the 128-d BG output against an empty target)."""

    SUBTREES = STAGE1_SUBTREES + ("Gaussian_FC_Fg", "Gaussian_FC_Bg")

    @full_float32()
    def invert(self, batch: Mapping[str, torch.Tensor],
               z0: Mapping[str, torch.Tensor], lr: float = 0.05,
               steps: int = 300, invert_bg: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Device batch, z0 {'fg': [B, 224], 'bg': [B, 128]} (any device)
        -> (z_fg, z_bg, final loss), the loss that of the returned z."""
        with torch.no_grad():
            embs = self._encode_app(batch)
        target_fg, target_bg = embs[:, :self.fg_dim], embs[:, self.fg_dim:]
        if invert_bg and target_bg.shape[1] == 0:
            raise ValueError(
                f"--inverse_bg at {self.cfg.img_H}x{self.cfg.img_W}: the "
                "single-branch encoder's code has no BG part to invert; "
                "pass --inverse_fg alone")
        z = {k: z0[k].to(self.device, torch.float32).clone()
             .requires_grad_(k == "fg" or invert_bg) for k in ("fg", "bg")}

        def loss_fn():
            out_fg = self.mappers["Gaussian_FC_Fg"](z["fg"])
            loss = torch.mean((out_fg - target_fg) ** 2)
            if invert_bg:
                out_bg = self.mappers["Gaussian_FC_Bg"](z["bg"])
                loss = loss + torch.mean((out_bg - target_bg) ** 2)
            return loss

        # optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8, eps_root 0. Without
        # invert_bg, JAX's BG gradient is 0 and Adam leaves z_bg as it is.
        opt = Adam({k: t for k, t in z.items() if t.requires_grad},
                   lambda count: lr, b1=0.9, b2=0.999, eps=1e-8)
        for _ in range(steps):
            opt.step(torch.autograd.grad(loss_fn(), opt.params.values()))
        with torch.no_grad():
            return z["fg"].detach(), z["bg"].detach(), loss_fn()
