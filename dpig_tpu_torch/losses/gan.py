"""4-mode GAN losses (port of `dpig_tpu/losses/gan.py`; reference
trainer.py:217-252 `_gan_loss`).

Modes: 'wgan' (+weight clip, done by the train step), 'wgan-gp' (gradient
penalty through `torch.autograd.grad(create_graph=True)`), 'dcgan'
(sigmoid CE), 'lsgan' (least squares). The JAX package draws the penalty's
interpolation weights from an rng; here the caller passes them (`alpha`),
so both sides can be given the same numbers.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

GP_LAMBDA = 10.0        # wgan_gp.py:97-108
CRITIC_ITERS = 5        # wgan_gp.py:113
WGAN_CLIP = 0.01        # trainer.py:126-127


def g_loss(mode: str, disc_fake: torch.Tensor) -> torch.Tensor:
    if mode in ("wgan", "wgan-gp"):
        return -torch.mean(disc_fake)
    if mode == "dcgan":
        # mean sigmoid_CE(logits=fake, labels=1)
        return torch.mean(_sigmoid_ce(disc_fake, 1.0))
    if mode == "lsgan":
        return torch.mean((disc_fake - 1.0) ** 2)
    raise ValueError(f"unknown GAN mode {mode!r}")


def d_loss(
    mode: str,
    disc_real: torch.Tensor,
    disc_fake: torch.Tensor,
    *,
    critic_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    real_data: Optional[torch.Tensor] = None,
    fake_data: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
    gp_lambda: float = GP_LAMBDA,
) -> torch.Tensor:
    if mode == "wgan":
        return torch.mean(disc_fake) - torch.mean(disc_real)
    if mode == "wgan-gp":
        loss = torch.mean(disc_fake) - torch.mean(disc_real)
        gp = gradient_penalty(critic_fn, real_data, fake_data, alpha)
        return loss + gp_lambda * gp
    if mode == "dcgan":
        loss = torch.mean(_sigmoid_ce(disc_fake, 0.0))
        loss = loss + torch.mean(_sigmoid_ce(disc_real, 1.0))
        return loss / 2.0
    if mode == "lsgan":
        return (torch.mean((disc_real - 1.0) ** 2)
                + torch.mean(disc_fake ** 2)) / 2.0
    raise ValueError(f"unknown GAN mode {mode!r}")


def gradient_penalty(
    critic_fn: Callable[[torch.Tensor], torch.Tensor],
    real_data: torch.Tensor,
    fake_data: torch.Tensor,
    alpha: torch.Tensor,
) -> torch.Tensor:
    """WGAN-GP penalty (trainer.py:226-236): E[(||dD/dx||_2 - 1)^2] at
    x = real + alpha * (fake - real).

    `alpha` is U[0,1] per sample, shaped [B, 1, ..., 1] like the JAX
    package's draw. The norm runs over all non-batch axes, as the JAX
    package generalizes the reference's axis-1 norm. The penalty stays
    differentiable w.r.t. the critic's parameters (create_graph).
    """
    interp = real_data + alpha * (fake_data - real_data)
    if not interp.requires_grad:
        interp = interp.requires_grad_(True)
    (grads,) = torch.autograd.grad(critic_fn(interp).sum(), interp,
                                   create_graph=True)
    axes = tuple(range(1, grads.dim()))
    slopes = torch.sqrt(torch.sum(grads ** 2, dim=axes) + 1e-12)
    return torch.mean((slopes - 1.0) ** 2)


@torch.no_grad()
def clip_params(params: Iterable[torch.Tensor],
                bound: float = WGAN_CLIP) -> None:
    """WGAN weight clipping, in place, over (discriminator) parameters: two
    multi-tensor passes (`clamp_min_`, `clamp_max_`), the arithmetic of
    `clamp_(-bound, bound)` without a launch per tensor."""
    params = list(params)
    torch._foreach_clamp_min_(params, -bound)
    torch._foreach_clamp_max_(params, bound)


def _sigmoid_ce(logits: torch.Tensor, label: float) -> torch.Tensor:
    """Numerically-stable sigmoid cross-entropy with constant labels."""
    return (torch.clamp(logits, min=0) - logits * label
            + torch.log1p(torch.exp(-torch.abs(logits))))
