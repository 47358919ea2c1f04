"""GAN train state + optimizer table (port of `dpig_tpu/train/state.py`).

Optimizer table as reference trainer.py:116-149:
  wgan, lsgan -> RMSProp (decay .9, eps 1e-10) + weight clipping for wgan
                 (done by the step fn)
  wgan-gp     -> Adam(b1=0.5, b2=0.9)
  dcgan, ae   -> Adam(b1=0.5, b2=0.999)
LR schedule: halve every `lr_update_step` updates, lr * 0.5^(count //
interval), where `count` is the number of updates this optimizer applied
before the current one (0 first), as in optax.

Both optimizers are written out here in optax's arithmetic, operation for
operation and in float32 (the bias corrections and the learning rate are
float32 scalars, as JAX computes them): `torch.optim.RMSprop` puts eps
outside the square root where optax's `scale_by_rms` puts it inside, and
the same arithmetic keeps `torch` and `optax` within rounding of each
other on identical gradients. Their state starts at zero, as optax's does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..parallel import dist


def halving_schedule(base_lr: float, interval: int) -> Callable[[int], float]:
    """count -> float32(base_lr) * 0.5^(count // interval)."""
    def schedule(count: int) -> float:
        return float(np.float32(base_lr)
                     * np.float32(0.5) ** np.float32(count // interval))
    return schedule


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in float32 (optax's `bias_correction`)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class _Optimizer:
    """An optax-style transformation bound to named tensors: `step(grads)`
    applies one update in place, `state_dict()` holds its moments. Each
    update is a few multi-tensor (`torch._foreach_*`) operations over all
    the tensors at once, each the elementwise operation optax applies."""

    MOMENTS: Sequence[str] = ()

    def __init__(self, params: Mapping[str, torch.Tensor],
                 lr: Callable[[int], float]):
        self.params = dict(params)
        self.lr = lr
        self.count = 0
        self.moments = {m: {n: torch.zeros_like(p)
                            for n, p in self.params.items()}
                        for m in self.MOMENTS}

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """Update the parameters, in `params` order, by `grads` averaged
        over the ranks of the process group, if there is one (the
        gradient all-reduce XLA inserts under the JAX package's mesh)."""
        grads = list(grads)
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        self.apply(dist.average_gradients(grads))

    @torch.no_grad()
    def apply(self, grads: List[torch.Tensor]) -> None:
        """The update proper, by gradients every rank already shares."""
        update = self._direction(grads)
        torch._foreach_mul_(update, -self.lr(self.count))
        torch._foreach_add_(list(self.params.values()), update)
        self.count += 1

    def _direction(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    def _moment(self, name: str, grads: List[torch.Tensor], decay: float,
                square: bool) -> List[torch.Tensor]:
        """moment = (1 - decay) * g^(1 or 2) + decay * moment, in place."""
        t = list(self.moments[name].values())
        new = torch._foreach_mul(grads, grads) if square else grads
        new = torch._foreach_mul(new, 1 - decay)
        torch._foreach_mul_(t, decay)
        torch._foreach_add_(t, new)
        return t

    def state_dict(self) -> Dict:
        return {"count": self.count,
                **{m: {n: t.detach().clone() for n, t in v.items()}
                   for m, v in self.moments.items()}}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        for m, v in self.moments.items():
            if set(state[m]) != set(v):
                raise KeyError(f"optimizer state {m!r} has keys "
                               f"{sorted(set(state[m]) ^ set(v))} that do "
                               "not match the parameters")
            for n, t in v.items():
                t.copy_(state[m][n])
        self.count = int(state["count"])


class Adam(_Optimizer):
    """optax.adam: scale_by_adam(b1, b2, eps, eps_root=0) + lr schedule."""

    MOMENTS = ("mu", "nu")

    def __init__(self, params, lr, b1: float, b2: float, eps: float = 1e-8):
        super().__init__(params, lr)
        self.b1, self.b2, self.eps = b1, b2, eps

    def _direction(self, grads):
        mu = self._moment("mu", grads, self.b1, square=False)
        nu = self._moment("nu", grads, self.b2, square=True)
        mu_hat = torch._foreach_div(mu, _bias_correction(self.b1,
                                                         self.count + 1))
        den = torch._foreach_div(nu, _bias_correction(self.b2,
                                                      self.count + 1))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(mu_hat, den)
        return mu_hat


class RMSProp(_Optimizer):
    """optax.rmsprop: scale_by_rms(decay, eps) (eps inside the square
    root, accumulator from 0) + lr schedule; no momentum."""

    MOMENTS = ("nu",)

    def __init__(self, params, lr, decay: float = 0.9, eps: float = 1e-10):
        super().__init__(params, lr)
        self.decay, self.eps = decay, eps

    def _direction(self, grads):
        nu = self._moment("nu", grads, self.decay, square=True)
        scale = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(scale, grads)
        return scale


def make_optimizer(mode: str, params: Mapping[str, torch.Tensor],
                   base_lr: float, lr_update_step: int) -> _Optimizer:
    lr = halving_schedule(base_lr, lr_update_step)
    if mode in ("wgan", "lsgan"):
        # TF RMSPropOptimizer defaults: decay .9, momentum 0, eps 1e-10.
        return RMSProp(params, lr, decay=0.9, eps=1e-10)
    if mode == "wgan-gp":
        return Adam(params, lr, b1=0.5, b2=0.9)
    if mode in ("dcgan", "ae"):  # 'ae': plain reconstruction (model 2)
        return Adam(params, lr, b1=0.5, b2=0.999)
    raise ValueError(f"unknown optimizer mode {mode!r}")


def named_params(nets: Mapping[str, nn.Module]) -> Dict[str, torch.Tensor]:
    """{'Encoder': enc, ...} -> {'Encoder/fg_tower.Dense_0.weight': p, ...}."""
    return {f"{k}/{n}": p for k, m in nets.items()
            for n, p in m.named_parameters()}


@dataclasses.dataclass
class GanState:
    """Generator/discriminator nets, their optimizers, the frozen nets and
    the step count (the counterpart of the JAX package's `GanState`).

    `g_nets` / `d_nets` / `frozen_nets` name the sub-nets as the JAX
    package names its param sub-trees ('Encoder', 'ID_AE' /
    'Discriminator' / the Stage-I nets a Stage-II sampler trains against);
    the nets hold the parameters and the D's BatchNorm running statistics
    (its `d_stats`), the optimizers hold the moments. The pose AE (model 2)
    has no D (`d_nets` and `d_opt` None). Frozen nets take no gradient and
    are in no optimizer.
    """
    g_nets: Dict[str, nn.Module]
    d_nets: Optional[Dict[str, nn.Module]]
    g_opt: _Optimizer
    d_opt: Optional[_Optimizer]
    frozen_nets: Dict[str, nn.Module] = dataclasses.field(default_factory=dict)
    step: int = 0

    @classmethod
    def create(cls, *, g_nets: Mapping[str, nn.Module], mode: str,
               g_lr: float, lr_update_step: int,
               d_nets: Optional[Mapping[str, nn.Module]] = None,
               d_lr: Optional[float] = None,
               frozen_nets: Optional[Mapping[str, nn.Module]] = None,
               step: int = 0) -> "GanState":
        g_nets = dict(g_nets)
        d_nets = dict(d_nets) if d_nets is not None else None
        frozen_nets = dict(frozen_nets or {})
        for m in frozen_nets.values():
            m.requires_grad_(False)
        d_opt = (make_optimizer(mode, named_params(d_nets), d_lr,
                                lr_update_step)
                 if d_nets is not None else None)
        return cls(g_nets=g_nets, d_nets=d_nets,
                   g_opt=make_optimizer(mode, named_params(g_nets), g_lr,
                                        lr_update_step),
                   d_opt=d_opt, frozen_nets=frozen_nets, step=step)

    @property
    def g_params(self) -> List[torch.Tensor]:
        return list(self.g_opt.params.values())

    @property
    def d_params(self) -> List[torch.Tensor]:
        return list(self.d_opt.params.values()) if self.d_opt else []

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor of the state: the nets' parameters and buffers and
        the optimizers' moments."""
        nets = [*self.g_nets.values(), *(self.d_nets or {}).values(),
                *self.frozen_nets.values()]
        out = [t for m in nets for t in (*m.parameters(), *m.buffers())]
        for opt in (self.g_opt, self.d_opt):
            if opt is not None:
                out += [t for v in opt.moments.values() for t in v.values()]
        return out
