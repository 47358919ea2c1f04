"""Checkpoints of a `GanState` (the port's own format; the JAX package
writes orbax, `dpig_tpu/train/checkpoint.py`).

One checkpoint is `<model_dir>/ckpt/step_XXXXXXXX/state.pt`: a `torch.save`
of the JAX package's keys (checkpoint.py:29-37),

  step         int
  g_params     {'Encoder': {param name: tensor}, 'ID_AE': {...}}
  d_params     {'Discriminator': {...}}
  g_opt_state  {'count': int, 'mu': {...}, 'nu': {...}} (optimizer moments)
  d_opt_state  likewise
  d_stats      {'Discriminator': {'BatchNorm_0.running_mean': ..., ...}}

with every tensor on the CPU. Reading a JAX orbax checkpoint is not
ported yet.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from .state import GanState

STATE_FILE = "state.pt"


def _ckpt_dir(model_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(model_dir), "ckpt", f"step_{step:08d}")


def _cpu(tensors) -> Dict[str, torch.Tensor]:
    return {n: t.detach().cpu() for n, t in tensors}


def state_tree(state: GanState) -> Dict:
    """The checkpoint's tree of `state` (tensors copied to the CPU)."""
    def opt(o):
        s = o.state_dict()
        return {k: v if k == "count" else _cpu(v.items())
                for k, v in s.items()}
    return {
        "step": state.step,
        "g_params": {k: _cpu(m.named_parameters())
                     for k, m in state.g_nets.items()},
        "d_params": {k: _cpu(m.named_parameters())
                     for k, m in state.d_nets.items()},
        "g_opt_state": opt(state.g_opt),
        "d_opt_state": opt(state.d_opt),
        "d_stats": {k: _cpu(m.named_buffers())
                    for k, m in state.d_nets.items()},
    }


def save_checkpoint(model_dir: str, step: int, state: GanState) -> str:
    """Write `state` under ckpt/step_<step>; returns the directory."""
    path = _ckpt_dir(model_dir, step)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(state_tree(state), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))  # never half a file
    return path


def latest_checkpoint(model_dir: str) -> Optional[str]:
    """The newest complete step directory under model_dir/ckpt, or None."""
    root = os.path.join(os.path.abspath(model_dir), "ckpt")
    if not os.path.isdir(root):
        return None
    steps = sorted(d for d in os.listdir(root) if d.startswith("step_")
                   and os.path.exists(os.path.join(root, d, STATE_FILE)))
    return os.path.join(root, steps[-1]) if steps else None


def resolve_checkpoint(path: str) -> str:
    """A step directory, or a model_dir whose newest checkpoint is taken
    (the reference's --ckpt_path / --pretrained_* take either)."""
    path = os.path.abspath(path)
    if not os.path.exists(os.path.join(path, STATE_FILE)):
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoint at or under {path}")
        return latest
    return path


def restore_into_state(path: str, state: GanState) -> GanState:
    """Full resume (reference --ckpt_path): params, D running statistics,
    optimizer moments and step, loaded in place into `state`'s nets and
    optimizers (strict: a missing or extra tensor raises)."""
    tree = torch.load(os.path.join(resolve_checkpoint(path), STATE_FILE),
                      map_location="cpu", weights_only=True)
    for k, m in state.g_nets.items():
        m.load_state_dict(tree["g_params"][k], strict=True)
    for k, m in state.d_nets.items():
        m.load_state_dict({**tree["d_params"][k], **tree["d_stats"][k]},
                          strict=True)
    state.g_opt.load_state_dict(tree["g_opt_state"])
    state.d_opt.load_state_dict(tree["d_opt_state"])
    state.step = int(tree["step"])
    return state
