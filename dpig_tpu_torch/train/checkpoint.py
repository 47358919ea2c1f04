"""Checkpoints of a `GanState` (the port's own format; the JAX package
writes orbax, `dpig_tpu/train/checkpoint.py`), and the composition of the
four separately trained sub-nets that the `--pretrained_*` flags name
(reference trainer.py:180-213, tester.py:259-309).

One checkpoint is `<model_dir>/ckpt/step_XXXXXXXX/state.pt`: a `torch.save`
of the JAX package's keys (checkpoint.py:29-38),

  step           int
  g_params       {'Encoder': {param name: tensor}, 'ID_AE': {...}}
  d_params       {'Discriminator': {...}}
  g_opt_state    {'count': int, 'mu': {...}, 'nu': {...}} (optimizer moments)
  d_opt_state    likewise
  d_stats        {'Discriminator': {'BatchNorm_0.running_mean': ..., ...}}
  frozen_params  {'Encoder': {...}, 'ID_AE': {...}} (Stage-II samplers)

with every tensor on the CPU. As in the JAX package, a state without a D
(the pose AE) or without frozen nets leaves those keys out. A sub-tree's
tensors are keyed like its module's `state_dict()`, the format of
`bridge.params_from_flax`. The port does not read the JAX package's
orbax checkpoints itself (that needs JAX): `scripts/orbax_to_torch.py`,
run where JAX is installed, converts one into this format, optimizer
moments and D statistics included (`bridge.state_from_orbax`), and a
path that holds an orbax checkpoint raises naming that command.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Mapping, Optional

import torch
from torch import nn

from .state import GanState

STATE_FILE = "state.pt"
ORBAX_FILE = "_CHECKPOINT_METADATA"


def _ckpt_dir(model_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(model_dir), "ckpt", f"step_{step:08d}")


def _cpu(tensors) -> Dict[str, torch.Tensor]:
    return {n: t.detach().cpu() for n, t in tensors}


def _params(nets: Mapping[str, nn.Module]) -> Dict:
    return {k: _cpu(m.named_parameters()) for k, m in nets.items()}


def state_tree(state: GanState) -> Dict:
    """The checkpoint's tree of `state` (tensors copied to the CPU)."""
    def opt(o):
        s = o.state_dict()
        return {k: v if k == "count" else _cpu(v.items())
                for k, v in s.items()}
    tree = {"step": state.step, "g_params": _params(state.g_nets),
            "g_opt_state": opt(state.g_opt)}
    if state.d_nets is not None:
        tree.update(d_params=_params(state.d_nets),
                    d_opt_state=opt(state.d_opt),
                    d_stats={k: _cpu(m.named_buffers())
                             for k, m in state.d_nets.items()})
    if state.frozen_nets:
        tree["frozen_params"] = _params(state.frozen_nets)
    return tree


def save_tree(model_dir: str, step: int, tree: Dict) -> str:
    """Write a checkpoint tree under ckpt/step_<step>; returns the
    directory."""
    path = _ckpt_dir(model_dir, step)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))  # never half a file
    return path


def save_checkpoint(model_dir: str, step: int, state: GanState) -> str:
    """Write `state` under ckpt/step_<step>; returns the directory."""
    return save_tree(model_dir, step, state_tree(state))


def latest_checkpoint(model_dir: str) -> Optional[str]:
    """The newest complete step directory under model_dir/ckpt, or None."""
    root = os.path.join(os.path.abspath(model_dir), "ckpt")
    if not os.path.isdir(root):
        return None
    steps = sorted(d for d in os.listdir(root) if d.startswith("step_")
                   and os.path.exists(os.path.join(root, d, STATE_FILE)))
    return os.path.join(root, steps[-1]) if steps else None


def _holds_orbax(path: str) -> bool:
    """An orbax step directory, or a model_dir with one under ckpt/."""
    root = os.path.join(path, "ckpt")
    steps = ([os.path.join(root, d) for d in os.listdir(root)]
             if os.path.isdir(root) else [])
    return any(os.path.exists(os.path.join(d, ORBAX_FILE))
               for d in (path, *steps))


def resolve_checkpoint(path: str) -> str:
    """A step directory, or a model_dir whose newest checkpoint is taken
    (the reference's --ckpt_path / --pretrained_* take either)."""
    path = os.path.abspath(path)
    if os.path.exists(os.path.join(path, STATE_FILE)):
        return path
    latest = latest_checkpoint(path)
    if latest is not None:
        return latest
    if _holds_orbax(path):
        raise NotImplementedError(
            f"{path} holds an orbax checkpoint of the JAX package; "
            "dpig_tpu_torch reads its own (ckpt/step_*/state.pt) only. "
            "Import it first, where JAX is installed: python "
            f"scripts/orbax_to_torch.py {path} <port model_dir>, then pass "
            "<port model_dir>")
    raise FileNotFoundError(f"no checkpoint at or under {path}")


def load_tree(path: str) -> Dict:
    """The checkpoint tree at or under `path` (see `resolve_checkpoint`)."""
    return torch.load(os.path.join(resolve_checkpoint(path), STATE_FILE),
                      map_location="cpu", weights_only=True)


def restore_into_state(path: str, state: GanState) -> GanState:
    """Full resume (reference --ckpt_path): params, frozen nets, D running
    statistics, optimizer moments and step, loaded in place into `state`'s
    nets and optimizers (strict: a missing or extra tensor raises)."""
    tree = load_tree(path)
    for k, m in state.g_nets.items():
        m.load_state_dict(tree["g_params"][k], strict=True)
    for k, m in state.frozen_nets.items():
        m.load_state_dict(tree["frozen_params"][k], strict=True)
    if state.d_nets is not None:
        for k, m in state.d_nets.items():
            m.load_state_dict({**tree["d_params"][k], **tree["d_stats"][k]},
                              strict=True)
        state.d_opt.load_state_dict(tree["d_opt_state"])
    state.g_opt.load_state_dict(tree["g_opt_state"])
    state.step = int(tree["step"])
    return state


def restore_subtrees(path: str, names: Iterable[str]
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Named sub-trees of a checkpoint, looked up in its trained g_params,
    then in the frozen nets it carried, then in its d_params (the
    reference's partial savers), e.g. `restore_subtrees(stage1_dir,
    ['Encoder', 'ID_AE'])`. A name in none of them raises KeyError."""
    tree = load_tree(path)
    groups = [tree.get(k, {}) for k in ("g_params", "frozen_params",
                                        "d_params")]
    out = {}
    for name in names:
        found = [g[name] for g in groups if name in g]
        if not found:
            raise KeyError(
                f"sub-tree {name!r} not in checkpoint {path} (has g="
                f"{list(groups[0])}, frozen={list(groups[1])}, "
                f"d={list(groups[2])})")
        out[name] = found[0]
    return out


def compose_pretrained(cfg) -> Dict[str, Dict[str, torch.Tensor]]:
    """The four `--pretrained_*` flags merged into one state of named
    sub-trees, in the JAX package's order (checkpoint.py:140-159)."""
    merged: Dict[str, Dict[str, torch.Tensor]] = {}
    if cfg.pretrained_path:
        merged.update(restore_subtrees(cfg.pretrained_path,
                                       ["Encoder", "ID_AE"]))
    if cfg.pretrained_poseAE_path:
        merged.update(restore_subtrees(cfg.pretrained_poseAE_path,
                                       ["PoseAE"]))
    if cfg.pretrained_appSample_path:
        try:
            merged.update(restore_subtrees(
                cfg.pretrained_appSample_path,
                ["Gaussian_FC_Fg", "Gaussian_FC_Bg"]))
        except KeyError:  # DeepFashion's single mapper (model 103)
            merged.update(restore_subtrees(cfg.pretrained_appSample_path,
                                           ["Gaussian_FC"]))
    if cfg.pretrained_poseSample_path:
        merged.update(restore_subtrees(cfg.pretrained_poseSample_path,
                                       ["PoseGaussian"]))
    return merged
