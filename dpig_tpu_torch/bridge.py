"""flax param tree -> the port's module state.

`params_from_flax(tree)` takes the JAX package's params for the model-12
path as nested dicts of numpy arrays (any array type numpy can read),
with exactly the sub-trees `Encoder`, `ID_AE`, `Discriminator` and
`Discriminator_stats`, and returns a dict with the same four names, each a
flat state dict keyed like the port's `state_dict()`:

  * conv `kernel` HWIO [kh,kw,in,out] -> `weight` OIHW [out,in,kh,kw];
  * Dense `kernel` [in,out]          -> `weight` [out,in];
  * `bias`                           -> `bias`;
  * BatchNorm `scale`                -> `weight`;
  * `stem_kernel` [3,3,D+P,hid]      -> `stem_kernel` [hid,D+P,3,3];
  * BatchNorm stats `mean`/`var`     -> `running_mean`/`running_var`.

Submodule paths carry over unchanged (`fg_tower/ConvBlockTower_0/Conv_3`
-> `fg_tower.ConvBlockTower_0.Conv_3`), since the port's modules use the
flax names. A missing or extra sub-tree, or a leaf name not listed above,
raises here; a missing or extra module key raises in `load_state`.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

SUBTREES = ("Encoder", "ID_AE", "Discriminator", "Discriminator_stats")

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight",
                 "stem_kernel": "stem_kernel", "stem_bias": "stem_bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _leaf(name: str, value, stats: bool) -> torch.Tensor:
    arr = np.array(value, dtype=np.float32)
    if not stats and name in ("kernel", "stem_kernel"):
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"{name} of rank {arr.ndim}: expected 2 or 4")
    return torch.from_numpy(np.ascontiguousarray(arr))


def _flatten(tree: Mapping, prefix: str, stats: bool,
             out: Dict[str, torch.Tensor]) -> None:
    table = _STAT_LEAVES if stats else _PARAM_LEAVES
    for name, value in tree.items():
        if isinstance(value, Mapping):
            _flatten(value, f"{prefix}{name}.", stats, out)
        elif name in table:
            out[prefix + table[name]] = _leaf(name, value, stats)
        else:
            raise KeyError(f"unknown flax leaf {prefix}{name}")


def params_from_flax(tree: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    got = set(tree)
    if got != set(SUBTREES):
        raise KeyError(f"params_from_flax needs exactly {list(SUBTREES)}; "
                       f"missing {sorted(set(SUBTREES) - got)}, "
                       f"extra {sorted(got - set(SUBTREES))}")
    state = {}
    for name in SUBTREES:
        flat: Dict[str, torch.Tensor] = {}
        _flatten(tree[name], "", name.endswith("_stats"), flat)
        state[name] = flat
    return state


def load_state(encoder: nn.Module, generator: nn.Module, disc: nn.Module,
               state: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
    """Copy a `params_from_flax` state into the three modules (strict:
    missing, extra or mis-shaped keys raise)."""
    encoder.load_state_dict(state["Encoder"], strict=True)
    generator.load_state_dict(state["ID_AE"], strict=True)
    disc.load_state_dict({**state["Discriminator"],
                          **state["Discriminator_stats"]}, strict=True)
