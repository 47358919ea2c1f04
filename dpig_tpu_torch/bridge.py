"""flax param tree -> the port's module state.

`params_from_flax(tree, subtrees)` takes the JAX package's params as nested
dicts of numpy arrays (any array type numpy can read) and returns, for
each name in `subtrees`, a flat state dict keyed like the port's
`state_dict()`. Each tester declares its `SUBTREES` (`apps/testers.py`);
the default is the Stage-I nets, `Encoder`, `ID_AE`, `Discriminator` and
`Discriminator_stats`. Leaves map as:

  * conv `kernel` HWIO [kh,kw,in,out] -> `weight` OIHW [out,in,kh,kw];
  * Dense `kernel` [in,out]          -> `weight` [out,in];
  * `bias`                           -> `bias`;
  * BatchNorm `scale`                -> `weight`;
  * `stem_kernel` [3,3,D+P,hid]      -> `stem_kernel` [hid,D+P,3,3];
  * BatchNorm stats `mean`/`var`     -> `running_mean`/`running_var`.

Submodule paths carry over unchanged (`fg_tower/ConvBlockTower_0/Conv_3`
-> `fg_tower.ConvBlockTower_0.Conv_3`; the nested `PoseAE/G_Pose_Encoder`
-> `G_Pose_Encoder.` inside `PoseAE`), since the port's modules use the
flax names. A missing sub-tree, or a leaf name not listed above, raises
here; a sub-tree not asked for is left out (a JAX cold start also holds
`Gaussian_FC`, DeepFashion's single mapper); a missing or extra module key
raises where the state is loaded (`load_state_dict(strict=True)`). The
port's own checkpoints give sub-trees in the same format
(`train/checkpoint.py:restore_subtrees`).
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

STAGE1_SUBTREES = ("Encoder", "ID_AE", "Discriminator",
                   "Discriminator_stats")

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


def params_from_flax(tree: Mapping, subtrees: Sequence[str] = STAGE1_SUBTREES
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    missing = sorted(set(subtrees) - set(tree))
    if missing:
        raise KeyError(f"params_from_flax needs {list(subtrees)}; missing "
                       f"{missing}")
    state = {}
    for name in subtrees:
        flat: Dict[str, torch.Tensor] = {}
        _flatten(tree[name], "", name.endswith("_stats"), flat)
        state[name] = flat
    return state

