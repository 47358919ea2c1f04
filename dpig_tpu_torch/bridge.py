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

`state_from_orbax(tree)` is the other half: a whole checkpoint of the
JAX package, as `dpig_tpu.train.checkpoint.restore_tree` gives it (orbax
restores optax's namedtuples as dicts and its tuples as lists), becomes
the port's checkpoint tree (`train/checkpoint.py`): params and frozen
nets through `params_from_flax`, the D's `d_stats` as its BatchNorm
`running_mean` / `running_var`, and each optax state as the port
optimizer's `{'count', 'mu', 'nu'}` (`opt_state_from_optax`).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

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



def _fields(node) -> Mapping:
    """An optax state node as a dict (a namedtuple, or orbax's dict)."""
    return node._asdict() if hasattr(node, "_asdict") else node


def opt_state_from_optax(opt_state: Sequence, subtrees: Sequence[str]
                         ) -> Dict[str, Any]:
    """optax's state of `make_optimizer` -> the port optimizer's
    `state_dict()`: `{'count': int, 'mu': {...}, 'nu': {...}}`, each moment
    keyed `<sub-tree>/<param name>` as `train.state.named_params`.

    Adam is (ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count)),
    RMSProp (ScaleByRmsState(nu), ScaleByScheduleState(count),
    EmptyState()): it has no mu, and its count is the schedule's. The
    moments are param-shaped trees and map as the params do (a conv
    kernel's moment is transposed as the kernel)."""
    parts = [_fields(n) for n in opt_state if n is not None and _fields(n)]
    if len(parts) != 2:
        raise ValueError(f"expected (scale_by_*, schedule) optax state, got "
                         f"{len(parts)} non-empty parts")
    inner, schedule = parts
    count = int(np.asarray(schedule["count"]))
    if "count" in inner and int(np.asarray(inner["count"])) != count:
        raise ValueError(f"optax counts disagree: {int(inner['count'])} "
                         f"(moments) vs {count} (schedule)")
    out: Dict[str, Any] = {"count": count}
    for moment in ("mu", "nu"):
        if moment in inner:
            flat = params_from_flax(inner[moment], subtrees)
            out[moment] = {f"{k}/{n}": t for k, d in flat.items()
                           for n, t in d.items()}
    if "nu" not in out:
        raise KeyError(f"unknown optax state with keys {sorted(inner)}")
    return out


def state_from_orbax(tree: Mapping) -> Dict[str, Any]:
    """A JAX package checkpoint tree (`restore_tree`) -> the port's
    checkpoint tree, each key present only where the JAX tree has it (the
    D's statistics wherever it has a D: FC critics have none)."""
    out: Dict[str, Any] = {"step": int(np.asarray(tree["step"]))}
    for side in ("g", "d"):
        params = tree.get(f"{side}_params")
        if params is None:
            continue
        names = list(params)
        out[f"{side}_params"] = params_from_flax(params, names)
        if tree.get(f"{side}_opt_state") is not None:
            out[f"{side}_opt_state"] = opt_state_from_optax(
                tree[f"{side}_opt_state"], names)
    if "d_params" in out:
        names = list(out["d_params"])
        out["d_stats"] = {n: {} for n in names}
        if tree.get("d_stats"):
            if len(names) != 1:
                raise ValueError(f"d_stats with {len(names)} D sub-trees "
                                 f"{names}: cannot tell whose they are")
            out["d_stats"][names[0]] = params_from_flax(
                {"d_stats": tree["d_stats"]}, ["d_stats"])["d_stats"]
    frozen = tree.get("frozen_params")
    if frozen:
        out["frozen_params"] = params_from_flax(frozen, list(frozen))
    return out
