"""TF1 checkpoint import (port of `dpig_tpu/train/tf1_import.py`): the
published reference checkpoints (Market, DeepFashion) into the port's
nets, without TensorFlow or JAX.

    python -m dpig_tpu_torch.train.tf1_import --ckpt_path=<tf1 prefix> \
        --model_dir=<out> [--img_H=128 --img_W=64 ...]

The checkpoint is read by `tf1_bundle.read_bundle` (the TF V2 tensor
bundle format, optimizer slots and beta powers dropped, as
`load_tf1_variables` drops them). The reference persists variables under
two naming conventions (SURVEY §5.4):

  * slim-scoped G-side nets, e.g. 'Encoder/G_encoder/Conv_3/weights':
    slim numbers Conv, Conv_1, ... and fully_connected, ... per scope IN
    CREATION ORDER, convs and FCs in separate families;
  * tflib flat registry names for the discriminator
    ('Discriminator.1.Filters', '.BN2.scale', '.Output.W', ...).

Pairing is positional per (scope, family): the i-th reference conv / FC
kernel goes to the i-th conv / dense of the port's module in creation
order. The port's modules carry the flax names (`bridge.py`), so the JAX
package's order tables apply to a view of the module's state dict nested
on its dots (`flax_stream_order`); a count or shape mismatch raises with
both lists, never guesses. Layouts: TF HWIO conv kernels -> OIHW, [in,
out] matmuls -> [out, in], as `bridge._leaf` maps flax's. The D's
`Output.W` rows are permuted from the reference's NCHW flatten to the
NHWC one, and its BatchNorm moving statistics become `running_mean` /
`running_var`.

Where the JAX package's table pairs the encoder scope only with the FG/BG
encoder (a DeepFashion 256 template, whose encoder is the single-branch
`RoiEncoder`, raises a KeyError there), the port pairs it with the
template's encoder, FG/BG or single-branch.

`main()` writes `<model_dir>/ckpt/step_00000000/state.pt`
(`train/checkpoint.py`): every template net in `g_params`, the imported
`Discriminator` in `d_params` / `d_stats`, no optimizer state; the four
`--pretrained_*` flags and `--ckpt_path` take it as it is.
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from . import tf1_bundle

State = Dict[str, torch.Tensor]


# --------------------------------------------------------------- reference
def load_tf1_variables(ckpt_path: str) -> Dict[str, np.ndarray]:
    """Every model variable of a TF1 checkpoint (a prefix, or a directory
    with a `checkpoint` file)."""
    return tf1_bundle.read_bundle(ckpt_path)


def _slim_sort_key(name: str) -> Tuple:
    """Creation order for slim auto-numbered names: Conv < Conv_1 < Conv_10."""
    parts = []
    for seg in name.split("/"):
        m = re.match(r"^(.*?)(?:_(\d+))?$", seg)
        parts.append((m.group(1), int(m.group(2) or 0)))
    return tuple(parts)


def ref_kernel_stream(var_dict: Mapping[str, np.ndarray], scope: str
                      ) -> List[Tuple[str, np.ndarray, Optional[np.ndarray]]]:
    """(name, kernel, bias) in creation order for a scope: convs first
    (slim 'Conv*' sorts before 'fully_connected*'), each family in
    creation order."""
    prefix = scope + "/"
    kernels = sorted((n for n in var_dict
                      if n.startswith(prefix) and n.endswith("weights")),
                     key=_slim_sort_key)
    out = []
    for kn in kernels:
        base = kn.rsplit("/", 1)[0]
        out.append((kn, var_dict[kn], var_dict.get(base + "/biases")))
    return out


# ------------------------------------------------------------- port orders
def _nat(p: str) -> Tuple:
    return tuple(int(s) if s.isdigit() else s for s in re.split(r"(\d+)", p))


def _nested(state: Mapping[str, torch.Tensor]) -> Dict:
    """A flat state dict as a tree on its dots ('a.b.weight' ->
    {'a': {'b': {'weight': ...}}})."""
    tree: Dict = {}
    for key, value in state.items():
        node = tree
        *path, leaf = key.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


def _tower_convs(tree: Mapping, prefix: str) -> List[str]:
    names = sorted((k for k in tree if k.startswith("Conv_")), key=_nat)
    return [f"{prefix}/{n}" for n in names]


def _trunk_denses(tree: Mapping, prefix: str) -> List[str]:
    names = sorted((k for k in tree if k.startswith("Dense_")), key=_nat)
    return [f"{prefix}/{n}" for n in names]


def flax_stream_order(kind: str, state: Mapping[str, torch.Tensor]
                      ) -> List[str]:
    """Kernel paths of a port module's state dict in MODULE CREATION
    ORDER, convs first then denses, matching ref_kernel_stream's family
    order; '/'-joined submodule names, 'stem' for the generator's raw
    `stem_kernel` / `stem_bias`.

    kinds: 'mapper' (GaussianMapper / the pose encoder),
           'pose_decoder' (the pose decoder),
           'uae_generator' (UAEGenerator),
           'roi_encoder_fgbg' (RoiEncoderFgBg),
           'roi_encoder' (RoiEncoder).
    """
    params = _nested(state)
    if kind == "mapper":
        return _trunk_denses(params["FCResTrunk_0"], "FCResTrunk_0") + \
            ["Dense_0"]
    if kind == "pose_decoder":
        return _trunk_denses(params["FCResTrunk_0"], "FCResTrunk_0") + \
            ["coords", "visible"]
    if kind == "uae_generator":
        convs = (["stem"]
                 + _tower_convs(params["ConvBlockTower_0"],
                                "ConvBlockTower_0")
                 + sorted((k for k in params if k.startswith("Conv_")),
                          key=_nat)
                 + ["to_rgb"])
        return convs + ["bottleneck", "unbottleneck"]
    if kind == "roi_encoder_fgbg":
        convs = (_tower_convs(params["_Stem_0"], "_Stem_0")
                 + _tower_convs(params["fg_tower"]["ConvBlockTower_0"],
                                "fg_tower/ConvBlockTower_0")
                 + _tower_convs(params["bg_tower"], "bg_tower"))
        return convs + ["fg_tower/Dense_0", "bg_fc"]
    if kind == "roi_encoder":
        convs = (_tower_convs(params["_Stem_0"], "_Stem_0")
                 + _tower_convs(params["_RoiTower_0"]["ConvBlockTower_0"],
                                "_RoiTower_0/ConvBlockTower_0"))
        return convs + ["_RoiTower_0/Dense_0"]
    raise ValueError(f"unknown module kind {kind!r}")


def _keys(path: str) -> Tuple[str, str]:
    """The state-dict keys of a kernel path's weight and bias."""
    if path == "stem":
        return "stem_kernel", "stem_bias"
    base = path.replace("/", ".")
    return f"{base}.weight", f"{base}.bias"


def _ref_shape(weight: torch.Tensor) -> Tuple[int, ...]:
    """A port weight's shape in the reference's layout (HWIO, [in, out])."""
    s = tuple(weight.shape)
    return (s[2], s[3], s[1], s[0]) if len(s) == 4 else s[::-1]


def _from_ref(kernel: np.ndarray) -> torch.Tensor:
    """A reference kernel in the port's layout: HWIO -> OIHW, [in, out]
    -> [out, in], float32 (`bridge._leaf`)."""
    arr = np.array(kernel, dtype=np.float32)
    arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
    return torch.from_numpy(np.ascontiguousarray(arr))


def _vector(value: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32).reshape(-1))


# ------------------------------------------------------------------ import
def import_scope(var_dict: Mapping[str, np.ndarray], scope: str, kind: str,
                 state: Mapping[str, torch.Tensor]) -> State:
    """A copy of one module's state dict filled from one reference scope,
    positionally."""
    ref = ref_kernel_stream(var_dict, scope)
    order = flax_stream_order(kind, state)
    if len(ref) != len(order):
        raise ValueError(
            f"scope {scope!r}: {len(ref)} reference kernels vs "
            f"{len(order)} port kernels — architecture mismatch.\n"
            f"ref: {[n for n, *_ in ref]}\nport: {order}")
    new = dict(state)
    for (ref_name, kernel, bias), path in zip(ref, order):
        wkey, bkey = _keys(path)
        want = _ref_shape(new[wkey])
        if want != tuple(kernel.shape):
            raise ValueError(
                f"shape mismatch pairing {ref_name} -> {path}: reference "
                f"{tuple(kernel.shape)} vs port {want} (reference layout)")
        new[wkey] = _from_ref(kernel)
        if bias is not None and bkey in new:
            if tuple(bias.shape) != tuple(new[bkey].shape):
                raise ValueError(
                    f"shape mismatch pairing {ref_name} -> {path}: bias "
                    f"{tuple(bias.shape)} vs port {tuple(new[bkey].shape)}")
            new[bkey] = _vector(bias)
    return new


def import_discriminator(var_dict: Mapping[str, np.ndarray],
                         d_state: Mapping[str, torch.Tensor],
                         img_h: int, img_w: int,
                         name: str = "Discriminator") -> State:
    """A copy of the DCGAN D's state dict (parameters and running
    statistics) filled from the tflib flat registry
    ('Discriminator.N.Filters/.Biases', '.BNn.*', '.Output.W/.b';
    wgan_gp.py:407-440).

    tflib convs take HWIO filters even in NCHW mode, so they map as the
    slim kernels do; the reference's logit flattens the NCHW feature map
    (row c*(H*W) + h*W + w), the port's the NHWC one (h*(W*C) + w*C + c),
    so Output.W's rows are permuted. The reference numbers its BatchNorms
    BN2..BNn (stages 1..n-1), the port BatchNorm_0..; both keep the moving
    mean and variance as the running statistics."""
    new = dict(d_state)
    n_stages = sum(1 for k in new if re.fullmatch(r"Conv_\d+\.weight", k))
    for i in range(n_stages):
        kn = f"{name}.{i + 1}.Filters"
        want = _ref_shape(new[f"Conv_{i}.weight"])
        if want != tuple(var_dict[kn].shape):
            raise ValueError(f"shape mismatch {kn}: reference "
                             f"{tuple(var_dict[kn].shape)} vs port {want}")
        new[f"Conv_{i}.weight"] = _from_ref(var_dict[kn])
        bias = var_dict.get(f"{name}.{i + 1}.Biases")
        if bias is not None and f"Conv_{i}.bias" in new:
            new[f"Conv_{i}.bias"] = _vector(bias)
        bkey, pkey = f"{name}.BN{i + 1}", f"BatchNorm_{i - 1}"
        if f"{bkey}.scale" in var_dict and f"{pkey}.weight" in new:
            new[f"{pkey}.weight"] = _vector(var_dict[f"{bkey}.scale"])
            new[f"{pkey}.bias"] = _vector(var_dict[f"{bkey}.offset"])
            if f"{pkey}.running_mean" in new:
                new[f"{pkey}.running_mean"] = _vector(
                    var_dict[f"{bkey}.moving_mean"])
                new[f"{pkey}.running_var"] = _vector(
                    var_dict[f"{bkey}.moving_variance"])
    w = np.asarray(var_dict[f"{name}.Output.W"])
    h_f, w_f = img_h // (2 ** n_stages), img_w // (2 ** n_stages)
    c_f = w.shape[0] // (h_f * w_f)
    w = w.reshape(c_f, h_f, w_f, -1).transpose(1, 2, 0, 3).reshape(
        h_f * w_f * c_f, -1)               # rows (c, h, w) -> (h, w, c)
    want = _ref_shape(new["logit.weight"])
    if want != w.shape:
        raise ValueError(f"shape mismatch {name}.Output.W: reference "
                         f"{w.shape} vs port {want}")
    new["logit.weight"] = _from_ref(w)
    new["logit.bias"] = _vector(var_dict[f"{name}.Output.b"])
    return new


# reference scope -> (the port's sub-tree, or (sub-tree, submodule prefix),
# module kind); the encoder's kind follows the template (module docstring)
SCOPE_TABLE = {
    "Encoder/G_encoder": ("Encoder", "roi_encoder_fgbg"),
    "ID_AE/G": ("ID_AE", "uae_generator"),
    "PoseAE/G_Pose_Encoder": (("PoseAE", "G_Pose_Encoder"), "mapper"),
    "PoseAE/G_Pose_Decoder": (("PoseAE", "G_Pose_Decoder"), "pose_decoder"),
    "PoseGaussian/G_FC": ("PoseGaussian", "mapper"),
    "Gaussian_FC_Fg/G_FC": ("Gaussian_FC_Fg", "mapper"),
    "Gaussian_FC_Bg/G_FC": ("Gaussian_FC_Bg", "mapper"),
    "Gaussian_FC/G_FC": ("Gaussian_FC", "mapper"),
}


def _kind(kind: str, state: Mapping[str, torch.Tensor]) -> str:
    if kind == "roi_encoder_fgbg" and not any(k.startswith("fg_tower.")
                                              for k in state):
        return "roi_encoder"
    return kind


def import_variables(var_dict: Mapping[str, np.ndarray],
                     template: Mapping[str, Mapping[str, torch.Tensor]],
                     scopes: Optional[List[str]] = None,
                     img_h: int = 128, img_w: int = 64) -> Dict[str, State]:
    """The reference scopes of `var_dict` imported into copies of the
    template's sub-trees ({sub-tree: state dict}, the D's with its running
    statistics). `scopes`: keys of SCOPE_TABLE (and 'Discriminator'), by
    default every one present in both the checkpoint and the template.
    Returns only the sub-trees imported."""
    present = {n.split("/")[0] for n in var_dict}
    out: Dict[str, State] = {}
    if "Discriminator.1.Filters" in var_dict and \
            "Discriminator" in template and \
            (scopes is None or "Discriminator" in scopes):
        out["Discriminator"] = import_discriminator(
            var_dict, template["Discriminator"], img_h, img_w)
    for scope, (target, kind) in SCOPE_TABLE.items():
        if scopes is not None and scope not in scopes:
            continue
        if scope.split("/")[0] not in present:
            continue
        if isinstance(target, tuple):
            net, sub = target
            if net not in template:
                continue
            tree = out.setdefault(net, dict(template[net]))
            part = {k[len(sub) + 1:]: v for k, v in tree.items()
                    if k.startswith(sub + ".")}
            filled = import_scope(var_dict, scope, kind, part)
            tree.update({f"{sub}.{k}": v for k, v in filled.items()})
        elif target in template:
            out[target] = import_scope(var_dict, scope,
                                       _kind(kind, template[target]),
                                       template[target])
    return out


def import_checkpoint(ckpt_path: str,
                      template: Mapping[str, Mapping[str, torch.Tensor]],
                      scopes: Optional[List[str]] = None,
                      img_h: int = 128, img_w: int = 64) -> Dict[str, State]:
    """`import_variables` of the TF1 checkpoint at `ckpt_path`."""
    return import_variables(load_tf1_variables(ckpt_path), template, scopes,
                            img_h, img_w)


def reference_variables(state: Mapping[str, Mapping[str, torch.Tensor]],
                        img_h: int = 128, img_w: int = 64,
                        name: str = "Discriminator"
                        ) -> Dict[str, np.ndarray]:
    """The inverse of `import_variables`: the reference's variables (slim
    names numbered in creation order, the D's tflib names with Output.W in
    NCHW row order and its BatchNorm moving statistics) of the sub-trees
    of `state` that SCOPE_TABLE names, float32 in the reference's layouts.
    The checks write TF1 checkpoints of known weights with it."""
    out: Dict[str, np.ndarray] = {}

    def ref(t: torch.Tensor) -> np.ndarray:
        a = t.detach().cpu().numpy().astype(np.float32)
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T

    for scope, (target, kind) in SCOPE_TABLE.items():
        net, sub = target if isinstance(target, tuple) else (target, None)
        if net not in state:
            continue
        part = state[net] if sub is None else {
            k[len(sub) + 1:]: v for k, v in state[net].items()
            if k.startswith(sub + ".")}
        count = {4: 0, 2: 0}
        for path in flax_stream_order(_kind(kind, part), part):
            wkey, bkey = _keys(path)
            rank = part[wkey].dim()
            family = "Conv" if rank == 4 else "fully_connected"
            base = f"{scope}/{family}" + (f"_{count[rank]}" if count[rank]
                                          else "")
            count[rank] += 1
            out[f"{base}/weights"] = ref(part[wkey])
            out[f"{base}/biases"] = ref(part[bkey])
    d = state.get("Discriminator")
    if d is not None:
        n_stages = sum(1 for k in d if re.fullmatch(r"Conv_\d+\.weight", k))
        for i in range(n_stages):
            out[f"{name}.{i + 1}.Filters"] = ref(d[f"Conv_{i}.weight"])
            out[f"{name}.{i + 1}.Biases"] = ref(d[f"Conv_{i}.bias"])
            if i:
                for tf_key, key in (("scale", "weight"), ("offset", "bias"),
                                    ("moving_mean", "running_mean"),
                                    ("moving_variance", "running_var")):
                    out[f"{name}.BN{i + 1}.{tf_key}"] = ref(
                        d[f"BatchNorm_{i - 1}.{key}"])
        h_f, w_f = img_h // (2 ** n_stages), img_w // (2 ** n_stages)
        w = ref(d["logit.weight"])                  # [h*w*c, 1], NHWC rows
        c_f = w.shape[0] // (h_f * w_f)
        out[f"{name}.Output.W"] = np.ascontiguousarray(
            w.reshape(h_f, w_f, c_f, -1).transpose(2, 0, 1, 3).reshape(
                c_f * h_f * w_f, -1))
        out[f"{name}.Output.b"] = ref(d["logit.bias"])
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def template_state(cfg) -> Dict[str, State]:
    """Fresh weights of every net the testers take (`FullSamplingTester`'s
    and DeepFashion's single mapper `Gaussian_FC`), never restored, on
    the CPU, as the JAX package's `_AllNets` template."""
    from ..apps.testers import FullSamplingTester

    class _AllNets(FullSamplingTester):
        SUBTREES = FullSamplingTester.SUBTREES + ("Gaussian_FC",)

        def _warn_cold_start(self, missing) -> None:
            pass  # a template: fresh on purpose

    return _AllNets(cfg, params={}).cpu_state()


def checkpoint_tree(template: Mapping[str, State],
                    imported: Mapping[str, State]) -> Dict:
    """The port's checkpoint tree of an import: step 0, every template net
    in g_params (the imported ones replaced), the imported D in d_params
    and d_stats (its running statistics), no optimizer state."""
    stats = ("running_mean", "running_var")
    tree: Dict = {"step": 0, "g_params": {
        k: dict(imported.get(k, v)) for k, v in template.items()
        if k != "Discriminator"}}
    if "Discriminator" in imported:
        d = imported["Discriminator"]
        tree["d_params"] = {"Discriminator": {
            k: v for k, v in d.items() if not k.endswith(stats)}}
        tree["d_stats"] = {"Discriminator": {
            k: v for k, v in d.items() if k.endswith(stats)}}
    return tree


def main(argv=None) -> Dict[str, float]:
    """CLI: a TF1 checkpoint -> a port checkpoint under --model_dir (see
    the module docstring). Scopes absent from the checkpoint keep their
    fresh template values and are listed loudly. Returns the bundle's
    bytes and the read and import seconds."""
    import os
    from ..config import get_config
    from . import checkpoint
    cfg = get_config(argv)
    if not cfg.ckpt_path or not cfg.model_dir:
        raise SystemExit("--ckpt_path=<tf1 checkpoint prefix> and "
                         "--model_dir=<output dir> are required")
    prefix = tf1_bundle.resolve_prefix(cfg.ckpt_path)
    t0 = time.perf_counter()
    var_dict = load_tf1_variables(prefix)
    t_read = time.perf_counter() - t0
    template = template_state(cfg)
    t0 = time.perf_counter()
    imported = import_variables(var_dict, template, img_h=cfg.img_H,
                                img_w=cfg.img_W)
    t_import = time.perf_counter() - t0
    missing = sorted(set(template) - set(imported))
    if missing:
        print(f"[!] scopes not found in {cfg.ckpt_path}: {missing} "
              "(kept as random init)", flush=True)
    path = checkpoint.save_tree(cfg.model_dir, 0,
                                checkpoint_tree(template, imported))
    folder = os.path.dirname(os.path.abspath(prefix))
    stem = os.path.basename(prefix)
    size = sum(os.path.getsize(os.path.join(folder, f))
               for f in os.listdir(folder)
               if f == stem + ".index" or f.startswith(stem + ".data-"))
    print(f"[*] imported {sorted(imported)} -> {path} ({size} bundle "
          f"bytes read in {t_read:.3f} s, imported in {t_import:.3f} s)",
          flush=True)
    return {"bundle_bytes": size, "read_s": t_read, "import_s": t_import}


if __name__ == "__main__":
    main()
