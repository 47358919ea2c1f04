"""How precise are float32 Stage-I gradients? A CPU check behind the
tolerances of the port's training tests and of `chip_smoke.py`.

    JAX_PLATFORMS=cpu python scripts/port_grad_precision.py
    python scripts/port_grad_precision.py --full-only   # part 2; no JAX

1. Small config (32x16, hidden 16, z 16, batch 4): the encoder's gradient
   under a fixed random cotangent, from the JAX package jitted, the JAX
   package eager and the port in float32, each against the port in
   float64 (max|diff| / max|grad| per tensor, worst three tensors).
2. Full Market width, batch 2 (the parity batch of `chip_smoke.py`): the
   port's G gradients in float32 against float64 (||diff|| / ||grad|| and
   max|diff| / max|grad| over Encoder + ID_AE, and over each), for the
   adversarial term alone, the L1 term alone and the whole G objective.
   The generator's embedding-stem term stays float32 in the float64 run
   (models/generator.py).

Runs on the CPU (a few minutes); part 1 imports both packages, like the
tests, part 2 only the port.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from dpig_tpu_torch.apps.common import batch_to_device, l1_loss
from dpig_tpu_torch.apps.stage1_app import GAN_MODE, Stage1App
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.data.synthetic import SyntheticLoader
from dpig_tpu_torch.losses import gan

SMALL = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16)
CPU = torch.device("cpu")


def _as(module, dtype):
    """`module` with its parameters and its layers' compute dtype
    (`models/layers.py`: `Conv`, `Dense`, `BatchNorm`, the generator's
    stem) in `dtype`."""
    module.to(dtype)
    for m in module.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dtype
    return module


def encoder_grads_small():
    import jax
    from dpig_tpu.apps.stage1_app import Stage1App as JaxStage1App
    from dpig_tpu.config import Config as JaxConfig
    from dpig_tpu.data.synthetic import SyntheticLoader as JaxLoader
    japp = JaxStage1App(JaxConfig(**SMALL))
    st = japp.init_state(jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.array, {
        "Encoder": st.g_params["Encoder"], "ID_AE": st.g_params["ID_AE"],
        "Discriminator": st.d_params["Discriminator"],
        "Discriminator_stats": st.d_stats})
    b = next(JaxLoader(4, 32, 16, seed=3))
    bbox, vis = b["part_bbox"][:, :7], b["part_vis"][:, :7].astype(np.float32)
    ct = np.random.default_rng(1).normal(size=(4, 352)).astype(np.float32)

    def objective(p):
        return (japp.encoder.apply({"params": p}, b["x"], b["mask_r6"], bbox,
                                   vis) * ct).sum()

    def bridged(g):
        return params_from_flax({**tree, "Encoder": g})["Encoder"]

    runs = {"JAX jitted": bridged(jax.jit(jax.grad(objective))(
                tree["Encoder"])),
            "JAX eager": bridged(jax.grad(objective)(tree["Encoder"]))}
    app = Stage1App(Config(platform="cpu", **SMALL), CPU,
                    state=params_from_flax(tree))
    for label, dtype in (("port float32", torch.float32),
                         ("port float64", torch.float64)):
        enc = _as(app.encoder, dtype).requires_grad_(True)
        out = enc(*(torch.from_numpy(a).to(dtype) for a in (b["x"],
                                                             b["mask_r6"])),
                  torch.from_numpy(bbox), torch.from_numpy(vis).to(dtype))
        names = [n for n, _ in enc.named_parameters()]
        grads = torch.autograd.grad(
            (out * torch.from_numpy(ct).to(dtype)).sum(),
            list(enc.parameters()))
        runs[label] = dict(zip(names, grads))
    ref = runs.pop("port float64")
    for label, grads in runs.items():
        err = {n: float((grads[n].double() - ref[n]).abs().max())
               / float(ref[n].abs().max()) for n in ref}
        worst = sorted(err, key=err.get, reverse=True)[:3]
        print(f"[small] encoder, {label} vs port float64: "
              + ", ".join(f"{n} {err[n]:.2e}" for n in worst), flush=True)


def g_grads_full(dtype, term):
    """{'Encoder': [grads], 'ID_AE': [grads]} of one G objective term."""
    cfg = Config(platform="cpu", batch_size=2)
    app = Stage1App(cfg, CPU)
    nets = {"Encoder": app.encoder, "ID_AE": app.generator}
    for m in (app.encoder, app.generator, app.disc):
        _as(m, dtype).requires_grad_(True)
    batch = batch_to_device(next(SyntheticLoader(2, 128, 64, seed=99)), CPU)
    x, pose, mask, bbox, vis = app.step_inputs(batch)
    x, pose, mask, vis = (t.to(dtype) for t in (x, pose, mask, vis))
    g_raw, _ = app.generator(app.encoder(x, mask, bbox, vis), pose)
    loss = 0.0
    if term != "L1 term":
        loss = loss + gan.g_loss(GAN_MODE, app.disc(g_raw))
    if term != "adversarial term":
        loss = loss + cfg.L1Loss_weight * l1_loss(g_raw, x)
    params = [p for m in nets.values() for p in m.parameters()]
    grads = iter(g.double() for g in torch.autograd.grad(loss, params))
    return {k: [next(grads) for _ in m.parameters()] for k, m in nets.items()}


def _errors(f32, f64):
    """(||diff|| / ||grad||, max|diff| / max|grad|) over the tensors."""
    l2 = float(torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(f32, f64))
                          / sum((b ** 2).sum() for b in f64)))
    mx = max(float((a - b).abs().max()) for a, b in zip(f32, f64)) / max(
        float(b.abs().max()) for b in f64)
    return l2, mx


def main() -> None:
    torch.manual_seed(0)
    if "--full-only" not in sys.argv[1:]:
        encoder_grads_small()
    for term in ("adversarial term", "L1 term", "G objective"):
        f32 = g_grads_full(torch.float32, term)
        f64 = g_grads_full(torch.float64, term)
        parts = {"Encoder + ID_AE": (sum(f32.values(), []),
                                     sum(f64.values(), [])),
                 **{k: (f32[k], f64[k]) for k in f32}}
        print(f"[full] G gradients, {term}, float32 vs float64, "
              f"Market width batch 2 (||diff||/||grad||, max|diff|/max|grad|"
              f"): " + "; ".join(f"{k} {e[0]:.3e}, {e[1]:.3e}" for k, e in
                                 ((k, _errors(*v)) for k, v in parts.items())),
              flush=True)


if __name__ == "__main__":
    main()
