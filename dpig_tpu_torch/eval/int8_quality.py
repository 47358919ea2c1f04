"""int8 post-training-quantization quality gate on trained checkpoints: the
port's twin of `scripts/int8_quality.py`.

  python -m dpig_tpu_torch.eval.int8_quality train <steps> [model_dir]
      [--size=256] [--lr=...] [--pool=N] [--batch_size=N]
  python -m dpig_tpu_torch.eval.int8_quality check <model_dir>
      [--per_layer] [--percentile=99.9] [--method=entropy|channel|absmax]
      [--fallback=dec/Conv_13,to_rgb] [--fallback_mode=island|legacy]
      [--transfer] [--size=256]
  python -m dpig_tpu_torch.eval.int8_quality sweep <model_dir> [--size=256]
  python -m dpig_tpu_torch.eval.int8_quality gate <model_dir>
      [--max_delta=0.002] [--min_ssim=0.9] [--size=256] [--transfer]

Every subcommand runs on the card; `--platform=cpu` runs it on the CPU.

`train` runs Stage I (Market 128x64 bs64 bfloat16 with the fast D step,
or with --size=256 the DeepFashion model-101 shape: 256x256, RoiEncoder
repeat+1, generator repeat-1, bs16) on a pool of synthetic batches
(seed 123) to <steps>, checkpointing in the port's format
(`train/checkpoint.py`). `check` loads the newest checkpoint and compares
the float32 generator with the s8-chained int8 one on held-out synthetic
batches (seed 999): SSIM(int8, float), and each one's SSIM to x_target
(the protocol metric) and their delta. `--transfer` gates the model-12
pipeline instead: the int8 FG/BG encoder feeding the int8 generator, the
tester's --inference_dtype=int8 wiring, against the float pipeline, with
the encoder's embedding rel-error (128x64 only: no int8 encoder exists at
256). `--per_layer` ranks the generator's layers by how much of the int8
error leaving each one out of the table (bf16) recovers, on the legacy
graph. `sweep` tabulates the six calibration schemes; `gate` passes iff
|delta| <= max_delta and SSIM(int8, float) >= min_ssim, and the CLI exits
0 or 1 by it.
"""
from __future__ import annotations

import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..apps.common import (batch_to_device, pose_maps_from_batch,
                           select_device, select_parts)
from ..apps.stage1_app import Stage1App, full_float32
from ..config import Config
from ..data.synthetic import SyntheticLoader
from ..models import quant as quant_mod
from ..train import checkpoint as ckpt
from .metrics import ssim_images

# DF-shape (model 101) overrides for --size=256: generator at
# repeat_num-1, RoiEncoder at repeat_num+1 (Stage1App takes both from
# img_H); the quality batches are capped at 32 (`_gate_context`).
DF256 = dict(img_H=256, img_W=256, batch_size=16)
TRAIN_SEED, HELD_OUT_SEED = 123, 999
LOG_EVERY, CKPT_EVERY = 200, 4000


def _gen_repeat(cfg) -> int:
    """Generator tower depth: repeat_num-1 at 256 (trainer_256.py:597)."""
    return cfg.repeat_num - 1 if cfg.img_H >= 256 else cfg.repeat_num


def train(steps: int, model_dir: str, pool_size: int = 64,
          cfg_overrides: dict = None) -> None:
    """The gate's train loop: a device-resident pool of synthetic batches
    cycled round-robin, the metrics read (a sync) only every LOG_EVERY
    steps and at the last, a checkpoint every CKPT_EVERY steps and at the
    end; resumes from the newest checkpoint under model_dir."""
    base = dict(img_H=128, img_W=64, batch_size=64,
                compute_dtype="bfloat16", model_dir=model_dir,
                max_step=steps, fast_gan_step=True)
    base.update(cfg_overrides or {})
    cfg = Config(**base)
    device = select_device(cfg.platform)
    print(f"[*] train config: {cfg.img_H}x{cfg.img_W} bs{cfg.batch_size} "
          f"g_lr={cfg.g_lr} pool={pool_size} on {device}", flush=True)
    app = Stage1App(cfg, device)
    state = app.init_state()
    start = 0
    path = ckpt.latest_checkpoint(model_dir)
    if path is not None:
        state = ckpt.restore_into_state(path, state)
        start = int(path.rsplit("_", 1)[-1])
        print(f"[*] resuming from {path} (step {start})", flush=True)
    loader = SyntheticLoader(cfg.batch_size, cfg.img_H, cfg.img_W,
                             seed=TRAIN_SEED)
    pool = [batch_to_device(next(loader), device) for _ in range(pool_size)]
    t0 = time.perf_counter()
    for i in range(start, steps):
        m = app.train_step(state, pool[i % pool_size])
        if i % LOG_EVERY == LOG_EVERY - 1 or i == steps - 1:
            g = float(m["g_loss"])
            if not math.isfinite(g):
                raise FloatingPointError(
                    f"step {i}: {({k: float(v) for k, v in m.items()})}")
            rate = ((i + 1 - start) * cfg.batch_size
                    / (time.perf_counter() - t0))
            print(f"[{i}] g_loss={g:.4f} "
                  f"L1={float(m['L1Loss']):.4f} "
                  f"d={float(m['d_loss']):.4f} {rate:.0f} img/s",
                  flush=True)
        if (i + 1) % CKPT_EVERY == 0 and i + 1 < steps:
            ckpt.save_checkpoint(model_dir, i + 1, state)
            print(f"[*] periodic checkpoint at step {i + 1}", flush=True)
    if start >= steps:
        # the resumed checkpoint is already at/past the target: saving a
        # step_{steps} file here would mislabel later-step weights
        print(f"[*] nothing to do: resumed step {start} >= target {steps}")
        return
    ckpt.save_checkpoint(model_dir, steps, state)
    print(f"[*] saved step-{steps} checkpoint under {model_dir}")


def _gate_context(model_dir: str, n_batches: int,
                  cfg_overrides: dict = None) -> dict:
    """What check() and sweep() share, built once: the newest checkpoint's
    encoder and generator, the held-out batches, and the forwards."""
    base = dict(img_H=128, img_W=64, batch_size=64,
                compute_dtype="bfloat16", model_dir=model_dir)
    base.update(cfg_overrides or {})
    if base["img_H"] >= 256:
        base["batch_size"] = min(base["batch_size"], 32)
    cfg = Config(**base)
    device = select_device(cfg.platform)
    path = ckpt.latest_checkpoint(model_dir)
    if path is None:
        raise AssertionError(f"no checkpoint under {model_dir}")
    app = Stage1App(cfg, device, disc=False,
                    state=ckpt.restore_subtrees(path, ["Encoder", "ID_AE"]))
    gen = app.generator
    print(f"[*] checking {path}")

    loader = SyntheticLoader(cfg.batch_size, cfg.img_H, cfg.img_W,
                             seed=HELD_OUT_SEED)
    batches = [next(loader) for _ in range(n_batches)]

    def enc_inputs(b):
        """(x, fg_mask, bbox, vis) on the device: the encoder's inputs."""
        jb = batch_to_device(b, device)
        bbox, vis = select_parts(jb["part_bbox"], jb["part_vis"],
                                 cfg.roi_part_num)
        return jb["x"], jb["mask_r6"], bbox, vis

    @torch.inference_mode()
    def embs_pose(b):
        """(float embeddings, pose maps, x) of a batch, on the device."""
        jb = batch_to_device(b, device)
        bbox, vis = select_parts(jb["part_bbox"], jb["part_vis"],
                                 cfg.roi_part_num)
        embs = app._encode(jb["x"], jb["mask_r6"], bbox, vis)
        return embs, pose_maps_from_batch(jb, cfg), jb["x"]

    rep = _gen_repeat(cfg)

    def forward(chained):
        @torch.inference_mode()
        @full_float32()
        def fwd(e, po, q=None):
            return quant_mod.uae_forward(gen, e, po, rep,
                                         cfg.conv_hidden_num, quant=q,
                                         chained=chained)[0]
        return fwd

    fwds = {chained: forward(chained) for chained in (True, False)}
    return dict(cfg=cfg, app=app, batches=batches, embs_pose=embs_pose,
                enc_inputs=enc_inputs, fwds=fwds,
                fwd_f=fwds[True])  # without a table: the float32 forward


def _to_np(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def check(model_dir: str, per_layer: bool = False, n_batches: int = 4,
          percentile=None, fallback: str = "", method: str = "channel",
          fallback_mode: str = "island", transfer: bool = False,
          cfg_overrides: dict = None, ctx: dict = None) -> dict:
    """float vs int8 on the held-out batches (the first calibrates, the
    rest are scored) -> the four SSIM numbers (and with --transfer
    `emb_rel_err`; with --per_layer `per_layer`, {layer: recovery of the
    unchained graph's mean |err| when it runs bf16})."""
    if transfer:
        # checked before the checkpoint is read, so a 256 config fails on
        # the real reason
        h = ctx["cfg"].img_H if ctx else (cfg_overrides or {}).get(
            "img_H", 128)
        if h >= 256:
            raise AssertionError(
                "--transfer gates the FgBg int8 encoder; no int8 encoder "
                "exists at 256 (it runs in the compute dtype — "
                "testers._inference_params)")
    ctx = ctx or _gate_context(model_dir, n_batches, cfg_overrides)
    cfg, app, batches = ctx["cfg"], ctx["app"], ctx["batches"]
    embs_pose, fwd_f = ctx["embs_pose"], ctx["fwd_f"]

    enc_q = None
    if transfer:
        # the model-12 tester's int8 wiring (testers._inference_params):
        # the int8 FG/BG encoder feeds the int8 generator
        granularity = "channel" if method == "channel" else "tensor"
        with full_float32():
            qe = quant_mod.QuantizedEncoder(
                app.encoder, cfg.repeat_num, cfg.conv_hidden_num,
                part_num=cfg.roi_part_num, calib_granularity=granularity)
            qe.calibrate([ctx["enc_inputs"](batches[0])])

        @torch.inference_mode()
        @full_float32()
        def enc_q(b):
            return qe(*ctx["enc_inputs"](b))

    bf16_layers = frozenset(n for n in fallback.split(",") if n)
    if bf16_layers:
        how = ("exact-bf16 islands in the chained graph"
               if fallback_mode == "island"
               else "legacy per-layer-quant routing")
        print(f"[*] selective bf16 fallback: {sorted(bf16_layers)} ({how})")
    fwd = ctx["fwds"][not bf16_layers or fallback_mode == "island"]

    e0, p0, _ = embs_pose(batches[0])
    if enc_q is not None:
        # the generator's activation statistics come from the int8
        # encoder's embeddings, as they do when serving
        e0 = enc_q(batches[0])
    if method != "absmax":
        print(f"[*] calibration method: {method}")
    granularity = "tensor"
    if method == "channel":
        method, granularity = "absmax", "channel"
    q = quant_mod.QuantizedGenerator(app.generator, _gen_repeat(cfg),
                                     cfg.conv_hidden_num,
                                     calib_percentile=percentile,
                                     bf16_layers=bf16_layers,
                                     calib_method=method,
                                     calib_granularity=granularity)
    with torch.inference_mode(), full_float32():
        q.calibrate([e0], [p0])

    def to255(a):
        return np.clip((a + 1) * 127.5, 0, 255)

    ssim_if, d_float, d_int8, emb_err = [], [], [], []
    for b in batches[1:]:
        e, po, x = embs_pose(b)
        eq = e
        if enc_q is not None:
            eq = enc_q(b)
            ef, eqn = _to_np(e), _to_np(eq)
            emb_err.append(np.abs(eqn - ef).mean()
                           / max(np.abs(ef).mean(), 1e-12))
        gf = _to_np(fwd_f(e, po))
        gq = _to_np(fwd(eq, po, q.quant))
        x255 = to255(_to_np(x))
        ssim_if.append(ssim_images(to255(gq), to255(gf)).mean())
        d_float.append(ssim_images(to255(gf), x255).mean())
        d_int8.append(ssim_images(to255(gq), x255).mean())
    out = {"ssim_int8_float": float(np.mean(ssim_if)),
           "ssim_to_target_float": float(np.mean(d_float)),
           "ssim_to_target_int8": float(np.mean(d_int8)),
           "delta": float(np.mean(d_int8) - np.mean(d_float))}
    if emb_err:
        out["emb_rel_err"] = float(np.mean(emb_err))
        print(f"[transfer] int8-encoder embedding rel.err = "
              f"{out['emb_rel_err']:.4f}")
    print(f"SSIM(int8,float)      = {out['ssim_int8_float']:.4f}")
    print(f"SSIM-to-target float  = {out['ssim_to_target_float']:.4f}")
    print(f"SSIM-to-target int8   = {out['ssim_to_target_int8']:.4f}")
    print(f"SSIM-to-target delta  = {out['delta']:+.4f}")

    if per_layer:
        # leave-one-layer-out on the legacy (unchained) graph: one conv
        # out of the s8 weight table runs bf16; rank the recovery
        e, po, _ = embs_pose(batches[1])
        gf = fwd_f(e, po)
        base = None
        rows = []
        for drop in [None] + sorted(q.quant["weights"]):
            qq = {"weights": {k: v for k, v in q.quant["weights"].items()
                              if k != drop},
                  "act_scales": q.quant["act_scales"]}
            if "act_folded" in q.quant:  # keep folded-dequant semantics
                qq["act_folded"] = q.quant["act_folded"]
            err = float((ctx["fwds"][False](e, po, qq) - gf).abs().mean())
            if drop is None:
                base = err
                print(f"  all-int8 (unchained) mean|err| = {err:.5f}")
            else:
                rows.append((base - err, drop))
        rows.sort(reverse=True)
        print("  top error contributors (bf16-fallback recovery):")
        for rec, name in rows[:6]:
            print(f"    {name:16s} {rec:+.5f}")
        out["per_layer"] = {name: rec for rec, name in rows}
    return out


def sweep(model_dir: str, n_batches: int = 4,
          cfg_overrides: dict = None) -> dict:
    """The quality table over every calibration scheme and the decoder-tail
    bf16 fallback, for the newest checkpoint in model_dir. A scheme that
    raises is printed and left out."""
    repeat = _gen_repeat(Config(**(cfg_overrides or {})))
    last = 3 * repeat - 2  # final decoder res-pair Conv_{last-1},Conv_{last}
    tail = f"dec/Conv_{last - 1},dec/Conv_{last},to_rgb"
    configs = [
        ("absmax", {"method": "absmax"}),
        ("percentile 99.9", {"percentile": 99.9, "method": "percentile"}),
        ("per-channel (default)", {"method": "channel"}),
        ("tail-fallback (legacy)",
         {"fallback": tail, "method": "absmax", "fallback_mode": "legacy"}),
        ("tail-fallback (island)",
         {"fallback": tail, "method": "absmax", "fallback_mode": "island"}),
        # entropy last, as in JAX: its histogram pass once faulted the TPU
        ("entropy", {"method": "entropy"}),
    ]
    ctx = _gate_context(model_dir, n_batches, cfg_overrides)
    rows = []
    for label, kw in configs:
        print(f"\n=== {label}")
        try:
            rows.append((label, check(model_dir, n_batches=n_batches,
                                      cfg_overrides=cfg_overrides, ctx=ctx,
                                      **kw)))
        except Exception as e:  # noqa: BLE001 — one scheme must not
            print(f"[!] {label} FAILED: {type(e).__name__}: "
                  f"{str(e)[:200]}")  # end the rest of the sweep
    print(f"\n{'scheme':24s} {'SSIM(int8,float)':>17s} {'to-target Δ':>12s}")
    for label, r in rows:
        print(f"{label:24s} {r['ssim_int8_float']:17.4f} "
              f"{r['delta']:+12.4f}")
    return dict(rows)


def gate(model_dir: str, max_delta: float = 0.002, min_ssim: float = 0.9,
         transfer: bool = False, cfg_overrides: dict = None) -> bool:
    """Deploy gate for the shipping int8 defaults (per-channel folded
    calibration, chained graph): passes iff the protocol metric's delta
    (SSIM to target, int8 against float) is within max_delta and
    SSIM(int8, float) is at least min_ssim."""
    r = check(model_dir, transfer=transfer, cfg_overrides=cfg_overrides)
    ok = abs(r["delta"]) <= max_delta and r["ssim_int8_float"] >= min_ssim
    print(f"[{'PASS' if ok else 'FAIL'}] |delta|={abs(r['delta']):.4f} "
          f"(max {max_delta}) SSIM(int8,float)={r['ssim_int8_float']:.4f} "
          f"(min {min_ssim})")
    if not ok:
        print("    remedy order: 1) rank layers with `check --per_layer`;"
              " 2) --int8_fallback_layers=<top names> (island mode keeps"
              " chained throughput); 3) --inference_dtype=bf16")
    return ok


def _value(argv, flag: str):
    """The value of the last `--flag=value` in argv, or None."""
    vals = [a.split("=", 1)[1] for a in argv if a.startswith(f"--{flag}=")]
    return vals[-1] if vals else None


def main(argv=None) -> int:
    """The CLI (argv as `scripts/int8_quality.py` takes it, plus
    --platform=cpu) -> the exit code: `gate` 0 on PASS, 1 on FAIL."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        raise SystemExit(__doc__)
    cmd, rest = argv[0], argv[1:]
    # --size=256 switches every subcommand to the DF-256 (model 101)
    # shape; the configs otherwise match the Market gate
    overrides = dict(DF256) if "--size=256" in rest else {}
    platform = _value(rest, "platform")
    if platform is not None:
        overrides["platform"] = platform
    if cmd == "train":
        lr = _value(rest, "lr")
        if lr is not None:
            overrides["g_lr"] = overrides["d_lr"] = float(lr)
        if _value(rest, "batch_size") is not None:
            overrides["batch_size"] = int(_value(rest, "batch_size"))
        model_dir = (rest[1] if len(rest) > 1 and not rest[1].startswith("--")
                     else os.path.join(tempfile.gettempdir(), "q20k"))
        train(int(rest[0]), model_dir,
              pool_size=int(_value(rest, "pool") or 64),
              cfg_overrides=overrides)
        return 0
    if cmd == "sweep":
        sweep(rest[0], cfg_overrides=overrides)
        return 0
    if cmd == "gate":
        kw = {"transfer": "--transfer" in rest}
        for flag in ("max_delta", "min_ssim"):
            if _value(rest, flag) is not None:
                kw[flag] = float(_value(rest, flag))
        return 0 if gate(rest[0], cfg_overrides=overrides, **kw) else 1
    if cmd == "check":
        pct = _value(rest, "percentile")
        check(rest[0], per_layer="--per_layer" in rest,
              percentile=None if pct is None else float(pct),
              fallback=_value(rest, "fallback") or "",
              method=_value(rest, "method") or "channel",
              fallback_mode=_value(rest, "fallback_mode") or "island",
              transfer="--transfer" in rest, cfg_overrides=overrides)
        return 0
    raise SystemExit(f"unknown subcommand {cmd!r} (train, check, sweep, "
                     "gate)")


if __name__ == "__main__":
    sys.exit(main())
