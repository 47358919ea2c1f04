"""int8 post-training-quantized inference for the U-net generator and the
FG/BG ROI encoder, and the generator's bfloat16 raw-param forward (port of
`dpig_tpu/models/quant.py`).

Scheme (as in JAX): per-output-channel symmetric s8 weights, s8
activations at calibrated scales (per tensor, or per input channel folded
into the weights: `--int8_calibration=channel`, the CLI default), every
quantized conv an s8 x s8 sum in int32 with a float32 epilogue
(`kernels/s8_conv.py`: the hand-written CUDA kernel on the card, its plain
version on the CPU). The denses stay bfloat16. The decoder's NN-upsample ->
1x1-conv pairs run as 1x1 conv -> upsample, an exact commute.

Functions take the port's modules (`UAEGenerator`, `RoiEncoderFgBg`) where
JAX takes raw params, and their layer names (`enc/Conv_0`, `dec/Conv_13`,
`to_rgb`, `g_stem`, `stem/Conv_1`, `fg/Conv_3`, `bg/Conv_3`, ...) are the
JAX package's. Tensors are NHWC here, as there; float convs permute to
NCHW views. A quant table is a dict: `weights` {name: (w8 [Co,kh,kw,Ci]
int8, w_scale [Co] float32)}, `act_scales` {name: float32 scalar or
per-channel tensor}, and the flags `act_folded` (per-channel scales folded
into the weights) and `act_pinned` (each downsample conv's input scale
pinned to its skip's decoder scale); `bridge.quant_from_jax` turns a JAX
table into one. `_pin_layout` (a TPU layout pin) has no counterpart.

Every forward here runs its float32 parts in float32 (TF32 off): callers
run them under `apps.stage1_app.full_float32`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.s8_conv import epilogue, s8_conv
from ..ops.crop import crop_body_rois
from ..ops.image import upscale_nn
from .generator import _constant_input_stem, stem_bias_map_nhwc
from .layers import conv2d_same

BF16 = torch.bfloat16
F32 = torch.float32
_HIST_BINS = 512  # entropy-calibration histogram resolution


def _conv(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None, stride: int = 1
          ) -> torch.Tensor:
    """NHWC SAME conv with an OIHW weight, in x's dtype; the bias added
    after (a rounding of its own, as `quant.py:_conv`)."""
    out = conv2d_same(x.permute(0, 3, 1, 2), weight, None,
                      stride).permute(0, 2, 3, 1)
    return out if bias is None else out + bias


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """float -> s8 at a scalar or per-last-axis-channel scale."""
    return torch.clamp(torch.round(x.to(F32) / scale), -127,
                       127).to(torch.int8)


def _head_scale(scale: torch.Tensor, c: int) -> torch.Tensor:
    """First-c-channels slice of a per-channel scale (a scalar as is)."""
    return scale[:c] if scale.dim() else scale


def _tail_scale(scale: torch.Tensor, c: int) -> torch.Tensor:
    """Last-c-channels slice of a per-channel scale (a scalar as is)."""
    return scale[-c:] if scale.dim() else scale


def enc_layer_names(repeat_num: int) -> List[Tuple[str, str]]:
    """(kind, name) for ConvBlockTower convs in creation order."""
    out = []
    i = 0
    for idx in range(repeat_num):
        out.append(("res", f"Conv_{i}")); i += 1
        out.append(("res", f"Conv_{i}")); i += 1
        if idx < repeat_num - 1:
            out.append(("down", f"Conv_{i}")); i += 1
    return out


def dec_layer_names(repeat_num: int) -> List[Tuple[str, str]]:
    out = []
    i = 0
    for idx in range(repeat_num):
        out.append(("res", f"Conv_{i}")); i += 1
        out.append(("res", f"Conv_{i}")); i += 1
        if idx < repeat_num - 1:
            out.append(("up1x1", f"Conv_{i}")); i += 1
    return out


def _dense(x: torch.Tensor, dense, dtype: torch.dtype) -> torch.Tensor:
    """flax-style Dense in `dtype`: matmul rounded, then the bias added."""
    return F.linear(x.to(dtype), dense.weight.to(dtype)) + \
        dense.bias.to(dtype)


def _percentile(a: torch.Tensor, p: float) -> torch.Tensor:
    """`jnp.percentile(a, p)` (linear interpolation) in float32, by a sort:
    `torch.quantile` refuses inputs above 2^24 elements."""
    a = torch.sort(a.reshape(-1)).values
    q = torch.tensor(p, dtype=F32, device=a.device) / 100
    n = torch.tensor(float(a.numel()), dtype=F32, device=a.device)
    q = q * (n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1 - high_w
    last = a.numel() - 1
    lo, hi = (min(max(int(v), 0), last) for v in (low, high))
    return a[lo] * low_w + a[hi] * high_w


def _histogram(a: torch.Tensor, amax: float) -> torch.Tensor:
    """Entropy-calibration pass 2 (quant.py:164-181): a strided subsample
    of at most ~4M elements of |x|, binned by truncating x * (512 / amax)
    to int32, clipped, counted."""
    flat = a.reshape(-1)
    flat = flat[::max(1, flat.numel() // (1 << 22))]
    k = torch.tensor(_HIST_BINS / amax, dtype=F32, device=a.device)
    idx = torch.clamp((flat * k).to(torch.int32), 0, _HIST_BINS - 1)
    return torch.bincount(idx.to(torch.int64), minlength=_HIST_BINS)


def _gen_layer(gen, name: str):
    """The conv module of a generator layer name."""
    if name.startswith("enc/"):
        return getattr(gen.ConvBlockTower_0, name[4:])
    if name.startswith("dec/"):
        return getattr(gen, name[4:])
    return getattr(gen, name)


def uae_forward(gen, embs: torch.Tensor, pose: torch.Tensor,
                repeat_num: int, hidden_num: int,
                quant: Optional[Dict] = None, collect_stats: bool = False,
                calib_percentile: Optional[float] = None,
                calib_hist_ranges: Optional[Dict[str, float]] = None,
                calib_channel: bool = False, chained: bool = True):
    """Layer-by-layer UAEGenerator forward (quant.py:129-253); pose NHWC.

    quant=None, collect_stats=False  -> float32 forward (== the module's).
    collect_stats=True               -> also {layer: statistic of input}:
                                        absmax, per-channel absmax
                                        (`calib_channel`), the percentile,
                                        or a histogram (`calib_hist_ranges`).
    quant=table                      -> int8 convs, chained s8 graph
                                        (`_uae_forward_int8`) unless
                                        chained=False, the legacy per-layer
                                        graph with bfloat16 between layers.
    -> (out [B,H,W,3] float32, z) (+ stats).
    """
    if quant is not None and chained and not collect_stats:
        return _uae_forward_int8(gen, embs, pose, repeat_num, hidden_num,
                                 quant)
    stats: Dict[str, torch.Tensor] = {}
    dtype = BF16 if quant is not None else F32

    def record(name, x):
        if not collect_stats:
            return
        a = torch.abs(x.to(F32))
        if calib_channel:
            stats[name] = torch.amax(a, dim=(0, 1, 2))
        elif calib_hist_ranges is not None:
            stats[name] = _histogram(a, calib_hist_ranges[name])
        elif calib_percentile is None:
            stats[name] = torch.amax(a)
        else:
            stats[name] = _percentile(a, calib_percentile)

    def conv_apply(name, x, stride=1, act=True):
        record(name, x)
        tree = _gen_layer(gen, name)
        if quant is not None and name in quant["weights"]:
            w8, w_scale = quant["weights"][name]
            s_x = quant["act_scales"][name]
            factor = w_scale if quant.get("act_folded") else s_x * w_scale
            return s8_conv(_quantize(x, s_x), w8, factor, tree.bias.to(F32),
                           stride, relu=act, out_dtype=BF16)
        out = _conv(x.to(dtype), tree.weight.to(dtype), tree.bias.to(dtype),
                    stride)
        return torch.relu(out) if act else out

    record("g_stem", pose)
    x = torch.relu(_constant_input_stem(
        gen.stem_kernel, gen.stem_bias, embs, pose.permute(0, 3, 1, 2),
        dtype).permute(0, 2, 3, 1))

    names = enc_layer_names(repeat_num)
    skips = []
    ni = 0
    for idx in range(repeat_num):
        res = x
        x = conv_apply(f"enc/{names[ni][1]}", x); ni += 1
        x = conv_apply(f"enc/{names[ni][1]}", x); ni += 1
        x = x + res
        skips.append(x)
        if idx < repeat_num - 1:
            x = conv_apply(f"enc/{names[ni][1]}", x, stride=2); ni += 1

    b, h_min, w_min, _ = x.shape
    z = _dense(x.reshape(b, -1), gen.bottleneck, dtype)
    x = _dense(z, gen.unbottleneck, dtype).reshape(b, h_min, w_min,
                                                   hidden_num)

    names = dec_layer_names(repeat_num)
    ni = 0
    for idx in range(repeat_num):
        x = torch.cat([x, skips[repeat_num - 1 - idx].to(x.dtype)], -1)
        res = x
        x = conv_apply(f"dec/{names[ni][1]}", x); ni += 1
        x = conv_apply(f"dec/{names[ni][1]}", x); ni += 1
        x = x + res
        if idx < repeat_num - 1:
            if quant is not None:  # exact reorder: 4x fewer FLOPs
                x = upscale_nn(conv_apply(f"dec/{names[ni][1]}", x), 2)
            else:
                x = conv_apply(f"dec/{names[ni][1]}", upscale_nn(x, 2))
            ni += 1

    out = conv_apply("to_rgb", x, act=False).to(F32)
    if collect_stats:
        return out, z, stats
    return out, z


def _uae_forward_int8(gen, embs: torch.Tensor, pose: torch.Tensor,
                      repeat_num: int, hidden_num: int, quant: Dict):
    """s8-chained UAEGenerator inference (quant.py:256-470): every tensor
    that feeds a conv, a skip or a residual add is stored once as s8 at
    its consumer's scale, each conv's epilogue dequantizes, adds the bias,
    the ReLU and the residual and requantizes; skips are stored at their
    decoder consumer's scale; the upsample runs on s8. Layers missing from
    the weight table are exact-bfloat16 islands: every tensor whose
    consumer is one stays bfloat16."""
    s = quant["act_scales"]
    W = quant["weights"]
    folded = bool(quant.get("act_folded"))
    pinned = bool(quant.get("act_pinned"))

    def for_consumer(x_bf, consumer, scale):
        if consumer not in W:
            return x_bf.to(BF16)
        return _quantize(x_bf, scale)

    def qconv(name, q8, stride=1, relu=True, out_scale=None, res8=None,
              res_scale=None, out_name=None):
        tree = _gen_layer(gen, name)
        out_bf16 = out_scale is None or (out_name is not None
                                         and out_name not in W)
        out_dtype = BF16 if out_bf16 else torch.int8
        if name not in W:  # exact-bfloat16 island
            x_bf = (q8 if q8.is_floating_point()
                    else (q8.to(F32) * s[name]).to(BF16))
            y = _conv(x_bf.to(BF16), tree.weight.to(BF16), None,
                      stride).to(F32) + tree.bias.to(F32)
            return epilogue(y, relu, res8, res_scale,
                            None if out_bf16 else out_scale, out_dtype)
        if q8.is_floating_point():  # island exit
            q8 = _quantize(q8, s[name])
        w8, w_scale = W[name]
        factor = w_scale if folded else s[name] * w_scale
        return s8_conv(q8, w8, factor, tree.bias.to(F32), stride, relu,
                       res8, res_scale, None if out_bf16 else out_scale,
                       out_dtype)

    enc_names = [n for _, n in enc_layer_names(repeat_num)]
    dec_names = [n for _, n in dec_layer_names(repeat_num)]
    dec_a_scale = [s[f"dec/{dec_names[3 * i]}"] for i in range(repeat_num)]

    # stem: the pose conv in s8 (rendered maps are exactly {-1,+1}, so
    # their quantization is lossless) plus the float32 embedding bias map
    if "g_stem" in W:
        _, h, w, _ = pose.shape
        w8, w_scale = W["g_stem"]
        factor = w_scale if folded else s["g_stem"] * w_scale
        zero = torch.zeros(w8.shape[0], dtype=F32, device=pose.device)
        y = s8_conv(_quantize(pose, s["g_stem"]), w8, factor, zero,
                    out_dtype=F32)  # acc * factor + 0 == acc * factor
        x_bf = torch.relu(y + stem_bias_map_nhwc(
            gen.stem_kernel, gen.stem_bias, embs, h, w, F32))
    else:
        x_bf = torch.relu(_constant_input_stem(
            gen.stem_kernel, gen.stem_bias, embs, pose.permute(0, 3, 1, 2),
            BF16).permute(0, 2, 3, 1))
    q = for_consumer(x_bf, f"enc/{enc_names[0]}", s[f"enc/{enc_names[0]}"])

    skips = []
    ni = 0
    r_bf = None
    for idx in range(repeat_num):
        na, nb = enc_names[ni], enc_names[ni + 1]
        s_a = s[f"enc/{na}"]
        q_mid = qconv(f"enc/{na}", q, out_scale=s[f"enc/{nb}"],
                      out_name=f"enc/{nb}")
        ni += 2
        dec_consumer = f"dec/{dec_names[3 * (repeat_num - 1 - idx)]}"
        last = idx == repeat_num - 1
        nd = None if last else f"enc/{enc_names[ni]}"
        if pinned and not last and dec_consumer in W and nd in W:
            # one s8 store shared by the skip and the stride-2 conv
            r8 = qconv(f"enc/{nb}", q_mid, res8=q, res_scale=s_a,
                       out_scale=s[nd], out_name=nd)
            skips.append(r8)
            q = qconv(nd, r8, stride=2,
                      out_scale=s[f"enc/{enc_names[ni + 1]}"],
                      out_name=f"enc/{enc_names[ni + 1]}")
            ni += 1
            continue
        r_bf = qconv(f"enc/{nb}", q_mid, res8=q, res_scale=s_a)
        skips.append(for_consumer(r_bf, dec_consumer, _tail_scale(
            dec_a_scale[repeat_num - 1 - idx], r_bf.shape[-1])))
        if not last:
            q = qconv(nd, for_consumer(r_bf, nd, s[nd]), stride=2,
                      out_scale=s[f"enc/{enc_names[ni + 1]}"],
                      out_name=f"enc/{enc_names[ni + 1]}")
            ni += 1

    b, h_min, w_min, _ = r_bf.shape
    z = _dense(r_bf.reshape(b, -1), gen.bottleneck, BF16)
    x_bf = _dense(z, gen.unbottleneck, BF16).reshape(b, h_min, w_min,
                                                     hidden_num)

    ni = 0
    z8 = r8 = None
    for idx in range(repeat_num):
        na, nb = dec_names[ni], dec_names[ni + 1]
        s_a = dec_a_scale[idx]
        u8 = (for_consumer(x_bf, f"dec/{na}", _head_scale(s_a,
                                                          x_bf.shape[-1]))
              if idx == 0 else z8)
        cat8 = torch.cat([u8, skips[repeat_num - 1 - idx]], -1)
        q_mid = qconv(f"dec/{na}", cat8, out_scale=s[f"dec/{nb}"],
                      out_name=f"dec/{nb}")
        ni += 2
        if idx < repeat_num - 1:
            nu = dec_names[ni]
            r8 = qconv(f"dec/{nb}", q_mid, res8=cat8, res_scale=s_a,
                       out_scale=s[f"dec/{nu}"], out_name=f"dec/{nu}")
            nxt = f"dec/{dec_names[3 * (idx + 1)]}"
            z8_half = qconv(f"dec/{nu}", r8, out_scale=_head_scale(
                dec_a_scale[idx + 1], _gen_layer(gen, f"dec/{nu}").weight
                .shape[0]), out_name=nxt)
            z8 = upscale_nn(z8_half, 2)
            ni += 1
        else:
            r8 = qconv(f"dec/{nb}", q_mid, res8=cat8, res_scale=s_a,
                       out_scale=s["to_rgb"], out_name="to_rgb")

    rgb = gen.to_rgb
    if "to_rgb" in W:
        w8, w_scale = W["to_rgb"]
        factor = w_scale if folded else s["to_rgb"] * w_scale
        out = s8_conv(r8, w8, factor, rgb.bias.to(F32), out_dtype=F32)
    else:
        x_rgb = (r8.to(F32) if r8.is_floating_point()
                 else r8.to(F32) * s["to_rgb"])
        out = _conv(x_rgb, rgb.weight.to(F32), rgb.bias.to(F32))
    return out, z


def uae_forward_bf16(gen, embs: torch.Tensor, pose: torch.Tensor,
                     repeat_num: int, hidden_num: int):
    """The testers' bfloat16 generator (quant.py:473-531): the module's
    math at bfloat16, with each decoder 1x1 conv before its NN upsample
    (an exact commute). pose NHWC -> (out [B,H,W,3] float32, z)."""
    def conv(tree, x, stride=1, act=True):
        out = _conv(x.to(BF16), tree.weight.to(BF16), tree.bias.to(BF16),
                    stride)
        return torch.relu(out) if act else out

    x = torch.relu(_constant_input_stem(
        gen.stem_kernel, gen.stem_bias, embs, pose.permute(0, 3, 1, 2),
        BF16).permute(0, 2, 3, 1))
    enc = gen.ConvBlockTower_0
    names = [n for _, n in enc_layer_names(repeat_num)]
    skips, ni = [], 0
    for idx in range(repeat_num):
        res = x
        x = conv(getattr(enc, names[ni]), x); ni += 1
        x = conv(getattr(enc, names[ni]), x); ni += 1
        x = x + res
        skips.append(x)
        if idx < repeat_num - 1:
            x = conv(getattr(enc, names[ni]), x, stride=2); ni += 1

    b, h_min, w_min, _ = x.shape
    z = _dense(x.reshape(b, -1), gen.bottleneck, BF16)
    x = _dense(z, gen.unbottleneck, BF16).reshape(b, h_min, w_min,
                                                  hidden_num)
    names = [n for _, n in dec_layer_names(repeat_num)]
    ni = 0
    for idx in range(repeat_num):
        x = torch.cat([x, skips[repeat_num - 1 - idx]], -1)
        res = x
        x = conv(getattr(gen, names[ni]), x); ni += 1
        x = conv(getattr(gen, names[ni]), x); ni += 1
        x = x + res
        if idx < repeat_num - 1:
            x = upscale_nn(conv(getattr(gen, names[ni]), x), 2); ni += 1
    return conv(gen.to_rgb, x, act=False).to(F32), z


def _quantize_kernel(kernel: torch.Tensor, act_scale=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric s8 quantization of an OIHW kernel, in
    the JAX package's numpy float32 arithmetic on its HWIO layout
    (quant.py:534-546), with an optional per-input-channel activation
    scale folded in first -> (w8 [Co,kh,kw,Ci] int8, w_scale [Co])."""
    k = kernel.detach().to("cpu", F32).numpy().transpose(2, 3, 1, 0)
    if act_scale is not None:
        k = k * np.asarray(act_scale, np.float32)[None, None, :, None]
    scale = np.abs(k).reshape(-1, k.shape[-1]).max(0) / 127.0
    scale = np.maximum(scale, 1e-12)
    w8 = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
    dev = kernel.device
    return (torch.from_numpy(np.ascontiguousarray(
                w8.transpose(3, 0, 1, 2))).to(dev),
            torch.from_numpy(scale.astype(np.float32)).to(dev))


def quantize_weights(gen, repeat_num: int,
                     fold_act_scales: Optional[Dict] = None,
                     emb_dim: Optional[int] = None) -> Dict:
    """s8 weights for every tower / decoder conv, to_rgb and, with
    `emb_dim`, the stem's pose part ('g_stem') (quant.py:549-570)."""
    fold = fold_act_scales or {}
    weights = {}
    for _, name in enc_layer_names(repeat_num):
        weights[f"enc/{name}"] = _quantize_kernel(
            getattr(gen.ConvBlockTower_0, name).weight, fold.get(
                f"enc/{name}"))
    for _, name in dec_layer_names(repeat_num):
        weights[f"dec/{name}"] = _quantize_kernel(
            getattr(gen, name).weight, fold.get(f"dec/{name}"))
    weights["to_rgb"] = _quantize_kernel(gen.to_rgb.weight,
                                         fold.get("to_rgb"))
    if emb_dim is not None:
        weights["g_stem"] = _quantize_kernel(gen.stem_kernel[:, emb_dim:],
                                             fold.get("g_stem"))
    return weights


def _kl_threshold_scale(hist: np.ndarray, amax: float,
                        num_quant: int = 128) -> float:
    """Entropy (KL-divergence) calibration à la TensorRT: pick the |x|
    clip threshold whose `num_quant`-level quantized distribution is
    closest (min KL) to the observed one, and return threshold/127 as
    the activation scale. A copy of quant.py:576-610."""
    hist = np.asarray(hist, np.float64)
    if hist.sum() == 0 or amax <= 0:
        return max(amax, 1e-12) / 127.0
    bin_w = amax / len(hist)
    best_kl, best_i = np.inf, len(hist)
    for i in range(num_quant, len(hist) + 1):
        p = hist[:i].copy()
        p[i - 1] += hist[i:].sum()       # outliers clip into the edge bin
        q = np.zeros(i)
        chunk = i / num_quant
        for j in range(num_quant):
            lo = int(np.floor(j * chunk))
            hi = min(int(np.ceil((j + 1) * chunk)), i)
            seg = hist[lo:hi]
            nz = seg > 0
            if nz.any():
                q[lo:hi][nz] = seg.sum() / nz.sum()
        psum, qsum = p.sum(), q.sum()
        if psum == 0 or qsum == 0:
            continue
        p /= psum
        q /= qsum
        m = p > 0
        kl = float(np.sum(p[m] * np.log(p[m] / np.maximum(q[m], 1e-12))))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return max((best_i + 0.5) * bin_w, 1e-12) / 127.0


def _max_stats(fwd, batches) -> Dict[str, np.ndarray]:
    maxima: Dict[str, np.ndarray] = {}
    with torch.no_grad():
        for args in batches:
            for k, v in fwd(*args)[-1].items():
                maxima[k] = np.maximum(maxima.get(k, 0.0),
                                       v.cpu().numpy())
    return maxima


def calibrate(gen, embs_batches, pose_batches, repeat_num: int,
              hidden_num: int, calib_percentile: Optional[float] = None,
              calib_method: str = "absmax",
              calib_granularity: str = "tensor") -> Dict[str, np.ndarray]:
    """Activation scales over calibration batches by the float32 forward
    (quant.py:613-692): {layer: python float} per tensor, {layer: float32
    [C]} per channel, each downsample conv's input scale pinned to its
    skip's decoder tail scale."""
    if calib_percentile is not None and calib_method == "absmax":
        calib_method = "percentile"
    if calib_method not in ("absmax", "percentile", "entropy"):
        raise ValueError(f"unknown calib_method {calib_method!r}")
    if calib_method == "percentile" and calib_percentile is None:
        raise ValueError("calib_method='percentile' needs calib_percentile")
    if calib_method == "entropy" and calib_percentile is not None:
        raise ValueError("calib_method='entropy' is mutually exclusive "
                         "with calib_percentile")
    if calib_granularity not in ("tensor", "channel"):
        raise ValueError(f"unknown calib_granularity {calib_granularity!r}")
    per_channel = calib_granularity == "channel"
    if per_channel and calib_method != "absmax":
        raise ValueError("granularity='channel' supports absmax only "
                         "(no percentile/entropy)")

    def fwd(embs, pose, **kw):
        return uae_forward(gen, embs, pose, repeat_num, hidden_num,
                           collect_stats=True, **kw)

    batches = list(zip(embs_batches, pose_batches))
    maxima = _max_stats(lambda e, p: fwd(e, p, calib_percentile=(
        calib_percentile), calib_channel=per_channel), batches)
    if per_channel:
        scales = {k: (np.maximum(v, 1e-12) / 127.0).astype(np.float32)
                  for k, v in maxima.items()}
        enc_n = [n for _, n in enc_layer_names(repeat_num)]
        dec_n = [n for _, n in dec_layer_names(repeat_num)]
        ni = 2
        for idx in range(repeat_num - 1):
            nd = f"enc/{enc_n[ni]}"
            ni += 3
            dec_c = f"dec/{dec_n[3 * (repeat_num - 1 - idx)]}"
            if nd in scales and dec_c in scales:
                c = scales[nd].shape[-1]
                scales[nd] = scales[dec_c][..., -c:]
        return scales
    scales = {k: float(np.maximum(v, 1e-12)) / 127.0
              for k, v in maxima.items()}
    if calib_method == "entropy":
        ranges = {k: float(np.maximum(v, 1e-12)) for k, v in maxima.items()}
        hists: Dict[str, np.ndarray] = {}
        with torch.no_grad():
            for embs, pose in batches:
                _, _, stats = fwd(embs, pose, calib_hist_ranges=ranges)
                for k, v in stats.items():
                    hists[k] = hists.get(k, 0) + v.cpu().numpy()
        scales = {k: _kl_threshold_scale(h, ranges[k])
                  for k, h in hists.items()}
    return scales


def _scales_to(act_scales: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in act_scales.items()}


class QuantizedGenerator:
    """Calibrated int8 UAE generator for inference (quant.py:695-803).

    bf16_layers: layer names run as exact bfloat16 convs (left out of the
    weight table). fallback_mode='island' (the default) keeps the chained
    s8 graph with bfloat16 islands; 'legacy' routes a non-empty fallback
    set through the per-layer-quant graph. calib_granularity='channel'
    folds per-input-channel scales into the weights."""

    def __init__(self, gen, repeat_num: int, hidden_num: int,
                 calib_percentile: Optional[float] = None,
                 bf16_layers: frozenset = frozenset(),
                 calib_method: str = "absmax",
                 calib_granularity: str = "tensor",
                 fallback_mode: str = "island"):
        if fallback_mode not in ("legacy", "island"):
            raise ValueError(f"unknown fallback_mode {fallback_mode!r}")
        self.gen = gen
        self.repeat_num = repeat_num
        self.hidden_num = hidden_num
        self.calib_percentile = calib_percentile
        self.calib_method = calib_method
        self.calib_granularity = calib_granularity
        self.bf16_layers = frozenset(bf16_layers)
        self.fallback_mode = fallback_mode
        self.quant: Optional[Dict] = None

    def calibrate(self, embs_batches, pose_batches) -> "QuantizedGenerator":
        per_channel = self.calib_granularity == "channel"
        act_scales = calibrate(
            self.gen, embs_batches, pose_batches, self.repeat_num,
            self.hidden_num, calib_percentile=self.calib_percentile,
            calib_method=self.calib_method,
            calib_granularity=self.calib_granularity)
        weights = quantize_weights(
            self.gen, self.repeat_num,
            fold_act_scales=act_scales if per_channel else None,
            emb_dim=int(embs_batches[0].shape[-1]))
        unknown = self.bf16_layers - set(weights)
        if unknown:
            raise ValueError(f"unknown bf16_layers {sorted(unknown)}; "
                             f"valid names: {sorted(weights)}")
        for name in self.bf16_layers:
            weights.pop(name)
        self.quant = {"weights": weights,
                      "act_scales": _scales_to(act_scales,
                                               self.gen.stem_kernel.device),
                      "act_folded": per_channel, "act_pinned": per_channel}
        return self

    def __call__(self, embs, pose):
        assert self.quant is not None, "calibrate() first"
        chained = not self.bf16_layers or self.fallback_mode == "island"
        return uae_forward(self.gen, embs, pose, self.repeat_num,
                           self.hidden_num, quant=self.quant,
                           chained=chained)


# --------------------------------------------------------------- encoder
def _enc_layer(enc, name: str):
    """The conv module of an encoder layer name."""
    group, conv = name.split("/")
    if group == "stem":
        return getattr(enc._Stem_0, conv)
    if group == "fg":
        return getattr(enc.fg_tower.ConvBlockTower_0, conv)
    return getattr(enc.bg_tower, conv)


def _tower(conv_apply, x, repeat_num, prefix):
    """ConvBlockTower mirror (no skips) on layer names (quant.py:805-820)."""
    ni = 0
    names = enc_layer_names(repeat_num)
    for idx in range(repeat_num):
        res = x
        x = conv_apply(f"{prefix}/{names[ni][1]}", x); ni += 1
        x = conv_apply(f"{prefix}/{names[ni][1]}", x); ni += 1
        x = x + res
        if idx < repeat_num - 1:
            x = conv_apply(f"{prefix}/{names[ni][1]}", x, stride=2); ni += 1
    return x


def roi_fgbg_forward(enc, x, fg_mask, part_bbox, part_vis, repeat_num: int,
                     hidden_num: int, part_num: int = 7, roi_size: int = 48,
                     quant: Optional[Dict] = None,
                     collect_stats: bool = False,
                     calib_channel: bool = False):
    """Layer-by-layer RoiEncoderFgBg forward (quant.py:823-893), NHWC:
    float32, or with `quant` the stem's two wide convs and both towers in
    s8 with bfloat16 between layers; the crops interpolate in float32.
    -> embeddings [B, P*z + 4*z] float32 (+ stats)."""
    stats: Dict[str, torch.Tensor] = {}
    dtype = BF16 if quant is not None else F32

    def conv_apply(name, v, stride=1, act=True):
        if collect_stats:
            a = torch.abs(v.to(F32))
            stats[name] = (torch.amax(a, dim=(0, 1, 2)) if calib_channel
                           else torch.amax(a))
        tree = _enc_layer(enc, name)
        if quant is not None and name in quant["weights"]:
            w8, w_scale = quant["weights"][name]
            s_x = quant["act_scales"][name]
            factor = w_scale if quant.get("act_folded") else s_x * w_scale
            return s8_conv(_quantize(v, s_x), w8, factor, tree.bias.to(F32),
                           stride, relu=act, out_dtype=BF16)
        out = _conv(v.to(dtype), tree.weight.to(dtype), tree.bias.to(dtype),
                    stride)
        return torch.relu(out) if act else out

    x = conv_apply("stem/Conv_0", x.to(dtype))
    res = x
    x = conv_apply("stem/Conv_1", x)
    x = conv_apply("stem/Conv_2", x)
    x = x + res

    m = fg_mask.to(x.dtype)
    x_fg = x * m
    x_bg = x * (1.0 - m)

    rois = crop_body_rois(x_fg, part_bbox, roi_size).to(dtype)
    fg = _tower(conv_apply, rois, repeat_num, "fg")
    fg = _dense(fg.reshape(fg.shape[0], -1), enc.fg_tower.Dense_0, dtype)
    pb, z = fg.shape
    b = pb // part_num
    fea = fg.reshape(part_num, b, z)
    if part_vis is not None:
        fea = fea * part_vis.to(fea.dtype).t()[:, :, None]
    fg = fea.transpose(0, 1).reshape(b, part_num * z)

    bg = _tower(conv_apply, x_bg, repeat_num, "bg")
    bg = _dense(bg.reshape(bg.shape[0], -1), enc.bg_fc, dtype)
    out = torch.cat([fg, bg], -1).to(F32)
    if collect_stats:
        return out, stats
    return out


def quantize_encoder_weights(enc, repeat_num: int,
                             fold_act_scales: Optional[Dict] = None) -> Dict:
    """s8 weights for the FG/BG encoder's stem/Conv_1..2 and both towers
    (quant.py:896-914; stem/Conv_0, 3 -> hidden, stays float)."""
    fold = fold_act_scales or {}
    weights = {}
    for i in range(1, 3):
        name = f"stem/Conv_{i}"
        weights[name] = _quantize_kernel(_enc_layer(enc, name).weight,
                                         fold.get(name))
    for _, conv in enc_layer_names(repeat_num):
        for group in ("fg", "bg"):
            name = f"{group}/{conv}"
            weights[name] = _quantize_kernel(_enc_layer(enc, name).weight,
                                             fold.get(name))
    return weights


class QuantizedEncoder:
    """Calibrated int8 RoiEncoderFgBg for inference (quant.py:917-981).
    bf16_layers: encoder conv names kept as exact bfloat16 convs."""

    def __init__(self, enc, repeat_num: int, hidden_num: int,
                 roi_size: int = 48, part_num: int = 7,
                 bf16_layers: frozenset = frozenset(),
                 calib_granularity: str = "tensor"):
        if calib_granularity not in ("tensor", "channel"):
            raise ValueError(
                f"unknown calib_granularity {calib_granularity!r}")
        self.enc = enc
        self.repeat_num = repeat_num
        self.hidden_num = hidden_num
        self.roi_size = roi_size
        self.part_num = part_num
        self.bf16_layers = frozenset(bf16_layers)
        self.calib_granularity = calib_granularity
        self.quant: Optional[Dict] = None

    def calibrate(self, batches) -> "QuantizedEncoder":
        """batches: iterable of (x, fg_mask, part_bbox, part_vis)."""
        per_channel = self.calib_granularity == "channel"

        def fwd(x, mask, bbox, vis):
            return roi_fgbg_forward(
                self.enc, x, mask, bbox, vis, self.repeat_num,
                self.hidden_num, roi_size=self.roi_size,
                part_num=self.part_num, collect_stats=True,
                calib_channel=per_channel)

        maxima = _max_stats(fwd, batches)
        act_scales = {k: (np.maximum(v, 1e-12) / 127.0).astype(np.float32)
                      for k, v in maxima.items()}
        weights = quantize_encoder_weights(
            self.enc, self.repeat_num,
            fold_act_scales=act_scales if per_channel else None)
        unknown = self.bf16_layers - set(weights)
        if unknown:
            raise ValueError(f"unknown bf16_layers {sorted(unknown)}; "
                             f"valid names: {sorted(weights)}")
        for name in self.bf16_layers:
            weights.pop(name)
        self.quant = {"weights": weights,
                      "act_scales": _scales_to(
                          act_scales, self.enc.bg_fc.weight.device),
                      "act_folded": per_channel}
        return self

    def __call__(self, x, fg_mask, part_bbox, part_vis):
        assert self.quant is not None, "calibrate() first"
        return roi_fgbg_forward(self.enc, x, fg_mask, part_bbox, part_vis,
                                self.repeat_num, self.hidden_num,
                                roi_size=self.roi_size,
                                part_num=self.part_num, quant=self.quant)
