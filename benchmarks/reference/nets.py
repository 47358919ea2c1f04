"""Plain PyTorch reference of the Stage-I nets of Disentangled Person Image
Generation (Ma et al., CVPR 2018): the FG/BG two-branch ROI encoder of the
Market family, the single-branch ROI encoder of the DeepFashion family, the
U-net generator with its FC bottleneck, and the DCGAN discriminator.

Written from the published description and the configuration files, with
no kernels, no caches and nothing of the measured program: plain `torch`
ops on a dict of weights per net. The weights are named as
flax names them (`Conv_0.weight`, `Dense_0.bias`, ...), so that the same
dict loads into the program under test. Images are NHWC, as the data is;
the convs run NCHW. Departures from the most literal form, each exact:

  * the generator's stem sees concat(tile(embedding), pose). A SAME 3x3
    conv of a spatially constant map takes one of 9 values, by whether a
    pixel lies on the first, an inner or the last row and column; the
    reference computes those 9 by the same conv on a 3x3 tile and spreads
    them, instead of convolving the H x W tile;
  * the discriminator's convs run on PyTorch's own conv kernels forward
    and backward, not cuDNN's (`_plain_conv`).

The nets compute in the dtype of the weights and inputs they are given;
the TF32 flags are the caller's (`stage1.precision`).

`param_specs(cfg)` lists every weight with its shape and initializer;
the forwards read exactly those names.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Spec = Tuple[str, Tuple[int, ...], str]   # (name, shape, init)

XAVIER, NORMAL, ZEROS, ONES = "xavier", "normal_0.02", "zeros", "ones"
LEAKY = 0.3            # the reference LeakyReLU slope
BN_EPS = 1e-5


# ---------------------------------------------------------------- layers
def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA / TF 'SAME' padding (low, high) along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    ph = same_pads(x.shape[2], k, stride)
    pw = same_pads(x.shape[3], k, stride)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]))


def conv(p: Params, name: str, x: torch.Tensor, stride: int = 1,
         bias: bool = True) -> torch.Tensor:
    """NCHW conv with SAME padding, weight OIHW."""
    w = p[f"{name}.weight"]
    b = p[f"{name}.bias"] if bias else None
    return F.conv2d(_pad_same(x, w.shape[2], stride), w, b, stride)


class _PlainConv(torch.autograd.Function):
    """F.conv2d (no padding) with cuDNN off in the forward and in the
    backward, whose kernels are chosen when it runs."""

    @staticmethod
    def forward(ctx, x, w, b, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with torch.backends.cudnn.flags(enabled=False):
            return F.conv2d(x, w, b, stride)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.backends.cudnn.flags(enabled=False):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, w, [w.shape[0]], [ctx.stride] * 2, [0, 0], [1, 1],
                False, [0, 0], 1, [need[0], need[1], need[2]])
        return gx, gw, gb, None


def _plain_conv(p: Params, name: str, x: torch.Tensor,
                stride: int) -> torch.Tensor:
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    x = _pad_same(x, w.shape[2], stride)
    if x.device.type != "cuda":
        return F.conv2d(x, w, b, stride)
    return _PlainConv.apply(x, w, b, stride)


def dense(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """x @ W^T + b, W stored [out, in]."""
    return x @ p[f"{name}.weight"].t() + p[f"{name}.bias"]


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, H*W*C] in NHWC order, the order of the Dense weights."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def batch_norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Normalized by the batch's own mean and biased variance."""
    mean = x.mean((0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean((0, 2, 3), keepdim=True)
    y = (x - mean) / torch.sqrt(var + BN_EPS)
    return (y * p[f"{name}.weight"][:, None, None]
            + p[f"{name}.bias"][:, None, None])


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, LEAKY * x)


def upscale2(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsampling of NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def halved(size: int, times: int) -> int:
    for _ in range(times):
        size = -(-size // 2)
    return size


# ------------------------------------------------------------ specs
def _conv_spec(name, cin, cout, k, init=XAVIER, bias=True) -> List[Spec]:
    out = [(f"{name}.weight", (cout, cin, k, k), init)]
    return out + ([(f"{name}.bias", (cout,), ZEROS)] if bias else [])


def _dense_spec(name, fin, fout, init=XAVIER) -> List[Spec]:
    return [(f"{name}.weight", (fout, fin), init),
            (f"{name}.bias", (fout,), ZEROS)]


def _tower_spec(prefix: str, repeat: int, hidden: int) -> List[Spec]:
    """Stage i: two 3x3 convs at hidden*(i+1) with a residual add, then a
    stride-2 3x3 conv to hidden*(i+2) between stages."""
    out, i = [], 0
    for idx in range(repeat):
        ch = hidden * (idx + 1)
        out += _conv_spec(f"{prefix}Conv_{i}", ch, ch, 3)
        out += _conv_spec(f"{prefix}Conv_{i + 1}", ch, ch, 3)
        i += 2
        if idx < repeat - 1:
            out += _conv_spec(f"{prefix}Conv_{i}", ch, hidden * (idx + 2), 3)
            i += 1
    return out


def encoder_spec(e: Dict, hidden: int, img_h: int, img_w: int) -> List[Spec]:
    parts, z, rep, roi = e["parts"], e["z"], e["repeat"], e["roi"]
    stem = (_conv_spec("_Stem_0.Conv_0", 3, hidden, 3)
            + _conv_spec("_Stem_0.Conv_1", hidden, hidden, 3)
            + _conv_spec("_Stem_0.Conv_2", hidden, hidden, 3))
    roi_flat = halved(roi, rep - 1) ** 2 * hidden * rep
    if e["kind"] == "single":
        return (stem + _tower_spec("_RoiTower_0.ConvBlockTower_0.", rep, hidden)
                + _dense_spec("_RoiTower_0.Dense_0", roi_flat, z))
    img_flat = halved(img_h, rep - 1) * halved(img_w, rep - 1) * hidden * rep
    return (stem + _tower_spec("fg_tower.ConvBlockTower_0.", rep, hidden)
            + _dense_spec("fg_tower.Dense_0", roi_flat, z)
            + _tower_spec("bg_tower.", rep, hidden)
            + _dense_spec("bg_fc", img_flat, 4 * z))


def embedding_dim(e: Dict) -> int:
    return e["parts"] * e["z"] + (4 * e["z"] if e["kind"] == "fg_bg" else 0)


def generator_spec(g: Dict, emb_dim: int, pose_ch: int, hidden: int,
                   img_h: int, img_w: int) -> List[Spec]:
    rep, zdim = g["repeat"], g["z"]
    hm, wm = halved(img_h, rep - 1), halved(img_w, rep - 1)
    out = [("stem_kernel", (hidden, emb_dim + pose_ch, 3, 3), XAVIER),
           ("stem_bias", (hidden,), ZEROS)]
    out += _tower_spec("ConvBlockTower_0.", rep, hidden)
    out += _dense_spec("bottleneck", hm * wm * hidden * rep, zdim)
    out += _dense_spec("unbottleneck", zdim, hm * wm * hidden)
    i, x_ch = 0, hidden
    for idx in range(rep):
        ch = x_ch + hidden * (rep - idx)
        out += _conv_spec(f"Conv_{i}", ch, ch, 3)
        out += _conv_spec(f"Conv_{i + 1}", ch, ch, 3)
        i += 2
        if idx < rep - 1:
            x_ch = hidden * (rep - idx - 1)
            out += _conv_spec(f"Conv_{i}", ch, x_ch, 1)
            i += 1
    return out + _conv_spec("to_rgb", ch, 3, 3)


def _d_channels(d: Dict) -> List[int]:
    ch, out = d["dim"], []
    for _ in range(d["stages"]):
        out.append(ch)
        ch = min(ch * 2, d["dim"] * 8)
    return out


def discriminator_spec(d: Dict, img_h: int, img_w: int) -> List[Spec]:
    out, cin = [], 3
    chans = _d_channels(d)
    for s, ch in enumerate(chans):
        out += _conv_spec(f"Conv_{s}", cin, ch, 5, init=NORMAL)
        if s > 0:
            bn = f"BatchNorm_{s - 1}"
            out += [(f"{bn}.weight", (ch,), ONES), (f"{bn}.bias", (ch,), ZEROS)]
        cin = ch
    flat = halved(img_h, d["stages"]) * halved(img_w, d["stages"]) * chans[-1]
    return out + _dense_spec("logit", flat, 1, init=NORMAL)


def discriminator_buffers(d: Dict) -> List[Spec]:
    """The BatchNorms' running statistics: the program keeps them beside
    the weights; no Stage-I output reads them."""
    out = []
    for s, ch in enumerate(_d_channels(d)[1:]):
        out += [(f"BatchNorm_{s}.running_mean", (ch,), ZEROS),
                (f"BatchNorm_{s}.running_var", (ch,), ONES)]
    return out


def param_specs(cfg: Dict) -> Dict[str, List[Spec]]:
    """Every weight of the three nets of a configuration file's `nets`, by
    net: 'Encoder', 'ID_AE' (the generator) and 'Discriminator'."""
    n = cfg["nets"]
    h, w, hid = n["img_H"], n["img_W"], n["hidden"]
    enc = n["encoder"]
    return {"Encoder": encoder_spec(enc, hid, h, w),
            "ID_AE": generator_spec(n["generator"], embedding_dim(enc),
                                    n["keypoints"], hid, h, w),
            "Discriminator": discriminator_spec(n["discriminator"], h, w)}


# ------------------------------------------------------------- forwards
def tower(p: Params, prefix: str, x: torch.Tensor, repeat: int,
          skips: List[torch.Tensor] = None) -> torch.Tensor:
    i = 0
    for idx in range(repeat):
        res = x
        x = F.relu(conv(p, f"{prefix}Conv_{i}", x))
        x = F.relu(conv(p, f"{prefix}Conv_{i + 1}", x)) + res
        i += 2
        if skips is not None:
            skips.append(x)
        if idx < repeat - 1:
            x = F.relu(conv(p, f"{prefix}Conv_{i}", x, stride=2))
            i += 1
    return x


def crop_rois(feat: torch.Tensor, part_bbox: torch.Tensor,
              roi: int) -> torch.Tensor:
    """TF `crop_and_resize` of each part box: feat NCHW [B, C, H, W],
    part_bbox [B, P, 4] integer pixels (y1, x1, y2, x2), normalized by H
    and W as the published encoder does -> [P*B, C, roi, roi], part-major.
    Sample i of a box lies at y1n*(H-1) + i*(y2n-y1n)*(H-1)/(roi-1); it is
    the bilinear blend of its four neighbours, a neighbour outside the
    image reads 0, and a sample whose coordinate is outside [0, H-1] (or
    [0, W-1]) is 0."""
    b, _, h, w = feat.shape
    p = part_bbox.shape[1]
    dt = feat.dtype
    box = part_bbox.to(dt).transpose(0, 1).reshape(p * b, 4)
    box = box / torch.tensor([h, w, h, w], dtype=dt, device=feat.device)
    img = torch.arange(b, device=feat.device).repeat(p)
    i = torch.arange(roi, dtype=dt, device=feat.device)
    ys = box[:, :1] * (h - 1) + i * ((box[:, 2:3] - box[:, :1]) * (h - 1)
                                      / (roi - 1))
    xs = box[:, 1:2] * (w - 1) + i * ((box[:, 3:4] - box[:, 1:2]) * (w - 1)
                                       / (roi - 1))
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    y0, x0 = y0.long(), x0.long()
    nhwc = feat.permute(0, 2, 3, 1)

    def at(yi, xi):  # [N, roi, roi, C], zero outside the image
        ok = (((yi >= 0) & (yi < h))[:, :, None]
              & ((xi >= 0) & (xi < w))[:, None, :])
        v = nhwc[img[:, None, None], yi.clamp(0, h - 1)[:, :, None],
                 xi.clamp(0, w - 1)[:, None, :]]
        return v * ok[..., None].to(v.dtype)

    out = ((1 - wy) * (1 - wx) * at(y0, x0) + (1 - wy) * wx * at(y0, x0 + 1)
           + wy * (1 - wx) * at(y0 + 1, x0) + wy * wx * at(y0 + 1, x0 + 1))
    inside = (((ys >= 0) & (ys <= h - 1))[:, :, None]
              & ((xs >= 0) & (xs <= w - 1))[:, None, :])
    out = out * inside[..., None].to(out.dtype)
    return out.permute(0, 3, 1, 2)


def encode(p: Params, e: Dict, x: torch.Tensor, fg_mask: torch.Tensor,
           part_bbox: torch.Tensor, part_vis: torch.Tensor) -> torch.Tensor:
    """x [B,H,W,3], fg_mask [B,H,W,1], part_bbox [B,P,4] (the first
    `parts` boxes are used), part_vis [B,P] -> the appearance code
    [B, parts*z (+ 4z for the FG/BG encoder)]."""
    parts, rep = e["parts"], e["repeat"]
    bbox, vis = part_bbox[:, :parts], part_vis[:, :parts].to(x.dtype)
    h = F.relu(conv(p, "_Stem_0.Conv_0", x.permute(0, 3, 1, 2)))
    res = h
    h = F.relu(conv(p, "_Stem_0.Conv_1", h))
    h = F.relu(conv(p, "_Stem_0.Conv_2", h)) + res
    fg_bg = e["kind"] == "fg_bg"
    m = fg_mask.permute(0, 3, 1, 2) if fg_bg else None
    name = "fg_tower" if fg_bg else "_RoiTower_0"
    rois = crop_rois(h * m if fg_bg else h, bbox, e["roi"])
    fea = dense(p, f"{name}.Dense_0", flatten_nhwc(
        tower(p, f"{name}.ConvBlockTower_0.", rois, rep)))
    b = x.shape[0]
    fea = fea.reshape(parts, b, -1) * vis.t()[:, :, None]
    fg = fea.transpose(0, 1).reshape(b, -1)
    if not fg_bg:
        return fg
    bg = dense(p, "bg_fc", flatten_nhwc(tower(p, "bg_tower.", h * (1 - m),
                                              rep)))
    return torch.cat([fg, bg], -1)


def _border_class(n: int, device) -> torch.Tensor:
    """0 for the first position, 2 for the last, 1 inside."""
    c = torch.ones(n, dtype=torch.long, device=device)
    c[0], c[-1] = 0, 2
    return c


def generate(p: Params, g: Dict, hidden: int, embs: torch.Tensor,
             pose: torch.Tensor) -> torch.Tensor:
    """embs [B, D], pose maps [B,H,W,K] -> image [B,H,W,3] (raw, about
    [-1, 1]). The stem sees concat(tile(embs, H, W), pose)."""
    rep = g["repeat"]
    b, hgt, wid, _ = pose.shape
    d = embs.shape[1]
    k = p["stem_kernel"]
    tile3 = embs[:, :, None, None].expand(b, d, 3, 3)
    emb9 = F.conv2d(F.pad(tile3, (1, 1, 1, 1)), k[:, :d])       # [B,hid,3,3]
    emb_map = emb9[:, :, _border_class(hgt, pose.device)][
        :, :, :, _border_class(wid, pose.device)]
    x = F.conv2d(F.pad(pose.permute(0, 3, 1, 2), (1, 1, 1, 1)), k[:, d:])
    x = F.relu(x + emb_map + p["stem_bias"][:, None, None])
    skips: List[torch.Tensor] = []
    x = tower(p, "ConvBlockTower_0.", x, rep, skips)
    z = dense(p, "bottleneck", flatten_nhwc(x))
    hm, wm = halved(hgt, rep - 1), halved(wid, rep - 1)
    x = dense(p, "unbottleneck", z).reshape(b, hm, wm, hidden)
    x = x.permute(0, 3, 1, 2)
    i = 0
    for idx in range(rep):
        x = torch.cat([x, skips[rep - 1 - idx]], 1)
        res = x
        x = F.relu(conv(p, f"Conv_{i}", x))
        x = F.relu(conv(p, f"Conv_{i + 1}", x)) + res
        i += 2
        if idx < rep - 1:
            x = F.relu(conv(p, f"Conv_{i}", upscale2(x)))
            i += 1
    return conv(p, "to_rgb", x).permute(0, 2, 3, 1)


def discriminate(p: Params, d: Dict, img: torch.Tensor) -> torch.Tensor:
    """img [B,H,W,3] -> logits [B], BatchNorm by the batch's statistics."""
    x = img.permute(0, 3, 1, 2)
    for s in range(d["stages"]):
        x = _plain_conv(p, f"Conv_{s}", x, 2)
        if s > 0:
            x = batch_norm(p, f"BatchNorm_{s - 1}", x)
        x = leaky(x)
    return dense(p, "logit", flatten_nhwc(x)).reshape(-1)


def xavier_bound(shape: Tuple[int, ...]) -> float:
    """Glorot-uniform bound, fans counted with the receptive field."""
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return math.sqrt(6.0 / ((shape[0] + shape[1]) * receptive))
