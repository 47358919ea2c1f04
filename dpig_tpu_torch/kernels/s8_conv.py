"""The s8 conv of the int8 serving path (`csrc/s8_conv_sm90.cu` and
`csrc/s8_conv.cu`) and its plain version.

What it replaces: XLA code, not a Pallas kernel. The JAX package's int8
graph (`dpig_tpu/models/quant.py`) runs every quantized conv as
`jax.lax.conv_general_dilated(..., preferred_element_type=int32)`
(`_qconv` / `_qconv_raw`, :63-104) and fuses the epilogue around it: the
requantizing `qconv` of `_uae_forward_int8` (:297-339), the int8 stem
(:350-359) and `to_rgb` (:456-461), and `_qconv` through
`roi_fgbg_forward`'s `conv_apply` (:848-858). PyTorch has no CUDA op for
an s8 x s8 conv with an int32 sum and this epilogue, so the port's is
written by hand.

One call computes, for NHWC s8 input `x8` [B,H,W,Ci] and s8 weights `w8`
[Co,kh,kw,Ci] (kh = kw = 1 or 3, stride 1 or 2, XLA's SAME padding with
its asymmetric stride-2 pads):

    acc = sum over taps and Ci of x8 * w8            (int32, exact)
    y   = acc * factor[co] + bias[co]                (float32)
    y   = max(y, 0)                                  (if relu)
    y   = y + res[...,co] * res_scale[co]            (an s8 residual)
       or y + res[...,co]                            (a bfloat16 one)
    out = clip(rint(y / out_scale[co]), -127, 127)   (s8)
       or bfloat16(y) (round to nearest even), or y  (float32)

each float operation rounded on its own, in that order, as XLA does it in
JAX's graph (`factor` is `w_scale` or `s_x * w_scale`, the caller's
choice; a scalar scale stands for every channel).

`s8_conv_plain` is the plain version: an exact float64 conv of the s8
values (at the Market shape the sums stay below 2^28, far from float64's
2^53) and the epilogue in float32 PyTorch ops, one op per rounding. On the
CPU `s8_conv` calls it; on the card it launches a kernel, which must
equal it bit for bit. `epilogue` is the float part alone; the int8 graph's
bfloat16 fallback islands share it.

Four kernels, four routes, chosen by `plan` from the shapes alone:

- "wgmma" (`csrc/s8_conv_sm90.cu`): Ci % 64 == 0 and Co >= 8, every conv
  of the Market generator and encoder but two. wgmma on 128 x 128 or
  128 x 256 tiles fed by a TMA / cp.async ring; split-K (`split` > 1)
  where the tile grid leaves SMs idle, its int32 partials stored in a
  workspace the wrapper allocates and summed by a second launch.
- "narrow_ci" (`csrc/s8_conv_narrow_ci.cu`): stride 1, Ci <= 32 and
  8 <= Co <= 256, the 18-channel pose stem. A persistent grid over output
  tiles of `th` x `tw` pixels with all Co; the input staged once per tile
  with its halo, 32 bytes a pixel; the output staged and written in full
  lines.
- "narrow_co" (`csrc/s8_conv_narrow_co.cu`): stride 1, Co < 8,
  Ci % 16 == 0 and Ci <= 256, the 3-channel `to_rgb`. A block walks down
  a strip of `th` output rows x `tw` columns with a ring of input rows in
  shared memory; N stays at 8.
- "mma_sync" (`csrc/s8_conv.cu`): everything else (stride 2 with a narrow
  Ci or Co, 48 channels, Ci % 16 != 0 with Co < 8), and the yardstick:
  `route="mma_sync"` runs it on any shape.

`launches` counts all kernels' launches in this process,
`launches_by_route` each one's.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import same_pads

ROUTES = ("wgmma", "narrow_ci", "narrow_co", "mma_sync")
launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)

_OUT_KINDS = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_RES_KINDS = {None: 0, torch.int8: 1, torch.bfloat16: 2}

# The wgmma route's tiling (csrc/s8_conv_sm90.cu): 128 output pixels per
# tile (or 256, see `plan`), stages of 128 K-bytes, and the SM count of an
# H100 SXM, which the split-K factor fills. Constants, so the route and the split depend on
# the shapes alone, not on the card.
WGMMA_BM, WGMMA_BK, SM_COUNT = 128, 128, 132
MIN_SPLIT_STAGES = 3  # each split-K range keeps at least 3 stages
# The narrow routes' limits (narrow_ci holds a tap's channels in one k32
# step, narrow_co one k32 chunk of every tap per warp of 8) and the blocks
# of theirs the card holds at once (2 per SM).
NARROW_CI_MAX_CI, NARROW_CO_MAX_CI = 32, 256
NARROW_SLOTS = 2 * SM_COUNT


@dataclass(frozen=True)
class Plan:
    """How one call runs: `route` (one of ROUTES), the block tile `bm` x
    `bn`, `stages` K stages of `bk` bytes and the split-K factor `split`
    (wgmma only; 1 = no split). The narrow routes' output tile is `th`
    rows x `tw` columns (narrow_ci: bm = th * tw pixels with all Co;
    narrow_co: a block's strip, bm = tw pixels a row, N 8)."""
    route: str
    bm: int
    bn: int
    bk: int
    stages: int
    split: int
    th: int = 0
    tw: int = 0


def _narrow_tw(wo: int) -> int:
    """The narrow routes' tile width: Wo rounded up to 16, at most 64."""
    return min(64, -(-wo // 16) * 16)


def _narrow_co_rows(b: int, ho: int, wo: int, k: int) -> int:
    """The narrow_co strip height: the fewest waves of NARROW_SLOTS blocks
    times the input rows each block loads (th + k - 1), the taller strip on
    a tie."""
    strips = b * -(-wo // _narrow_tw(wo))
    best = (None, 1)
    for th in range(1, ho + 1):
        cost = -(-strips * -(-ho // th) // NARROW_SLOTS) * (th + k - 1)
        if best[0] is None or cost <= best[0]:
            best = (cost, th)
    return best[1]


def plan(x_shape, w_shape, stride: int) -> Plan:
    """The route and tiling of an s8 conv of NHWC input `x_shape` with
    [Co, k, k, Ci] weights `w_shape`.

    - wgmma where Ci % 64 == 0 and Co >= 8, with the N tile (128 or 256)
      that pads Co least (256 on a tie); a 128-wide N tile gets 256-row M
      tiles where those still fill the SMs, else 128 rows and, where the
      tile grid is below the SM count, split-K over as many K ranges as
      fill the SMs, each at least MIN_SPLIT_STAGES stages long.
    - narrow_ci where the stride is 1, Ci <= 32 and 8 <= Co <= 256: tiles
      of 128 output pixels with all Co (64 where Co > 128), tw = Wo
      rounded up to 16, at most 64, and th = 128 // tw rows (64 // tw).
    - narrow_co where the stride is 1, Co < 8, Ci % 16 == 0 and
      Ci <= 256: strips tw wide (as above) and `_narrow_co_rows` tall.
    - mma_sync for the rest: 64 x 64 tiles, 64-byte K slices."""
    return _plan(tuple(x_shape), tuple(w_shape), stride, SM_COUNT)


@functools.lru_cache(maxsize=None)
def _plan(x_shape, w_shape, stride: int, sm_count: int) -> Plan:
    """`plan` with `sm_count` SMs to fill, cached by its arguments."""
    b, h, w, ci = x_shape
    co, kh, kw, _ = w_shape
    k = kh * kw * ci
    if stride == 1 and ci <= NARROW_CI_MAX_CI and 8 <= co <= 256:
        tw = _narrow_tw(w)
        th = max(1, (128 if co <= 128 else 64) // tw)
        return Plan("narrow_ci", th * tw, -(-co // 32) * 32, 32, kh * kw, 1,
                    th, tw)
    if stride == 1 and co < 8 and ci % 16 == 0 and ci <= NARROW_CO_MAX_CI:
        tw = _narrow_tw(w)
        return Plan("narrow_co", tw, 8, 32, kh * kw * -(-ci // 32), 1,
                    _narrow_co_rows(b, h, w, kh), tw)
    if ci % 64 or co < 8:
        return Plan("mma_sync", 64, 64, 64, -(-k // 64), 1)
    m = b * -(-h // stride) * -(-w // stride)
    bn = 256 if -(-co // 256) * 256 <= -(-co // 128) * 128 else 128
    stages = -(-k // WGMMA_BK)
    if bn == 128 and -(-m // 256) * -(-co // bn) >= sm_count:
        return Plan("wgmma", 256, bn, WGMMA_BK, stages, 1)
    tiles = -(-m // WGMMA_BM) * -(-co // bn)
    split = 1
    if tiles < sm_count:
        split = max(1, min(sm_count // tiles, stages // MIN_SPLIT_STAGES))
    return Plan("wgmma", WGMMA_BM, bn, WGMMA_BK, stages, split)


def split_ranges(stages: int, split: int) -> List[Tuple[int, int]]:
    """The K-stage range [begin, end) of each split-K block, as the kernel
    computes it from blockIdx.z: z*T//S .. (z+1)*T//S."""
    return [(z * stages // split, (z + 1) * stages // split)
            for z in range(split)]


_fns = {}
_LIBS = {"mma_sync": ("s8_conv", "dpig_s8_conv"),
         "wgmma": ("s8_conv_sm90", "dpig_s8_conv_sm90"),
         "narrow_ci": ("s8_conv_narrow_ci", "dpig_s8_conv_narrow_ci"),
         "narrow_co": ("s8_conv_narrow_co", "dpig_s8_conv_narrow_co")}


def _kernel(route: str):
    fn = _fns.get(route)
    if fn is None:
        from . import _build
        lib, sym = _LIBS[route]
        fn = getattr(_build.load(lib), sym)
        p, i = ctypes.c_void_p, ctypes.c_int
        # wgmma: bm, bn, split, workspace; the narrow routes: th, tw
        extra = {"wgmma": [i, i, i, p], "mma_sync": []}.get(route, [i, i])
        fn.argtypes = [p, p, p, p, p, i, p, p, i, p] + [i] * 12 + extra + [p]
        fn.restype = ctypes.c_int
        _fns[route] = fn
    return fn


def _per_channel(scale, co: int, device) -> torch.Tensor:
    """A scalar or [co] float32 scale as a contiguous [co] float32 vector
    (the same values: broadcasting copies, it does not round)."""
    t = torch.as_tensor(scale, dtype=torch.float32, device=device)
    if t.dim() == 0:
        t = t.expand(co)
    if t.shape != (co,):
        raise ValueError(f"scale of shape {tuple(t.shape)}, expected a "
                         f"scalar or [{co}]")
    return t.contiguous()


def out_shape(x8: torch.Tensor, w8: torch.Tensor, stride: int
              ) -> Tuple[int, int, int, int]:
    b, h, w, _ = x8.shape
    return b, -(-h // stride), -(-w // stride), w8.shape[0]


def epilogue(y: torch.Tensor, relu: bool = False,
             res: Optional[torch.Tensor] = None, res_scale=None,
             out_scale=None, out_dtype: torch.dtype = torch.bfloat16
             ) -> torch.Tensor:
    """float32 y [..., Co] (the conv's dequantized output plus bias) ->
    the requantized or cast output, in JAX's order of operations."""
    if relu:
        y = torch.relu(y)
    if res is not None:
        if res.dtype == torch.int8:
            y = y + res.to(torch.float32) * torch.as_tensor(
                res_scale, dtype=torch.float32, device=y.device)
        else:
            y = y + res.to(torch.float32)
    if out_dtype == torch.int8:
        s = torch.as_tensor(out_scale, dtype=torch.float32, device=y.device)
        return torch.clamp(torch.round(y / s), -127, 127).to(torch.int8)
    return y.to(out_dtype)


def conv_acc_plain(x8: torch.Tensor, w8: torch.Tensor, stride: int = 1
                   ) -> torch.Tensor:
    """The int32 sums [B,Ho,Wo,Co] of the s8 conv: an exact float64 conv."""
    kh, kw = w8.shape[1], w8.shape[2]
    x = x8.permute(0, 3, 1, 2).to(torch.float64)
    ph = same_pads(x.shape[2], kh, stride)
    pw = same_pads(x.shape[3], kw, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    acc = F.conv2d(x, w8.permute(0, 3, 1, 2).to(torch.float64), None, stride)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def s8_conv_plain(x8: torch.Tensor, w8: torch.Tensor, factor, bias,
                  stride: int = 1, relu: bool = False,
                  res: Optional[torch.Tensor] = None, res_scale=None,
                  out_scale=None, out_dtype: torch.dtype = torch.bfloat16
                  ) -> torch.Tensor:
    """The plain version of `s8_conv` (same arguments)."""
    acc = conv_acc_plain(x8, w8, stride)
    f = torch.as_tensor(factor, dtype=torch.float32, device=x8.device)
    b = torch.as_tensor(bias, dtype=torch.float32, device=x8.device)
    y = acc.to(torch.float32) * f + b
    return epilogue(y, relu, res, res_scale, out_scale, out_dtype)


_TAKES = {"wgmma": "Ci % 64 == 0 and Co >= 8",
          "narrow_ci": "stride 1, Ci <= 32 and 8 <= Co <= 256",
          "narrow_co": "stride 1, Co < 8, Ci % 16 == 0 and Ci <= 256"}


def s8_conv_cuda(x8: torch.Tensor, w8: torch.Tensor, factor, bias,
                 stride: int = 1, relu: bool = False,
                 res: Optional[torch.Tensor] = None, res_scale=None,
                 out_scale=None, out_dtype: torch.dtype = torch.bfloat16,
                 route: Optional[str] = None) -> torch.Tensor:
    """The kernel `plan` picks for these shapes (same arguments as
    `s8_conv`); CUDA tensors only. `route="mma_sync"` runs the older kernel
    on any shape, as a yardstick; `route="wgmma"`, `"narrow_ci"` or
    `"narrow_co"` raises on a shape the plan does not send there."""
    global launches
    if not (x8.is_cuda and w8.is_cuda):
        raise ValueError("s8_conv_cuda takes CUDA tensors; CPU tensors go "
                         "through s8_conv_plain")
    if x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise TypeError(f"x8 and w8 must be int8, got {x8.dtype}, "
                        f"{w8.dtype}")
    if x8.dim() != 4 or w8.dim() != 4 or x8.shape[3] != w8.shape[3]:
        raise ValueError(f"x8 {tuple(x8.shape)} must be [B,H,W,Ci] and w8 "
                         f"{tuple(w8.shape)} [Co,kh,kw,Ci]")
    kh, kw = w8.shape[1], w8.shape[2]
    if kh != kw or kh not in (1, 3) or stride not in (1, 2):
        raise ValueError(f"kernel {kh}x{kw} stride {stride}: the kernel "
                         "takes 1x1 or 3x3, stride 1 or 2")
    if not (x8.is_contiguous() and w8.is_contiguous()):
        raise ValueError("x8 and w8 must be contiguous")
    if out_dtype not in _OUT_KINDS:
        raise TypeError(f"out_dtype {out_dtype}: int8, bfloat16 or float32")
    dev = x8.device
    b, ho, wo, co = out_shape(x8, w8, stride)
    if max(x8.numel(), b * ho * wo * co, w8.numel()) >= 2 ** 31:
        raise ValueError("tensors must hold under 2^31 elements")
    f = _per_channel(factor, co, dev)
    bb = _per_channel(bias, co, dev)
    res_kind = _RES_KINDS.get(None if res is None else res.dtype)
    if res_kind is None:
        raise TypeError(f"res must be int8 or bfloat16, got {res.dtype}")
    rs = None
    if res is not None:
        if tuple(res.shape) != (b, ho, wo, co) or not res.is_contiguous() \
                or res.device != dev:
            raise ValueError(f"res must be a contiguous [{b},{ho},{wo},{co}] "
                             f"tensor on {dev}, got {tuple(res.shape)}")
        if res_kind == 1:
            rs = _per_channel(res_scale, co, dev)
    os_ = (_per_channel(out_scale, co, dev) if out_dtype == torch.int8
           else None)
    out = torch.empty((b, ho, wo, co), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    how = plan(tuple(x8.shape), tuple(w8.shape), stride)
    if route is None:
        route = how.route
    elif route not in ROUTES:
        raise ValueError(f"route {route!r}: one of {ROUTES}")
    elif route != "mma_sync" and how.route != route:
        raise ValueError(f"x8 {tuple(x8.shape)}, w8 {tuple(w8.shape)}, "
                         f"stride {stride}: the {route} route takes "
                         f"{_TAKES[route]}")
    extra = []
    if route in ("narrow_ci", "narrow_co"):
        if x8.data_ptr() % 16:
            raise ValueError(f"the {route} route needs x8 16-byte aligned "
                             "(cp.async)")
        extra = [how.th, how.tw]
    if route == "wgmma":
        if x8.data_ptr() % 16 or w8.data_ptr() % 16:
            raise ValueError("the wgmma route needs x8 and w8 16-byte "
                             "aligned (cp.async and TMA)")
        ws = None
        if how.split > 1:  # each split's int32 partial sums [M, Co]
            ws = torch.empty(how.split * b * ho * wo * co, dtype=torch.int32,
                             device=dev)
        extra = [how.bm, how.bn, how.split,
                 0 if ws is None else ws.data_ptr()]
    pt = same_pads(x8.shape[1], kh, stride)[0]
    pl = same_pads(x8.shape[2], kw, stride)[0]
    ptr = (lambda t: 0 if t is None else t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel(route)(
            x8.data_ptr(), w8.data_ptr(), f.data_ptr(), bb.data_ptr(),
            ptr(res), res_kind, ptr(rs), out.data_ptr(),
            _OUT_KINDS[out_dtype], ptr(os_), int(relu), b, x8.shape[1],
            x8.shape[2], x8.shape[3], ho, wo, co, kh, stride, pt, pl, *extra,
            stream)
    if err == -1:
        raise RuntimeError("s8_conv (wgmma): the driver has no "
                           "cuTensorMapEncodeTiled")
    if err <= -1000:
        raise RuntimeError(f"s8_conv (wgmma): cuTensorMapEncodeTiled "
                           f"failed: CUresult {-1000 - err}")
    if err != 0:
        raise RuntimeError(f"s8_conv launch failed ({route}): cudaError "
                           f"{err}")
    launches += 1
    launches_by_route[route] += 1
    return out


def s8_conv(x8: torch.Tensor, w8: torch.Tensor, factor, bias,
            stride: int = 1, relu: bool = False,
            res: Optional[torch.Tensor] = None, res_scale=None,
            out_scale=None, out_dtype: torch.dtype = torch.bfloat16
            ) -> torch.Tensor:
    """x8 [B,H,W,Ci] int8, w8 [Co,kh,kw,Ci] int8, factor and bias [Co]
    float32 (or scalars), an optional residual `res` [B,Ho,Wo,Co] (int8
    with `res_scale`, or bfloat16), `out_scale` (int8 output) -> [B,Ho,Wo,
    Co] in `out_dtype`. The kernel for CUDA tensors, the plain version for
    CPU ones."""
    if x8.is_cuda:
        return s8_conv_cuda(x8, w8, factor, bias, stride, relu, res,
                            res_scale, out_scale, out_dtype)
    return s8_conv_plain(x8, w8, factor, bias, stride, relu, res, res_scale,
                         out_scale, out_dtype)
