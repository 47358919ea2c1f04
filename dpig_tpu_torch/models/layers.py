"""Shared building blocks (port of `dpig_tpu/models/layers.py:18-88`).

Modules take and return NCHW tensors; the public model functions convert
from the JAX package's NHWC. Submodules carry the flax names (`Conv_0`,
`Dense_0`, `BatchNorm_0`, ...) so that `bridge.py` maps a flax param tree
onto them path for path.

Initializers: Xavier-uniform for generator-side nets (slim defaults in the
reference), normal(0.02) for discriminators (tflib set_weights_stdev(0.02),
wgan_gp.py:411-413), zero biases; drawn from an explicit torch.Generator.

Compute dtype (`dtype`, flax's `dtype=` of `nn.Conv` / `nn.Dense` /
`nn.BatchNorm`): parameters stay float32 and the input, kernel and bias are
cast to it. In bfloat16 the conv or matmul output is rounded to bfloat16
and the bfloat16 bias added after, a second rounding, as flax does
(`F.conv2d(x, w, b)` would add the bias before the one rounding). The
norms take their statistics and normalize in float32 and round the result
to the compute dtype (flax's `_compute_stats` / `_normalize`).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import dist

XAVIER = "xavier"
D_INIT = "normal_0.02"


def leaky_relu(x: torch.Tensor, alpha: float = 0.3) -> torch.Tensor:
    """Reference LeakyReLU has alpha=0.3 (models.py:137-138)."""
    return torch.maximum(alpha * x, x)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's SAME rule: out = ceil(size/stride),
    total = (out-1)*stride + kernel - size, low = total//2. Asymmetric for
    stride 2 on even sizes: (0,1) for 3x3, (1,2) for 5x5."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class _NativeConv2d(torch.autograd.Function):
    """`F.conv2d` whose forward and backward both run PyTorch's own CUDA
    convolution (im2col + cuBLAS), not cuDNN: the backward picks its
    kernels by the flags at backward time, so a flag around the forward
    alone would not keep cuDNN out of it. Its backward is
    `_NativeConv2dGrad`, differentiable again on the same kernels, so a
    gradient penalty's double backward stays off cuDNN too."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, padding, bias is not None)
        with torch.backends.cudnn.flags(enabled=False):
            return F.conv2d(x, weight, bias, stride, padding)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, has_bias = ctx.conv
        need = ctx.needs_input_grad
        gx, gw, gb = _NativeConv2dGrad.apply(
            grad, x, weight, stride, padding,
            (need[0], need[1], has_bias and need[2]))
        return gx, gw, gb, None, None


class _NativeConv2dGrad(torch.autograd.Function):
    """The gradients of `_NativeConv2d` w.r.t. (x, weight, bias), as one
    `aten.convolution_backward` on PyTorch's own kernels (`mask` picks
    which; the others are None). The conv is bilinear, so its backward is
    again a conv forward (`_NativeConv2d`) and conv backwards (this)."""

    @staticmethod
    def forward(ctx, grad, x, weight, stride, padding, mask):
        ctx.save_for_backward(grad, x, weight)
        ctx.conv = (stride, padding)
        with torch.backends.cudnn.flags(enabled=False):
            return tuple(torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if mask[2] else None,
                [stride] * 2, list(padding), [1, 1], False, [0, 0], 1,
                list(mask)))

    @staticmethod
    def backward(ctx, ggx, ggw, ggb):
        grad, x, weight = ctx.saved_tensors
        stride, padding = ctx.conv
        need = ctx.needs_input_grad
        d_grad = d_x = d_w = None
        if need[0]:
            terms = []
            if ggx is not None:
                terms.append(_NativeConv2d.apply(ggx, weight, None, stride,
                                                 padding))
            if ggw is not None:
                terms.append(_NativeConv2d.apply(x, ggw, None, stride,
                                                 padding))
            if ggb is not None:
                terms.append(ggb[:, None, None].expand_as(grad))
            d_grad = sum(terms) if terms else None
        if need[1] and ggw is not None:
            d_x = _NativeConv2dGrad.apply(grad, x, ggw, stride, padding,
                                          (True, False, False))[0]
        if need[2] and ggx is not None:
            d_w = _NativeConv2dGrad.apply(grad, ggx, weight, stride, padding,
                                          (False, True, False))[1]
        return d_grad, d_x, d_w, None, None, None


def _conv2d(x, weight, bias, stride, padding=(0, 0), cudnn=True):
    if cudnn or not x.is_cuda:
        return F.conv2d(x, weight, bias, stride, padding)
    return _NativeConv2d.apply(x, weight, bias, stride, tuple(padding))


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias, stride: int = 1,
                padding: str = "SAME", cudnn: bool = True) -> torch.Tensor:
    """NCHW conv with XLA SAME padding (or none, `padding="VALID"`);
    weight OIHW.

    A bfloat16 conv sums its exact products in float32 and rounds the
    output once. On the CPU it runs as exactly that, a float32 conv of the
    bfloat16 values rounded to bfloat16: PyTorch's oneDNN bfloat16 conv
    returns wrong sums at some shapes (the Market DCGAN D's last stage at
    32x16, 256 -> 512 channels, 5x5 stride 2 on a padded 7x5 input, is off
    by the output's own magnitude). CUDA tensors go to cuDNN's bfloat16
    conv, and to cuDNN's float32 conv unless `cudnn=False`, which runs
    PyTorch's own kernels forward and backward (`_NativeConv2d`)."""
    if x.dtype == torch.bfloat16 and not x.is_cuda:
        return conv2d_same(x.to(torch.float32), weight.to(torch.float32),
                           bias, stride, padding).to(x.dtype)
    if padding == "VALID":
        return _conv2d(x, weight, bias, stride, cudnn=cudnn)
    ph = same_pads(x.shape[2], weight.shape[2], stride)
    pw = same_pads(x.shape[3], weight.shape[3], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return _conv2d(x, weight, bias, stride, (ph[0], pw[0]), cudnn)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return _conv2d(x, weight, bias, stride, cudnn=cudnn)


class Conv(nn.Module):
    """flax `nn.Conv` twin: square kernel, SAME (or VALID) padding, a bias
    unless `bias=False` (flax's `use_bias`), computed in `dtype`.
    `cudnn=False`: in float32 on the card, PyTorch's own conv kernels
    instead of cuDNN's, forward and backward (the DCGAN D's,
    `models/discriminators.py`)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 init: str = XAVIER, dtype: torch.dtype = torch.float32,
                 padding: str = "SAME", cudnn: bool = True,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.stride = stride
        self.init = init
        self.dtype = dtype
        self.padding = padding
        self.cudnn = cudnn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if dt == torch.float32:
            return conv2d_same(x.to(dt), self.weight, self.bias, self.stride,
                               self.padding, self.cudnn)
        y = conv2d_same(x.to(dt), self.weight.to(dt), None, self.stride,
                        self.padding)
        if self.bias is None:
            return y
        return y + self.bias.to(dt)[:, None, None]


class Dense(nn.Linear):
    """flax `nn.Dense` twin (torch weight layout [out, in]), computed in
    `dtype`."""

    def __init__(self, in_features: int, out_features: int,
                 init: str = XAVIER, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.init = init
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if dt == torch.float32:
            return F.linear(x.to(dt), self.weight, self.bias)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9)` twin over NCHW channels (epsilon
    1e-5, biased variance). `train=True` normalizes by the batch's own
    statistics and leaves the running buffers untouched, as a flax apply
    whose updated `batch_stats` are thrown away; with `update_stats=True`
    it also moves the buffers as flax's mutable apply does,
    `ra = 0.9 * ra + 0.1 * batch_stat`, the variance being flax's fast
    biased one, max(mean(x^2) - mean(x)^2, 0). (`F.batch_norm` with
    buffers would store the unbiased variance.) `train=False` uses the
    buffers. Statistics and the normalization are float32 whatever the
    input; the output is rounded to `dtype`.

    In a train step across ranks (`parallel.dist.global_batch_stats`,
    world > 1) the statistics are the global batch's, as flax's BatchNorm
    computes them on a batch sharded over a mesh: the per-channel sums of
    x and x^2 and the count, all-reduced differentiably, give the mean and
    flax's fast variance, which normalize the rank's rows and, with
    `update_stats`, move the running buffers. At world 1 nothing
    changes."""

    MOMENTUM = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.eps = eps

    @torch.no_grad()
    def _update_stats(self, x: torch.Tensor) -> None:
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        self._move_stats(mean, var)

    @torch.no_grad()
    def _move_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        # statistics in float32 (float64 for a float64 check run)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if train and dist.batch_stats_are_global():
            y = self._global_batch_norm(x, update_stats)
        elif train:
            if update_stats:
                self._update_stats(x)
            y = F.batch_norm(x, None, None, self.weight, self.bias,
                             training=True, momentum=0.0, eps=self.eps)
        else:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, training=False,
                             eps=self.eps)
        return y.to(self.dtype)

    def _global_batch_norm(self, x: torch.Tensor,
                           update_stats: bool) -> torch.Tensor:
        c = x.shape[1]
        count = x.new_full((1,), float(x.numel() // c))
        sums = dist.all_reduce_sum(torch.cat(
            [x.sum((0, 2, 3)), (x * x).sum((0, 2, 3)), count]))
        mean = sums[:c] / sums[-1]
        var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
        if update_stats:
            self._move_stats(mean.detach(), var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` twin over the channels of an NCHW tensor (flax's
    `reduction_axes=-1` on NHWC; not the reference TF's LayerNorm over
    C, H and W), epsilon 1e-6, `scale` / `bias` of shape [C]. As flax
    0.12 computes it: the statistics in float32, the variance its fast
    one, max(mean(x^2) - mean(x)^2, 0), then (x - mean) * (rsqrt(var +
    eps) * scale) + bias, rounded to `dtype`. It keeps no running
    statistics: `train` and `update_stats` are accepted and unused, so it
    stands where a BatchNorm does (the 'wgan-gp' GAN mode)."""

    def __init__(self, num_features: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x.mean(1, keepdim=True)
        var = torch.clamp((x * x).mean(1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight[:, None, None]
        return ((x - mean) * mul + self.bias[:, None, None]).to(self.dtype)


def upscale_nn_nchw(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbor upsample of an NCHW tensor (`ops/image.py:
    upscale_nn` on NHWC)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, H*W*C] in NHWC order, as the flax Dense inputs are."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _xavier_uniform_(w: torch.Tensor, gen: torch.Generator) -> None:
    receptive = w[0][0].numel() if w.dim() > 2 else 1
    fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-bound, bound, generator=gen)


@torch.no_grad()
def init_weights(module: nn.Module, gen: torch.Generator) -> None:
    """Fresh weights for every Conv/Dense/BatchNorm/LayerNorm (and the
    generator's raw stem) under `module`, in module order; the tensors
    must lie on the generator's device."""
    for m in module.modules():
        if isinstance(m, (Conv, Dense)):
            if m.init == XAVIER:
                _xavier_uniform_(m.weight, gen)
            else:
                m.weight.normal_(0.0, 0.02, generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (BatchNorm, LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        if isinstance(m, BatchNorm):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        if hasattr(m, "stem_kernel"):  # UAEGenerator's raw stem params
            _xavier_uniform_(m.stem_kernel, gen)
            m.stem_bias.zero_()


class ConvBlockTower(nn.Module):
    """The reference's repeated conv-res tower (models.py:235-244).

    Stage idx in [0, repeat_num): channel = hidden*(idx+1); two 3x3 convs
    + residual; a stride-2 3x3 conv to hidden*(idx+2) between stages.
    The input has `hidden_num` channels (the first residual add).
    """

    def __init__(self, repeat_num: int, hidden_num: int,
                 activation: Callable = F.relu, collect_skips: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.repeat_num = repeat_num
        self.activation = activation
        self.collect_skips = collect_skips
        i = 0
        for idx in range(repeat_num):
            ch = hidden_num * (idx + 1)
            self.add_module(f"Conv_{i}", Conv(ch, ch, 3, dtype=dtype))
            self.add_module(f"Conv_{i + 1}", Conv(ch, ch, 3, dtype=dtype))
            i += 2
            if idx < repeat_num - 1:
                self.add_module(f"Conv_{i}",
                                Conv(ch, hidden_num * (idx + 2), 3, stride=2,
                                     dtype=dtype))
                i += 1

    def forward(self, x: torch.Tensor):
        act = self.activation
        convs = iter(self.children())
        skips: List[torch.Tensor] = []
        for idx in range(self.repeat_num):
            res = x
            x = act(next(convs)(x))
            x = act(next(convs)(x))
            x = x + res
            if self.collect_skips:
                skips.append(x)
            if idx < self.repeat_num - 1:
                x = act(next(convs)(x))
        if self.collect_skips:
            return x, skips
        return x


class FCResTrunk(nn.Module):
    """FC residual trunk (port of `dpig_tpu/models/layers.py:66-88`;
    models.py:479-483 pattern): `Dense_0` in_dim -> hidden, then
    `repeat_num` blocks of two hidden -> hidden layers with a residual add
    (`Dense_1` ... `Dense_{2R}`, flax's automatic names).
    `first_activation=None` leaves `Dense_0`'s output as it is."""

    def __init__(self, in_dim: int, repeat_num: int, hidden_num: int,
                 activation: Callable = F.relu,
                 first_activation: Optional[Callable] = None):
        super().__init__()
        self.repeat_num = repeat_num
        self.activation = activation
        self.first_activation = first_activation
        self.Dense_0 = Dense(in_dim, hidden_num)
        for i in range(1, 2 * repeat_num + 1):
            self.add_module(f"Dense_{i}", Dense(hidden_num, hidden_num))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = self.activation
        x = self.Dense_0(x)
        if self.first_activation is not None:
            x = self.first_activation(x)
        for r in range(self.repeat_num):
            res = x
            x = act(getattr(self, f"Dense_{2 * r + 1}")(x))
            x = act(getattr(self, f"Dense_{2 * r + 2}")(x))
            x = res + x
        return x
