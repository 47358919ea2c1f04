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


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias, stride: int = 1
                ) -> torch.Tensor:
    """NCHW conv with XLA SAME padding; weight OIHW.

    A bfloat16 conv sums its exact products in float32 and rounds the
    output once. On the CPU it runs as exactly that, a float32 conv of the
    bfloat16 values rounded to bfloat16: PyTorch's oneDNN bfloat16 conv
    returns wrong sums at some shapes (the Market DCGAN D's last stage at
    32x16, 256 -> 512 channels, 5x5 stride 2 on a padded 7x5 input, is off
    by the output's own magnitude). CUDA tensors go to cuDNN's bfloat16
    conv."""
    if x.dtype == torch.bfloat16 and not x.is_cuda:
        return conv2d_same(x.to(torch.float32), weight.to(torch.float32),
                           bias, stride).to(x.dtype)
    ph = same_pads(x.shape[2], weight.shape[2], stride)
    pw = same_pads(x.shape[3], weight.shape[3], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, weight, bias, stride, (ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, weight, bias, stride)


class Conv(nn.Module):
    """flax `nn.Conv` twin: square kernel, SAME padding, bias, computed in
    `dtype`."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 init: str = XAVIER, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.stride = stride
        self.init = init
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if dt == torch.float32:
            return conv2d_same(x.to(dt), self.weight, self.bias, self.stride)
        y = conv2d_same(x.to(dt), self.weight.to(dt), None, self.stride)
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
    input; the output is rounded to `dtype`."""

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
        m = self.MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        # statistics in float32 (float64 for a float64 check run)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            if update_stats:
                self._update_stats(x)
            y = F.batch_norm(x, None, None, self.weight, self.bias,
                             training=True, momentum=0.0, eps=self.eps)
        else:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, training=False,
                             eps=self.eps)
        return y.to(self.dtype)


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
    """Fresh weights for every Conv/Dense/BatchNorm (and the generator's
    raw stem) under `module`, in module order; the tensors must lie on
    the generator's device."""
    for m in module.modules():
        if isinstance(m, (Conv, Dense)):
            if m.init == XAVIER:
                _xavier_uniform_(m.weight, gen)
            else:
                m.weight.normal_(0.0, 0.02, generator=gen)
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
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
