"""The s8 conv's routing (`kernels/s8_conv.py:plan`) and the wgmma
kernel's decomposition (`csrc/s8_conv_sm90.cu`), on the CPU.

The kernel itself runs only on the card (tests/test_torch_cuda.py). Here:

- `int8_batch_calls` lists the s8 convs of one int8 model-12 batch from
  the architecture; at a tiny config it equals the calls the port's int8
  tester makes, and at the Market config (128x64, hidden 128, batch 16,
  7 ROI crops of 48x48) it gives the 60 launches `plan` is checked on:
  every conv with Ci % 64 == 0 and Co >= 8 takes the wgmma route, the
  pose stem and to_rgb the mma_sync one; a tile grid below the SM count
  gets a split-K factor above 1, whose K ranges cover the K stages
  exactly once; and 127^2 * K stays below 2^31, so any K order and split
  gives the same int32 sum.
- `emulate_wgmma` repeats the kernel's index arithmetic in torch: rows
  decoded once, each producer thread's 16-byte column stepped through
  (r, s, ci) by adds per 128-byte stage, the SAME padding and K past its
  end as zeros, the weights' tile past Co or K as zeros (TMA's fill), the
  split-K partials summed in int32. It must equal the plain version's
  int32 sums for stride 1 and 2, k 1 and 3, Ci 64 (two taps a stage) to
  192 (a stage straddling taps), ragged M and N, split on and off.
- `requant_fast` repeats the kernel's requantization rule (requant8) in
  float32 numpy: q0 = y * inv with inv the reciprocal within 1 ulp (the
  card's rcp.approx), rounded and clipped, the IEEE division taken only
  near a half-integer; wherever the rule keeps q0 it must give
  clip(rint(y / os)), on random values and on values placed within a few
  ulps of every rounding boundary.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.apps.testers import ConditionalTransferTester
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.data.synthetic import SyntheticLoader
from dpig_tpu_torch.kernels import s8_conv as sc
from dpig_tpu_torch.models import quant
from dpig_tpu_torch.models.layers import same_pads

torch.set_num_threads(1)

POSE_CH, PARTS, ROI = 18, 7, 48


def int8_batch_calls(b, h, w, hidden, repeat):
    """(x shape, w shape, stride) of each s8 conv one int8 model-12 batch
    launches: the generator (stem, encoder tower, decoder, to_rgb) and the
    FG/BG encoder (stem Conv_1-2, the ROI tower on b*7 crops, the BG
    tower)."""
    calls = [((b, h, w, POSE_CH), (hidden, 3, 3, POSE_CH), 1)]

    def tower(n, hh, ww):
        for idx in range(repeat):
            ch = hidden * (idx + 1)
            calls.extend([((n, hh, ww, ch), (ch, 3, 3, ch), 1)] * 2)
            if idx < repeat - 1:
                calls.append(((n, hh, ww, ch),
                              (hidden * (idx + 2), 3, 3, ch), 2))
                hh, ww = -(-hh // 2), -(-ww // 2)
        return hh, ww

    hh, ww = tower(b, h, w)
    x_ch = hidden
    for idx in range(repeat):
        ch = x_ch + hidden * (repeat - idx)
        calls.extend([((b, hh, ww, ch), (ch, 3, 3, ch), 1)] * 2)
        if idx < repeat - 1:
            x_ch = hidden * (repeat - idx - 1)
            calls.append(((b, hh, ww, ch), (x_ch, 1, 1, ch), 1))
            hh, ww = 2 * hh, 2 * ww
    calls.append(((b, h, w, ch), (3, 3, 3, ch), 1))
    calls.extend([((b, h, w, hidden), (hidden, 3, 3, hidden), 1)] * 2)
    tower(b * PARTS, ROI, ROI)
    tower(b, h, w)
    return calls


MARKET = int8_batch_calls(16, 128, 64, 128, 5)
MARKET_SHAPES = sorted(set(MARKET))


def test_the_listed_calls_are_the_int8_testers(monkeypatch, tmp_path):
    """At a tiny config, one int8 transfer batch launches exactly the
    convs `int8_batch_calls` lists."""
    calls, launch = [], quant.s8_conv

    def recording(x8, w8, factor, bias, stride=1, *args, **kw):
        calls.append((tuple(x8.shape), tuple(w8.shape), stride))
        return launch(x8, w8, factor, bias, stride, *args, **kw)

    cfg = Config(platform="cpu", model_dir=str(tmp_path), img_H=32,
                 img_W=16, batch_size=2, conv_hidden_num=16, z_num=16,
                 inference_dtype="int8", int8_selfcheck=False)
    tester = ConditionalTransferTester(cfg)
    batch = batch_to_device(next(SyntheticLoader(2, 32, 16, seed=1)),
                            tester.device)
    tester._inference_params(batch)
    monkeypatch.setattr(quant, "s8_conv", recording)
    tester.transfer_step(batch)
    assert Counter(calls) == Counter(int8_batch_calls(2, 32, 16, 16,
                                                      cfg.repeat_num))


def test_market_batch_has_60_launches():
    assert len(MARKET) == 60
    gen = MARKET[:30]
    assert gen[0][1] == (128, 3, 3, POSE_CH) and gen[-1][1][0] == 3


def _tiles(x_shape, w_shape, stride, how):
    b, h, w, _ = x_shape
    m = b * -(-h // stride) * -(-w // stride)
    return -(-m // how.bm) * -(-w_shape[0] // how.bn)


@pytest.mark.parametrize("call", MARKET_SHAPES, ids=str)
def test_plan_routes_every_market_shape(call):
    x_shape, w_shape, stride = call
    how = sc.plan(x_shape, w_shape, stride)
    ci, co = x_shape[3], w_shape[0]
    k = w_shape[1] * w_shape[2] * ci
    assert 127 * 127 * k < 2 ** 31
    if ci % 64 or co < 8:
        assert how.route == "mma_sync" and how.split == 1
        assert ci == POSE_CH or co == 3
        return
    assert how.route == "wgmma"
    assert how.bn in (128, 256) and how.stages == -(-k // 128)
    if _tiles(x_shape, w_shape, stride, how) < sc.SM_COUNT:
        assert how.split > 1
    ranges = sc.split_ranges(how.stages, how.split)
    covered = [s for a, b in ranges for s in range(a, b)]
    assert covered == list(range(how.stages))
    assert all(b - a >= sc.MIN_SPLIT_STAGES or how.split == 1
               for a, b in ranges)


def test_plan_sends_all_but_the_stem_and_to_rgb_to_wgmma():
    routes = Counter(sc.plan(*c).route for c in MARKET)
    assert routes == {"wgmma": 58, "mma_sync": 2}


@pytest.mark.parametrize("co,bn", [(72, 128), (128, 128), (200, 256),
                                   (384, 128), (640, 128), (768, 256),
                                   (1024, 256)])
def test_plan_picks_the_n_tile_that_pads_co_least(co, bn):
    assert sc.plan((16, 64, 32, 128), (co, 3, 3, 128), 1).bn == bn


def emulate_wgmma(x8, w8, stride, how):
    """The int32 sums [B,Ho,Wo,Co] as the wgmma kernel forms them."""
    b, h, w, ci = x8.shape
    co, ks = w8.shape[0], w8.shape[1]
    ho, wo = -(-h // stride), -(-w // stride)
    m_all, k_all, bk = b * ho * wo, ks * ks * ci, how.bk
    m = torch.arange(m_all)
    ow, t = m % wo, m // wo
    oh, bb = t % ho, t // ho
    ih0 = oh * stride - same_pads(h, ks, stride)[0]
    iw0 = ow * stride - same_pads(w, ks, stride)[0]
    xf = x8.reshape(-1).to(torch.int64)
    wk = torch.zeros(co, how.stages * bk, dtype=torch.int64)
    wk[:, :k_all] = w8.reshape(co, k_all).to(torch.int64)
    acc = torch.zeros(m_all, co, dtype=torch.int32)
    for s0, s1 in sc.split_ranges(how.stages, how.split):
        part = torch.zeros(m_all, co, dtype=torch.int64)
        for c in range(bk // 16):  # one producer thread's column
            k = s0 * bk + 16 * c
            tap = k // ci
            cc, r = k - tap * ci, tap // ks
            s = tap - r * ks
            for st in range(s0, s1):
                ih, iw = ih0 + r, iw0 + s
                ok = (r < ks) & (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
                off = ((bb * h + ih) * w + iw) * ci + cc
                idx = torch.where(ok, off, 0)[:, None] + torch.arange(16)
                a = torch.where(ok[:, None], xf[idx], 0)
                part += a @ wk[:, st * bk + 16 * c:st * bk + 16 * c + 16].T
                cc += bk
                while cc >= ci:
                    cc -= ci
                    s += 1
                    if s == ks:
                        s, r = 0, r + 1
        assert part.abs().max() < 2 ** 31
        acc += part.to(torch.int32)  # the workspace's int32 adds
    return acc.reshape(b, ho, wo, co)


@pytest.mark.parametrize("b,h,w,ci,co,k,stride", [
    (1, 5, 3, 64, 8, 1, 1), (2, 7, 5, 64, 72, 3, 1),
    (1, 9, 6, 128, 20, 3, 2), (2, 6, 6, 192, 136, 3, 2),
    (1, 4, 7, 256, 264, 1, 2), (1, 3, 3, 640, 24, 3, 1)])
@pytest.mark.parametrize("split", [None, 1, 3])
def test_emulated_decomposition_equals_the_plain_sums(b, h, w, ci, co, k,
                                                      stride, split):
    g = torch.Generator().manual_seed(ci * 7 + co)
    x8 = torch.randint(-127, 128, (b, h, w, ci), generator=g,
                       dtype=torch.int8)
    w8 = torch.randint(-127, 128, (co, k, k, ci), generator=g,
                       dtype=torch.int8)
    how = sc.plan(x8.shape, w8.shape, stride)
    assert how.route == "wgmma"
    if split is not None:
        how = sc.Plan(how.route, how.bm, how.bn, how.bk, how.stages,
                      min(split, how.stages))
    got = emulate_wgmma(x8, w8, stride, how)
    assert torch.equal(got, sc.conv_acc_plain(x8, w8, stride))


def test_split_ranges_are_the_kernels():
    for stages in (1, 4, 9, 45, 54, 72):
        for split in range(1, stages + 1):
            r = sc.split_ranges(stages, split)
            assert r[0][0] == 0 and r[-1][1] == stages
            assert all(a < b for a, b in r)
            assert all(r[i][1] == r[i + 1][0] for i in range(split - 1))
            assert sum(b - a for a, b in r) == stages


def requant_fast(y, os_, inv):
    """requant8 of csrc/s8_conv_sm90.cu in float32: (clip(rint(y * inv))
    or +-127, True where the kernel divides instead)."""
    q0 = (y * inv).astype(np.float32)
    a = np.abs(q0)
    with np.errstate(invalid="ignore"):
        slow = ~(a >= 130) & ~(np.abs(a - np.floor(a) - np.float32(0.5))
                               > np.float32(1e-3))
        q = np.where(a >= 130, np.copysign(np.float32(127), q0),
                     np.rint(q0))  # rint: half to even, as rintf
    return np.clip(q, -127, 127), slow


def test_requant_fast_path_equals_the_division():
    rng = np.random.default_rng(0)
    n = 200_000
    os_ = (rng.random(n) * 0.2 + 1e-3).astype(np.float32)
    y = (rng.standard_normal(n) * 16).astype(np.float32)
    # y / os within a few ulps of every half-integer from -140.5 to 140.5
    half = rng.integers(-141, 141, n).astype(np.float32) + np.float32(0.5)
    edge = (half * os_).astype(np.float32)
    for _ in range(4):
        step = rng.integers(-1, 2, n).astype(bool)
        edge = np.where(step, np.nextafter(edge, np.float32(np.inf)), edge)
    y = np.concatenate([y, edge, -edge, np.zeros(4, np.float32)])
    os_ = np.concatenate([os_, os_, os_, np.ones(4, np.float32)])
    inv = (np.float32(1) / os_).astype(np.float32)
    want = np.clip(np.rint((y / os_).astype(np.float32)), -127, 127)
    for ulps in (-1, 0, 1):  # rcp.approx is within 1 ulp
        approx = inv
        for _ in range(abs(ulps)):
            approx = np.nextafter(approx, np.float32(np.inf * ulps))
        got, slow = requant_fast(y, os_, approx)
        assert np.array_equal(got[~slow], want[~slow])
        assert slow[:n].mean() < 0.01  # random values rarely divide
        assert slow[n:].mean() > 0.5   # boundary values mostly do
