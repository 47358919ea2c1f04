"""The s8 conv's routing (`kernels/s8_conv.py:plan`) and the wgmma and
narrow kernels' decompositions (`csrc/s8_conv_sm90.cu`,
`csrc/s8_conv_narrow_ci.cu`, `csrc/s8_conv_narrow_co.cu`), on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
Here:

- `int8_batch_calls` lists the s8 convs of one int8 model-12 batch from
  the architecture; at a tiny config it equals the calls the port's int8
  tester makes, and at the Market config (128x64, hidden 128, batch 16,
  7 ROI crops of 48x48) it gives the 60 launches `plan` is checked on:
  every conv with Ci % 64 == 0 and Co >= 8 takes the wgmma route, the
  pose stem the narrow_ci one and to_rgb the narrow_co one (at Market
  batch 8, 16 and 64 and at 256x256 batch 16 too, with their tiles);
  other narrow shapes keep their routes; a tile grid below the SM count
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
- `emulate_narrow_ci` and `emulate_narrow_co` repeat the narrow kernels'
  index arithmetic in numpy, tile by tile: narrow_ci's raw row spans
  (16-byte aligned, the tensor's last chunk cut short), the halo tile
  built by funnel shifts with each tap's channels padded to 32 and the
  16-byte halves swapped on every other 4 columns, A read back by the
  ldmatrix addresses, N padded to a warp's 32; narrow_co's ring rows
  (pixels padded to an odd number of 16-byte chunks, garbage past them),
  each warp's k32 chunk, the windows of 16 input pixels times the
  column taps and the shuffles that shift them onto the output pixels,
  N padded to 8, the 8 warps' partial sums. Each must equal the plain
  version's int32 sums on ragged B, H and W.
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
        assert how.split == 1
        assert how.route == ("narrow_ci" if ci == POSE_CH else "narrow_co")
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
    assert routes == {"wgmma": 58, "narrow_ci": 1, "narrow_co": 1}


# (batch, H, W): Market batch 8 (a DDP rank), 16 and 64 (the int8 gate),
# 256x256 batch 16 (models 1001 / 1002) -> the narrow_co strip height
NARROW_SIZES = {(8, 128, 64): 4, (16, 128, 64): 8, (64, 128, 64): 32,
                (16, 256, 256): 64}


@pytest.mark.parametrize("size", NARROW_SIZES, ids=str)
def test_plan_sends_the_stem_and_to_rgb_to_the_narrow_routes(size):
    b, h, w = size
    stem = sc.plan((b, h, w, POSE_CH), (128, 3, 3, POSE_CH), 1)
    assert (stem.route, stem.th, stem.tw, stem.bm, stem.bn, stem.stages) \
        == ("narrow_ci", 2, 64, 128, 128, 9)
    rgb = sc.plan((b, h, w, 256), (3, 3, 3, 256), 1)
    assert (rgb.route, rgb.th, rgb.tw, rgb.bn, rgb.stages) \
        == ("narrow_co", NARROW_SIZES[size], 64, 8, 72)
    # one wave of the 2 blocks a SM holds, and every strip row covered
    strips = b * -(-w // rgb.tw) * -(-h // rgb.th)
    assert strips <= sc.NARROW_SLOTS and rgb.th * -(-h // rgb.th) >= h


@pytest.mark.parametrize("x_shape,w_shape,stride,route", [
    ((2, 11, 7, 18), (128, 3, 3, 18), 2, "mma_sync"),  # stride 2
    ((2, 9, 5, 48), (64, 3, 3, 48), 1, "mma_sync"),    # 48 channels
    ((2, 9, 5, 33), (64, 3, 3, 33), 1, "mma_sync"),    # Ci > 32
    ((2, 9, 5, 18), (3, 3, 3, 18), 1, "mma_sync"),     # Ci % 16, Co < 8
    ((2, 32, 16, 8), (3, 3, 3, 8), 1, "mma_sync"),     # to_rgb at hidden 4
    ((2, 9, 5, 256), (3, 3, 3, 256), 2, "mma_sync"),   # stride 2
    ((2, 9, 5, 272), (3, 3, 3, 272), 1, "mma_sync"),   # Ci > 256
    ((2, 9, 5, 18), (257, 3, 3, 18), 1, "mma_sync"),   # Co > 256
    ((2, 9, 5, 18), (7, 3, 3, 18), 1, "mma_sync"),     # Co < 8
    ((2, 9, 5, 32), (256, 1, 1, 32), 1, "narrow_ci"),
    ((2, 9, 5, 3), (8, 3, 3, 3), 1, "narrow_ci"),
    ((2, 9, 5, 16), (7, 1, 1, 16), 1, "narrow_co"),
    ((2, 9, 5, 240), (1, 3, 3, 240), 1, "narrow_co"),
    ((2, 9, 5, 64), (8, 3, 3, 64), 1, "wgmma"),
    ((2, 9, 5, 64), (7, 3, 3, 64), 1, "narrow_co")])
def test_plan_keeps_other_shapes_on_their_routes(x_shape, w_shape, stride,
                                                route):
    assert sc.plan(x_shape, w_shape, stride).route == route


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


def _pads(h, w, ks):
    return same_pads(h, ks, 1)[0], same_pads(w, ks, 1)[0]


def emulate_narrow_ci(x8, w8, how):
    """The int32 sums [B,H,W,Co] as the narrow_ci kernel forms them."""
    b, h, w, ci = x8.shape
    co, ks = w8.shape[0], w8.shape[1]
    th, tw = how.th, how.tw
    pad_t, pad_l = _pads(h, w, ks)
    ncb, nrb = -(-w // tw), -(-h // th)
    hh, hw = th + ks - 1, tw + ks - 1
    raw_row = (hw * ci + 15 + 48 + 15) // 16 * 16
    xb = x8.reshape(-1).numpy().view(np.uint8)
    cw = -(-co // 32)
    wb = np.zeros((cw * 32, ks * ks, 32), np.int64)
    wb[:co, :, :ci] = w8.reshape(co, ks * ks, ci).numpy()
    acc = np.zeros((b, h, w, co), np.int64)
    rng = np.random.default_rng(1)
    for t in range(b * nrb * ncb):
        ow0, oh0, bb = (t % ncb) * tw, (t // ncb % nrb) * th, t // ncb // nrb
        raw = rng.integers(0, 256, (hh, raw_row), dtype=np.uint8)  # stale
        los = []
        for hr in range(hh):  # load_raw / raw_span
            ih = oh0 - pad_t + hr
            c0, c1 = max(ow0 - pad_l, 0), min(ow0 - pad_l + hw, w)
            los.append(0)
            if ih < 0 or ih >= h or c0 >= c1:
                continue
            row = (bb * h + ih) * w
            lo = ((row + c0) * ci) & ~15
            n = ((row + c1) * ci - lo + 15) >> 4
            assert 16 * n + 48 <= raw_row
            for q in range(n):
                got = xb[lo + 16 * q:min(lo + 16 * q + 16, xb.size)]
                raw[hr, 16 * q:16 * q + 16] = 0
                raw[hr, 16 * q:16 * q + got.size] = got
            los[hr] = lo
        halo = np.zeros(hh * hw * 32, np.uint8)
        for i in range(hh * hw):  # expand
            hr, hc = divmod(i, hw)
            ih, iw = oh0 - pad_t + hr, ow0 - pad_l + hc
            v = [0] * 8
            if 0 <= ih < h and 0 <= iw < w:
                off = ((bb * h + ih) * w + iw) * ci - los[hr]
                words = raw[hr].view("<u4").astype(np.uint64)
                sh = (off & 3) * 8
                for k in range(8):
                    wd = int(((words[off // 4 + k + 1] << np.uint64(32))
                              | words[off // 4 + k]) >> np.uint64(sh))
                    nb = ci - 4 * k
                    v[k] = (wd & 0xFFFFFFFF if nb >= 4 else 0 if nb <= 0
                            else wd & ((1 << (8 * nb)) - 1))
            half = np.array(v, "<u4").view(np.uint8)
            swap = (hc >> 2) & 1
            base = i * 32
            halo[base + 16 * swap:base + 16 * swap + 16] = half[:16]
            halo[base + 16 * (1 - swap):base + 16 * (1 - swap) + 16] = \
                half[16:]
        for mt in range(th * (tw // 16)):  # compute, ldmatrix addresses
            r, c0 = divmod(mt, tw // 16)
            c0 *= 16
            if oh0 + r >= h or ow0 + c0 >= w:
                continue
            part = np.zeros((16, cw * 32), np.int64)
            for tap in range(ks * ks):
                hc = c0 + np.arange(16) + tap % ks
                hrow = r + tap // ks
                a = np.zeros((16, 32), np.int64)
                for hf in range(2):
                    addr = (hrow * hw + hc) * 32 + ((hf ^ ((hc >> 2) & 1))
                                                     << 4)
                    idx = addr[:, None] + np.arange(16)
                    a[:, 16 * hf:16 * hf + 16] = halo[idx].view(np.int8)
                part += a @ wb[:, tap, :].T
            nv = min(16, w - ow0 - c0)
            acc[bb, oh0 + r, ow0 + c0:ow0 + c0 + nv] = part[:nv, :co]
    return torch.from_numpy(acc).to(torch.int32)


def _regs(x, gid, tig):
    """An m16n8 int32 tile's accumulator registers of lane (gid, tig)."""
    return [x[gid, 2 * tig], x[gid, 2 * tig + 1], x[gid + 8, 2 * tig],
            x[gid + 8, 2 * tig + 1]]


def shifted(x, xn, s):
    """narrow_co's `shifted<S>`: each lane's registers taken by shuffle
    from lane gid + S (mod 8) of x and xn -> the tile of rows g + S."""
    y = np.zeros_like(x)
    for gid in range(8):
        for tig in range(4):
            src = ((gid * 4 + tig) + 4 * s) & 31
            a = _regs(x, src >> 2, src & 3)
            n = _regs(xn, src >> 2, src & 3)
            wrap = gid + s >= 8
            out = ([a[2], a[3], n[0], n[1]] if wrap else a)
            y[gid, 2 * tig], y[gid, 2 * tig + 1] = out[0], out[1]
            y[gid + 8, 2 * tig], y[gid + 8, 2 * tig + 1] = out[2], out[3]
    return y


def emulate_narrow_co(x8, w8, how):
    """The int32 sums [B,H,W,Co] as the narrow_co kernel forms them."""
    b, h, w, ci = x8.shape
    co, ks = w8.shape[0], w8.shape[1]
    th, tw = how.th, how.tw
    pad_t, pad_l = _pads(h, w, ks)
    ncb, nrb = -(-w // tw), -(-h // th)
    kst, hw = -(-ci // 32), tw + ks - 1
    pitch = ci if (ci // 16) % 2 else ci + 16
    n_win = (tw + ks - 1 + 15) >> 4
    xn = x8.numpy()
    wb = np.zeros((8, ks * ks, kst * 32), np.int64)
    wb[:co, :, :ci] = w8.reshape(co, ks * ks, ci).numpy()
    acc = np.zeros((b, h, w, co), np.int64)
    rng = np.random.default_rng(2)
    for t in range(b * nrb * ncb):
        ow0, oh0, bb = (t % ncb) * tw, (t // ncb % nrb) * th, t // ncb // nrb
        rows = []
        for i in range(min(th, h - oh0) + ks - 1):  # load_row
            ih = oh0 - pad_t + i
            buf = rng.integers(-128, 128, n_win * 16 * pitch + 32,
                               dtype=np.int64)  # garbage past the pixels
            for hc in range(hw):
                iw = ow0 - pad_l + hc
                ok = 0 <= ih < h and 0 <= iw < w
                buf[hc * pitch:hc * pitch + ci] = xn[bb, ih, iw] if ok else 0
            rows.append(buf)
        for j in range(min(th, h - oh0)):
            part = np.zeros((8, tw, 8), np.int64)
            for warp in range(8):
                d = np.zeros((n_win, ks, 16, 8), np.int64)
                if warp < kst:  # warp w takes k32 chunk w (kst <= 8)
                    for kr in range(ks):
                        buf = rows[j + kr]
                        for m in range(n_win):
                            px = 16 * m + np.arange(16)
                            idx = (px * pitch + warp * 32)[:, None] + \
                                np.arange(32)
                            a = buf[idx]
                            for kc in range(ks):
                                d[m, kc] += a @ wb[:, kr * ks + kc,
                                                   warp * 32:
                                                   warp * 32 + 32].T
                for m in range(tw // 16):
                    o = d[m, 0].copy()
                    if ks == 3:
                        o += shifted(d[m, 1], d[m + 1, 1], 1)
                        o += shifted(d[m, 2], d[m + 1, 2], 2)
                    part[warp, 16 * m:16 * m + 16] = o
            nv = min(tw, w - ow0)
            acc[bb, oh0 + j, ow0:ow0 + nv] = part.sum(0)[:nv, :co]
    return torch.from_numpy(acc).to(torch.int32)


def _case(seed, b, h, w, ci, co, k):
    g = torch.Generator().manual_seed(seed)
    x8 = torch.randint(-127, 128, (b, h, w, ci), generator=g,
                       dtype=torch.int8)
    w8 = torch.randint(-127, 128, (co, k, k, ci), generator=g,
                       dtype=torch.int8)
    return x8, w8


@pytest.mark.parametrize("b,h,w,ci,co,k", [
    (2, 5, 70, 18, 128, 3),   # two column tiles, the second ragged
    (3, 7, 9, 3, 40, 3),      # tw 16 > W; Co past a warp's 32
    (1, 3, 20, 32, 200, 3),   # Co > 128: 64-pixel tiles
    (2, 4, 17, 5, 8, 1),      # 1x1, odd Ci: raw spans off 16 bytes
    (2, 6, 33, 18, 16, 3)])
def test_emulated_narrow_ci_equals_the_plain_sums(b, h, w, ci, co, k):
    x8, w8 = _case(ci * 7 + co, b, h, w, ci, co, k)
    how = sc.plan(x8.shape, w8.shape, 1)
    assert how.route == "narrow_ci"
    assert torch.equal(emulate_narrow_ci(x8, w8, how),
                       sc.conv_acc_plain(x8, w8, 1))


@pytest.mark.parametrize("b,h,w,ci,co,k", [
    (2, 5, 70, 256, 3, 3),    # to_rgb's channels; a ragged second strip
    (3, 6, 9, 48, 7, 3),      # Ci % 32 == 16: the last chunk reads past
    (1, 4, 20, 240, 5, 3),    # Ci % 32 == 16 with every warp busy
    (2, 5, 33, 16, 1, 1),     # 1x1
    (2, 9, 17, 64, 2, 3)])
def test_emulated_narrow_co_equals_the_plain_sums(b, h, w, ci, co, k):
    x8, w8 = _case(ci * 7 + co, b, h, w, ci, co, k)
    how = sc.plan(x8.shape, w8.shape, 1)
    assert how.route == "narrow_co"
    assert torch.equal(emulate_narrow_co(x8, w8, how),
                       sc.conv_acc_plain(x8, w8, 1))


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
