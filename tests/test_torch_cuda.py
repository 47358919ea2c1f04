"""The CUDA pose rasterizer on the card: bit-equal to its plain version
over shapes, radii and coordinate edges beyond the Market shape that
chip_smoke.py checks (rows whose W*K is not a multiple of 4, which the
kernel stores in scalar heads and tails; every keypoint offset around a
small image at radius 0-12; NaN and huge coordinates); one counted launch
per call; no route from a CUDA tensor to the plain version; bad inputs
refused before launch. And the model-12 tester on the card runs float32
with PyTorch's TF32 flags on. Training: one small-config train step on the
card against the CPU (both D-step variants), the optimizers on identical
gradients, and BatchNorm's running-statistic updates; the DCGAN D's
convs on PyTorch's own kernels, not cuDNN's, and [train parity]'s step
ten times on each side against float64. Stage II: one
model-3 and one model-4 step on the card against the CPU, the pose kernel
on a model-4 preview, and the step noise in one copy. The s8 conv
bit-equal to its plain version over kernel sizes, strides, odd sizes,
channel tails (Ci = 18, Co = 3), every residual and output kind, on the
route `plan` picks; the wgmma route (`csrc/s8_conv_sm90.cu`) also against
the mma_sync kernel (`csrc/s8_conv.cu`) over Ci 64-768, ragged M and N,
stride 2 on odd sizes, ROI crops, split-K on and off, on a side stream and
in a replayed CUDA graph, with its launches counted per route; the narrow
routes (`csrc/s8_conv_narrow_ci.cu`: Ci 3-32, Co 8-256;
`csrc/s8_conv_narrow_co.cu`: Co 1-7, Ci 16-256) the same way, over ragged
B, H and W (W below the tile too); refused inputs and routes; the int8
testers (models 12 and 11) and the bfloat16 tester on the card against
the CPU. The DeepFashion family: a model-101 step (the
single-branch encoder at the small config) and a model-103 step on the
card against the CPU, and models 1001 and 1002 at 256x256 (narrow) in
float32 and int8. The scoring protocol on the card against the CPU; the
s8 conv on every call of one Market int8 gate batch of 64; the int8
gate's check on the card against the CPU. The modules no CLI path
reaches: `WGANResidualBlock` (each resample), `SubpixelConv`,
`LayerNorm` and SSIM / MS-SSIM card against CPU, and the WGAN-GP
critic step of the 'wgan-gp' DCGAN D, whose double backward stays off
cuDNN (bit-equal to the step with cuDNN off).

Marked `cuda` and skipped without a card. On a machine with one (JAX is not
needed there, hence no conftest):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import contextlib
import copy

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.apps.testers import (ConditionalTransferTester,
                                         FactorSamplingTester,
                                         FullSamplingTester,
                                         InterpolationTester)
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.data.synthetic import SyntheticLoader
from dpig_tpu_torch.kernels import pose_raster
from dpig_tpu_torch.ops import pose
from dpig_tpu_torch.train.parity import recorded_train_step, step_errors

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rcv(seed, b, h, w, k, normalized):
    """Random keypoints plus the edges of both coordinate rules: exact
    integers, the image border, just outside it, negative fractions (which
    truncate to 0), a normalized coordinate that lands on exactly H - 1 or
    W - 1, NaN (converted to 0, as XLA does) and +-3e9 (saturated), and
    invisible ones."""
    rng = np.random.default_rng(seed)
    if normalized:
        r = rng.uniform(-1.3, 1.3, (b, k))
        c = rng.uniform(-1.3, 1.3, (b, k))
        edges_r = [-1.0, 1.0, 0.0, -0.999, 0.999, 1.5, 1 - 2 / h,
                   np.nan, 0.3, 3e9, -3e9, 0.1, 0.2]
        edges_c = [1.0, -1.0, 0.5, 0.999, -0.999, -1.5, 1 - 2 / w,
                   0.3, np.nan, 0.1, 0.2, 3e9, -3e9]
    else:
        r = rng.uniform(-10, h + 10, (b, k))
        c = rng.uniform(-10, w + 10, (b, k))
        edges_r = [0.0, h - 1, h, -0.5, h - 0.5, 3.0,
                   np.nan, 3.0, 3e9, -3e9, 2.0, 2.0]
        edges_c = [w - 1, 0.0, -0.5, w, w - 0.01, 2.0,
                   5.0, np.nan, 2.0, 2.0, 3e9, -3e9]
    n = min(k, len(edges_r))
    r[0, :n], c[0, :n] = edges_r[:n], edges_c[:n]
    v = (rng.uniform(size=(b, k)) > 0.25).astype(np.float64)
    v[0, :n] = 1.0
    return np.stack([r, c, v], -1).astype(np.float32).reshape(b, k * 3)


# W*K mod 4: 0 (Market, 256x256, 128x64x7, 32x16x18), 1 (20x9x1, 13x5,
# 1x1), 2 (23x18, 1x2, 3x130 with K above the block's 128 threads), 3 (7x9,
# 1x3: a row shorter than one float4).
@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("b,h,w,k,radius", [
    (16, 128, 64, 18, 4), (16, 256, 256, 18, 4), (3, 37, 23, 18, 4),
    (2, 32, 16, 18, 0), (1, 20, 9, 1, 9), (5, 128, 64, 7, 2),
    (1, 9, 13, 5, 12), (2, 5, 1, 1, 3), (2, 6, 1, 2, 2), (2, 11, 3, 130, 5),
    (2, 7, 7, 9, 3), (3, 6, 1, 3, 2)])
def test_kernel_bit_equal_to_plain(card, b, h, w, k, radius, normalized):
    rcv = torch.from_numpy(_rcv(b * h + k, b, h, w, k, normalized)).to(card)
    before = pose_raster.launches
    out = pose.render_pose_maps(rcv, h, w, k, radius, normalized)
    torch.cuda.synchronize()
    assert pose_raster.launches == before + 1
    ref = pose.render_pose_maps_plain(rcv, h, w, k, radius, normalized)
    assert out.shape == (b, h, w, k) and out.dtype == torch.float32
    assert torch.equal(out, ref)
    # the same on the CPU: the plain version is device-independent
    assert torch.equal(out.cpu(), pose.render_pose_maps(rcv.cpu(), h, w, k,
                                                        radius, normalized))


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("radius", range(13))
def test_kernel_radius_and_offset_sweep(card, radius, normalized):
    """Sample b holds keypoint k at pixel (b - 2, k - 2): every row and
    column offset of a 9x6 image, its borders and two pixels beyond."""
    h, w = 9, 6
    rr, cc = np.meshgrid(np.arange(-2, h + 2), np.arange(-2, w + 2),
                         indexing="ij")
    b, k = rr.shape
    rcv = torch.from_numpy(
        np.stack([rr, cc, np.ones_like(rr)], -1).astype(np.float32))
    if normalized:
        rcv = pose.pose_rcv_normalize(rcv, h, w)
    rcv = rcv.reshape(b, k * 3).to(card)
    out = pose.render_pose_maps(rcv, h, w, k, radius, normalized)
    assert torch.equal(out, pose.render_pose_maps_plain(rcv, h, w, k, radius,
                                                        normalized))
    assert (out > 0).any()


def test_cuda_tensor_never_reaches_the_plain_version(card, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain rasterizer ran on a CUDA tensor")

    monkeypatch.setattr(pose, "render_pose_maps_plain", refuse)
    rcv = torch.from_numpy(_rcv(0, 2, 32, 16, 18, False)).to(card)
    before = pose_raster.launches
    pose.render_pose_maps(rcv, 32, 16)
    pose.render_pose_points(rcv.reshape(2, 18, 3) / 40.0, 32, 16)
    assert pose_raster.launches == before + 2


def test_non_contiguous_rcv_gives_the_same_maps_on_card_and_cpu(card):
    rcv = torch.from_numpy(_rcv(3, 4, 32, 16, 18, False)).reshape(4, 18, 3)
    strided = rcv.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    before = pose_raster.launches
    out = pose.render_pose_maps(strided.to(card), 32, 16)
    assert pose_raster.launches == before + 1
    assert torch.equal(out.cpu(), pose.render_pose_maps(strided, 32, 16))


def test_tester_with_tf32_on_matches_the_cpu(card, tmp_path):
    """PyTorch's TF32 flags on when the tester is built and run: the card
    still computes float32, and the flags are the caller's again after."""
    small = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16,
                 z_num=16)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        t = ConditionalTransferTester(
            Config(platform="", model_dir=str(tmp_path), **small))
        s1 = t.stage1
        state = {"Encoder": s1.encoder.state_dict(),
                 "ID_AE": s1.generator.state_dict(),
                 "Discriminator": s1.disc.state_dict(),
                 "Discriminator_stats": {}}
        c = ConditionalTransferTester(
            Config(platform="cpu", model_dir=str(tmp_path), **small),
            params={k: {n: v.cpu() for n, v in d.items()}
                    for k, d in state.items()})
        batch = next(SyntheticLoader(4, 32, 16, seed=3))
        g, pose_t, score = t.transfer_step(batch_to_device(batch, t.device))
        g_c, pose_c, score_c = c.transfer_step(batch_to_device(batch, c.device))
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32 = matmul.allow_tf32 = False
    assert torch.equal(pose_t.cpu(), pose_c)
    # the CPU parity tests' bounds: 1e-4 on g_raw (2e-2 on [0,255])
    assert float((g.cpu() - g_c).abs().max()) <= 2e-2
    assert float((score.cpu() - score_c).abs().max()) <= 1e-4


SMALL = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16)


# The G step's losses and gradients come before any update. The card's D
# step starts from the CPU's updated G (`recorded_train_step(g_updated=)`),
# since the first Adam step is sign-like and would carry its noise into
# the fakes. Readings on an NVIDIA H100 80GB HBM3 (700 W), fast_gan_step
# False/True: G-step losses 6.9e-7, d_loss 1.4e-7/3.7e-7, Encoder 4.7e-5,
# ID_AE 1.7e-6, Discriminator 3.1e-6/3.0e-6, d_stats 3.0e-7; with TF32 in
# the backward passes (the control below): Encoder 5.7e-4, ID_AE 2.8e-4,
# Discriminator 4.1e-4. The gradient limits sit between the two, at least
# 3x from each reading.
STEP_TOL = {"g_step_losses": 1e-5, "d_loss": 1e-5, "Encoder": 1.5e-4,
            "ID_AE": 3e-5, "Discriminator": 3e-5, "d_stats": 1e-5}


def _cpu_and_card_steps(card, tmp_path, step_fn=None, fast=False,
                        fg_bg=True):
    """One small-config train step of the same weights on the CPU and, with
    PyTorch's TF32 flags on, on the card -> (errors, CPU record, card
    record); the card's pose-kernel launches are checked to be one.
    `fg_bg=False`: model 101's single-branch encoder."""
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    batch = next(SyntheticLoader(4, 32, 16, seed=3))
    cfgs = [Config(platform=p, model_dir=str(tmp_path), fast_gan_step=fast,
                   **SMALL) for p in ("", "cpu")]
    cpu = recorded_train_step(Stage1App(cfgs[1], torch.device("cpu"),
                                        fg_bg=fg_bg), batch)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        before = pose_raster.launches
        gpu = recorded_train_step(Stage1App(cfgs[0], card, fg_bg=fg_bg),
                                  batch, step_fn, g_updated=cpu.g_updated)
        assert pose_raster.launches == before + 1
    finally:
        cudnn.allow_tf32 = matmul.allow_tf32 = False
    return step_errors(cpu, gpu), cpu, gpu


@pytest.mark.parametrize("fast", [False, True])
def test_train_step_on_the_card_matches_the_cpu(card, tmp_path, fast):
    """The same weights and batch through one train step on the card (with
    PyTorch's TF32 flags on: the step runs float32 whatever they say) and
    on the CPU, within STEP_TOL; the same step count; the pose kernel
    launched once."""
    errs, cpu, gpu = _cpu_and_card_steps(card, tmp_path, fast=fast)
    print(f"card vs CPU, fast_gan_step={fast}: {errs}")
    assert all(errs[k] <= t for k, t in STEP_TOL.items()), errs
    assert gpu.state.step == cpu.state.step == 1


def test_model101_train_step_on_the_card_matches_the_cpu(card, tmp_path):
    """Model 101 at the small config (the single-branch encoder at Market
    depths): card vs CPU within STEP_TOL."""
    errs, cpu, gpu = _cpu_and_card_steps(card, tmp_path, fg_bg=False)
    print(f"model 101, card vs CPU: {errs}")
    assert all(errs[k] <= t for k, t in STEP_TOL.items()), errs


def test_a_tf32_backward_exceeds_the_step_tolerance(card, tmp_path):
    """Control: the step with only its forwards under the float32 guard
    (the backward passes and updates outside it) and TF32 on must exceed
    STEP_TOL on the G and D gradients, so the test above can see TF32 in
    the backward passes of both steps."""
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    errs, _, _ = _cpu_and_card_steps(card, tmp_path,
                                     Stage1App.train_step.__wrapped__)
    print(f"card (TF32 in the backward) vs CPU: {errs}")
    assert errs["Encoder"] > STEP_TOL["Encoder"], errs
    assert errs["ID_AE"] > STEP_TOL["ID_AE"], errs
    assert errs["Discriminator"] > STEP_TOL["Discriminator"], errs


@pytest.mark.parametrize("mode", ["dcgan", "wgan-gp", "wgan"])
def test_optimizer_on_the_card_matches_the_cpu(card, mode):
    """Three updates on identical gradients, the LR halving at 2: params
    and moments within float32 rounding (rtol 1e-6)."""
    from dpig_tpu_torch.train.state import make_optimizer
    rng = np.random.default_rng(4)
    shapes = {"a": (64, 3, 5, 5), "b": (17,), "c": (300, 7)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    sides = []
    for dev in (card, torch.device("cpu")):
        params = {k: torch.from_numpy(v).to(dev) for k, v in init.items()}
        sides.append((params, make_optimizer(mode, params, 1e-3, 2)))
    for _ in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) * 1e-3
                 for s in shapes.values()]
        for params, opt in sides:
            dev = next(iter(params.values())).device
            opt.step([torch.from_numpy(g).to(dev) for g in grads])
    (gp, gopt), (cp, copt) = sides
    for k in shapes:
        torch.testing.assert_close(gp[k].cpu(), cp[k], rtol=1e-6, atol=1e-7)
        for m in copt.moments:
            torch.testing.assert_close(gopt.moments[m][k].cpu(),
                                       copt.moments[m][k], rtol=1e-6,
                                       atol=1e-12)


def test_batchnorm_stat_updates_on_the_card(card):
    """Chained updating passes move the running statistics as on the CPU
    (biased variance, momentum 0.9; atol 1e-6), a non-updating pass
    leaves them alone."""
    from dpig_tpu_torch.models.layers import BatchNorm
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.normal(m, s, (16, 128, 8, 4)).astype(
        np.float32)) for m, s in ((0.5, 2), (-1, 1))]
    bns = []
    for dev in (card, torch.device("cpu")):
        bn = BatchNorm(128).to(dev)
        with torch.no_grad():
            bn.weight.fill_(1.0)
            bn.bias.zero_()
        for x in xs:
            bn(x.to(dev), train=True, update_stats=True)
        bns.append(bn)
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(bns[0], name).cpu(),
                                   getattr(bns[1], name), rtol=0, atol=1e-6)
    before = bns[0].running_var.clone()
    bns[0](xs[0].to(card), train=True)
    assert torch.equal(bns[0].running_var, before)


# ------------------------------------- the DCGAN D's convs off cuDNN
def test_dcgan_d_convs_run_without_cudnn_forward_and_backward(
        card, monkeypatch):
    """The DCGAN D's float32 convs on the card run PyTorch's own kernels
    (im2col + cuBLAS), forward and backward, not cuDNN's: the same
    numbers, bit for bit, as the whole conv run with cuDNN off, and every
    conv of a D forward and backward goes through `_NativeConv2d` (its
    forward and backward each inside `torch.backends.cudnn.flags(enabled=
    False)`, cuDNN read off there). No profiler here: a
    profiling session in this process left a later test's session
    empty."""
    from dpig_tpu_torch.models import layers
    from dpig_tpu_torch.models.discriminators import DCGANDiscriminator
    from dpig_tpu_torch.models.layers import conv2d_same, init_weights
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 64, 64, 32, generator=g).to(card)
    w = (torch.randn(128, 64, 5, 5, generator=g) * 0.02).to(card)
    b = torch.randn(128, generator=g).to(card)
    outs = []
    for route in ("native", "flags"):
        xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
        if route == "native":
            y = conv2d_same(xs, ws, bs, 2, cudnn=False)
            grads = torch.autograd.grad((y * y).sum(), (xs, ws, bs))
        else:
            with torch.backends.cudnn.flags(enabled=False):
                y = conv2d_same(xs, ws, bs, 2)
                grads = torch.autograd.grad((y * y).sum(), (xs, ws, bs))
        outs.append((y, *grads))
    for a, c in zip(*outs):
        assert torch.equal(a, c)
    assert torch.backends.cudnn.enabled
    calls = []
    fn = layers._NativeConv2d
    fwd, bwd = fn.forward, fn.backward

    def counted(tag, f):
        def run(ctx, *args):
            calls.append((tag, torch.backends.cudnn.enabled))
            return f(ctx, *args)
        return staticmethod(run)

    real_flags = torch.backends.cudnn.flags

    @contextlib.contextmanager
    def recorded_flags(*args, **kw):
        with real_flags(*args, **kw):
            calls.append(("cudnn off", torch.backends.cudnn.enabled))
            yield
    monkeypatch.setattr(fn, "forward", counted("forward", fwd))
    monkeypatch.setattr(fn, "backward", counted("backward", bwd))
    monkeypatch.setattr(torch.backends.cudnn, "flags", recorded_flags)
    d = DCGANDiscriminator(128, 64)
    init_weights(d, torch.Generator().manual_seed(4))
    d = d.to(card)
    img = torch.randn(2, 128, 64, 3, generator=g).to(card)
    torch.autograd.grad(d(img, update_stats=True).sum(), list(d.parameters()))
    assert [t for t, _ in calls].count("forward") == d.n_stages
    assert [t for t, _ in calls].count("backward") == d.n_stages
    assert calls.count(("cudnn off", False)) == 2 * d.n_stages
    assert torch.backends.cudnn.enabled


def test_train_parity_steps_hold_the_d_gradient_to_float64(card, tmp_path):
    """[train parity]'s steps (chip_smoke.py phase 7: batch 2 at full
    Market width), ten times on the CPU and ten on the card, fresh state
    each, the G after the update set to the first CPU step's: every D
    gradient within 1e-4 (||diff|| / ||grad||) of the CPU's float64 step
    from that G. Before the DCGAN D's convs left cuDNN, the card's read
    9.736e-3 in some of these (cuDNN's float32 backward of `Conv_1`
    wrong, so `Conv_0`'s weight and bias gradients 1.4e-2 off), the CPU's
    2.9e-6 always."""
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.train.parity import to_float64
    cfgs = {p: Config(platform=p, batch_size=2, model_dir=str(tmp_path))
            for p in ("", "cpu")}
    batch = next(SyntheticLoader(2, 128, 64, seed=99))
    cpu = torch.device("cpu")
    first = recorded_train_step(Stage1App(cfgs["cpu"], cpu), batch)
    wide = recorded_train_step(to_float64(Stage1App(cfgs["cpu"], cpu)),
                               batch, g_updated=first.g_updated)
    errs = {"cpu": [], "card": []}
    for side, dev in (("cpu", cpu), ("card", card)):
        for _ in range(10):
            rec = recorded_train_step(Stage1App(cfgs["cpu" if side == "cpu"
                                                     else ""], dev),
                                      batch, g_updated=first.g_updated)
            errs[side].append(step_errors(wide, rec)["Discriminator"])
    print(f"D gradient against float64: {errs}")
    assert max(errs["cpu"] + errs["card"]) <= 1e-4, errs


def test_kernel_on_a_side_stream(card):
    rcv = torch.from_numpy(_rcv(1, 4, 64, 32, 18, False)).to(card)
    ref = pose.render_pose_maps_plain(rcv, 64, 32)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = pose_raster.render_pose_maps_cuda(rcv, 64, 32)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(out, ref)


def test_wrapper_refuses_bad_inputs(card):
    rcv = torch.from_numpy(_rcv(2, 2, 32, 16, 18, False)).to(card)
    before = pose_raster.launches
    with pytest.raises(TypeError, match="float32"):
        pose_raster.render_pose_maps_cuda(rcv.double(), 32, 16)
    with pytest.raises(ValueError, match="shape"):
        pose_raster.render_pose_maps_cuda(rcv[:, :-3], 32, 16)
    with pytest.raises(ValueError, match="contiguous"):
        pose_raster.render_pose_maps_cuda(
            rcv.reshape(2, 18, 3).transpose(0, 1).contiguous().transpose(0, 1),
            32, 16)
    with pytest.raises(ValueError, match="radius"):
        pose_raster.render_pose_maps_cuda(rcv, 32, 16, radius=-1)
    with pytest.raises(ValueError, match="radius"):
        pose_raster.render_pose_maps_cuda(rcv, 32, 16, radius=46341)
    with pytest.raises(ValueError, match="under 2"):  # (H-1)^2 + (W-1)^2
        pose_raster.render_pose_maps_cuda(rcv[:1, :3], 40000, 40000, 1)
    many = pose_raster.MAX_KEYPOINTS + 1
    with pytest.raises(ValueError, match="at most"):
        pose_raster.render_pose_maps_cuda(
            torch.zeros(1, many * 3, device=card), 2, 2, many)
    assert pose_raster.launches == before


def test_empty_output_launches_nothing(card):
    before = pose_raster.launches
    out = pose_raster.render_pose_maps_cuda(
        torch.zeros(0, 18 * 3, device=card), 32, 16)
    assert out.shape == (0, 32, 16, 18) and pose_raster.launches == before


# The CPU's decoded keypoints for these seeds lie at least FLOOR_MARGIN px
# from a floor boundary (checked below), so the maps cannot differ by luck.
FLOOR_MARGIN = 1e-3
BATCH_SEED, NOISE_SEED = 3, 1


def _twins(card, tmp_path, cls, **flags):
    """A cold-start tester on the card, its CPU twin with the same weights,
    a batch and noise; then PyTorch's TF32 flags on (`tf32_on` turns them
    off after the test)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    t = cls(Config(platform="", model_dir=str(tmp_path), **SMALL, **flags))
    c = cls(Config(platform="cpu", model_dir=str(tmp_path), **SMALL,
                   **flags), params=t.cpu_state())
    batch = next(SyntheticLoader(4, 32, 16, seed=BATCH_SEED))
    noise = c.draw_noise(torch.Generator().manual_seed(NOISE_SEED), 4)
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    return t, c, batch, noise


@pytest.fixture
def tf32_on(card):
    yield
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("pose_source", ["real", "reconstructed", "sampled"])
@pytest.mark.parametrize("sample_app", [False, True])
def test_full_sampling_step_on_the_card_matches_the_cpu(
        card, tf32_on, tmp_path, pose_source, sample_app):
    """The same weights and noise, TF32 flags on: g within 2e-2 on [0,255]
    and the score within 1e-4 (the model-12 bounds), the rcv within 1e-5,
    the pose maps and the decoded visibility bit-equal."""
    t, c, batch, noise = _twins(card, tmp_path, FullSamplingTester,
                                sample_app=sample_app)
    before = pose_raster.launches
    g, maps, score, rcv = t.sample_step(
        batch_to_device(batch, card), {k: v.to(card) for k, v in
                                       noise.items()}, pose_source)
    assert pose_raster.launches == before + 1
    g_c, maps_c, score_c, rcv_c = c.sample_step(
        batch_to_device(batch, c.device), noise, pose_source)
    if pose_source != "real":
        assert pose.floor_margin(rcv_c, 32, 16) >= FLOOR_MARGIN
        assert torch.equal(rcv[..., 2].cpu(), rcv_c[..., 2])
    assert torch.equal(maps.cpu(), maps_c)
    assert float((rcv.cpu() - rcv_c).abs().max()) <= 1e-5
    assert float((g.cpu() - g_c).abs().max()) <= 2e-2
    assert float((score.cpu() - score_c).abs().max()) <= 1e-4


def test_factor_and_interpolation_on_the_card_match_the_cpu(card, tf32_on,
                                                            tmp_path):
    t, c, batch, noise = _twins(card, tmp_path, FactorSamplingTester,
                                sample_fg=True, sample_pose=True)
    g, maps, score = t.sample_step(batch_to_device(batch, card),
                                   {k: v.to(card) for k, v in noise.items()})
    g_c, maps_c, score_c = c.sample_step(batch_to_device(batch, c.device),
                                         noise)
    assert torch.equal(maps.cpu(), maps_c)
    assert float((g.cpu() - g_c).abs().max()) <= 2e-2
    assert float((score.cpu() - score_c).abs().max()) <= 1e-4

    t, c, batch, _ = _twins(card, tmp_path, InterpolationTester,
                            interpolate_pose=True)
    embs, z = c._embed(batch_to_device(batch, c.device))
    embs_t, z_t = t._embed(batch_to_device(batch, card))
    assert float((embs_t.cpu() - embs).abs().max()) <= 1e-4
    assert float((z_t.cpu() - z).abs().max()) <= 1e-5
    assert pose.floor_margin(c.pose_ae.decode_rcv(z), 32, 16) >= FLOOR_MARGIN
    g = t._decode(embs.to(card), z.to(card))
    assert float((g.cpu() - c._decode(embs, z)).abs().max()) <= 2e-2


def test_sampling_launch_counts(card, tmp_path):
    """run(): 3 launches per model-11 batch (the step's pose, the `pose`
    and `pose_target` trees) in every pose_source, 1 per model-13 batch,
    1 for an interpolation; the ROI encoder never runs with sample_app."""
    loader = SyntheticLoader(4, 32, 16, seed=1)
    cfg = Config(platform="", model_dir=str(tmp_path), sample_app=True,
                 **SMALL)
    t = FullSamplingTester(cfg)
    calls = []
    t.stage1.encoder.register_forward_hook(lambda *_: calls.append(1))
    for source in ("real", "reconstructed", "sampled"):
        pose_raster.launches = 0
        t.run(loader, test_batch_num=2, pose_source=source)
        assert pose_raster.launches == 6, source
    assert not calls
    for cls, flags, expected in (
            (FactorSamplingTester, {"sample_bg": True}, 2),
            (FactorSamplingTester, {"sample_pose": True}, 2),
            (InterpolationTester, {"interpolate_pose": True}, 1)):
        t = cls(Config(platform="", model_dir=str(tmp_path), **SMALL,
                       **flags))
        pose_raster.launches = 0
        if cls is InterpolationTester:
            t.run(loader, n_steps=8)
        else:
            t.run(loader, test_batch_num=2)
        assert pose_raster.launches == expected, (cls, flags)


def test_kernel_on_decoded_rcv_matches_plain(card, tmp_path):
    """The pose AE's decoded normalized rcv (the 'sampled' source at the
    Market shape), rendered by the kernel at radius 4 and at the preview's
    radius 0, bit-equal to the plain version on the same tensor."""
    t = FullSamplingTester(Config(platform="", model_dir=str(tmp_path),
                                  conv_hidden_num=16, z_num=16))
    noise = t.draw_noise(torch.Generator().manual_seed(NOISE_SEED), 16)
    with torch.inference_mode():
        rcv = t.pose_ae.decode_rcv(t._pose_z({}, noise["pose"], "sampled"))
        _, preview = t.pose_ae.decode_pose(t._pose_z({}, noise["pose"],
                                                     "sampled"))
    assert rcv.is_cuda and rcv.shape == (16, 18, 3)
    for radius in (4, 0):
        out = pose.render_pose_maps(rcv, 128, 64, 18, radius, True)
        assert torch.equal(out, pose.render_pose_maps_plain(rcv, 128, 64, 18,
                                                            radius, True))
    assert torch.equal(preview, pose.render_pose_maps_plain(rcv, 128, 64, 18,
                                                            0, True))


# Card vs CPU limit on every error of one small-config Stage-II step (keys
# of `step_errors`), the card's critic iterations started where the CPU's
# were; TF32 flags on (the step runs float32 whatever they say). Readings
# on an NVIDIA H100 80GB HBM3 (700 W): at most 6.0e-7 (model 3) and 5.4e-7
# (model 4); chip_smoke.py's full-width control past the float32 guard
# reads at least 8.0e-5.
STAGE2_STEP_TOL = 1e-5


@pytest.mark.parametrize("model", [3, 4, 103])
def test_stage2_step_on_the_card_matches_the_cpu(card, tf32_on, tmp_path,
                                                 model):
    """One `fresh` step of the same weights, batches and noise: the ROI
    encoder runs 6 times on the card for models 3 and 103 (0 for model
    4), the pose kernel never, every critic parameter ends within
    +-0.01."""
    from dpig_tpu_torch.apps.stage2_app import Stage2AppApp
    from dpig_tpu_torch.apps.stage2_app_single import Stage2AppSingleApp
    from dpig_tpu_torch.apps.stage2_pose import Stage2PoseApp
    cls = {3: Stage2AppApp, 4: Stage2PoseApp, 103: Stage2AppSingleApp}[model]
    loader = SyntheticLoader(4, 32, 16, seed=BATCH_SEED)
    host = tuple(next(loader) for _ in range(6))
    cpu_app = cls(Config(platform="cpu", model_dir=str(tmp_path), **SMALL),
                  torch.device("cpu"))
    noise = cpu_app.step_noise(torch.Generator().manual_seed(NOISE_SEED), 4)
    ref = recorded_train_step(cpu_app, host, noise=noise)
    app = cls(Config(platform="", model_dir=str(tmp_path), **SMALL), card)
    calls = []
    app.stage1.encoder.register_forward_hook(lambda *_: calls.append(1))
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    before = pose_raster.launches
    got = recorded_train_step(app, host, noise=noise,
                              g_updated=ref.g_updated,
                              d_clipped=ref.d_clipped)
    assert pose_raster.launches == before
    assert len(calls) == (0 if model == 4 else 6)
    errs = step_errors(ref, got)
    print(f"model {model}, card vs CPU: {errs}")
    assert all(v <= STAGE2_STEP_TOL for v in errs.values()), errs
    assert all(float(p.detach().abs().max()) <= 0.01
               for p in got.state.d_params)
    assert got.state.step == 1


def test_pose_kernel_on_a_model4_preview(card, tmp_path):
    """The sampled poses of a model-4 preview, rendered by the kernel (one
    launch), bit-equal to the plain version; the preview launches once."""
    from dpig_tpu_torch.apps.stage2_pose import Stage2PoseApp
    app = Stage2PoseApp(Config(platform="", model_dir=str(tmp_path),
                               conv_hidden_num=16, z_num=16), card)
    noise = app.step_noise(torch.Generator().manual_seed(NOISE_SEED), 16)[0]
    before = pose_raster.launches
    rcv, maps = app.sample_poses(noise)
    assert pose_raster.launches == before + 1
    assert rcv.shape == (16, 18, 3) and maps.shape == (16, 128, 64, 18)
    assert torch.equal(maps, pose.render_pose_maps_plain(rcv, 128, 64, 18, 4,
                                                         True))
    batch = batch_to_device(next(SyntheticLoader(16, 128, 64, seed=1)), card)
    imgs = app.preview_step(batch, noise)
    assert pose_raster.launches == before + 2
    assert imgs.shape == (16, 128, 64, 3) and bool(torch.isfinite(imgs).all())


class _HostToCardCopies(TorchDispatchMode):
    """Every op that reads a host tensor and writes a card one:
    (op, whether the host tensor is pinned, non_blocking)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        host = [a for a in args if isinstance(a, torch.Tensor)
                and a.device.type == "cpu"]
        outs = out if isinstance(out, (tuple, list)) else [out]
        if host and any(isinstance(o, torch.Tensor) and o.is_cuda
                        for o in outs):
            non_blocking = kwargs.get("non_blocking", args[2] if func is
                                      torch.ops.aten.copy_.default
                                      and len(args) > 2 else False)
            self.seen.append((func.__name__, host[0].is_pinned(),
                              bool(non_blocking)))
        return out


def test_step_noise_is_one_copy(card, tmp_path):
    """A Stage-II step's noise (G draw and five critic draws) reaches the
    card in one host-to-device copy, from pinned memory, with the numbers
    the CPU draws from the same seed: one op moves host data to the card,
    its source pinned and the copy non-blocking, and the profiler's CUDA
    runtime records hold one `cudaMemcpyAsync`. (Its device records are
    not read: on the card's machine a short session in a process older
    than about two minutes loses them, whatever ran before; 0 of 10
    sessions kept the copy after a 120 s sleep, 10 of 10 in a fresh
    process, scripts/port_fault_probe.py profiler, ROADMAP §3.)"""
    from torch.profiler import ProfilerActivity, profile
    from dpig_tpu_torch.apps.stage2_app import Stage2AppApp
    app = Stage2AppApp(Config(platform="", model_dir=str(tmp_path), **SMALL),
                       card)
    torch.cuda.synchronize()
    copies = _HostToCardCopies()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with copies:
            noise = app.step_noise(torch.Generator().manual_seed(3), 4)
        torch.cuda.synchronize()
    assert copies.seen == [("_to_copy.default", True, True)], copies.seen
    calls = [e.name for e in prof.events() if e.name.startswith(
        ("cudaMemcpy", "cuMemcpy"))]
    assert calls == ["cudaMemcpyAsync"], calls
    want = torch.randn((24, 352), generator=torch.Generator().manual_seed(3))
    assert torch.equal(noise.cpu(), (want * 0.2).view(6, 4, 352))


# ----------------------------------------------------------- s8 conv
def _s8_case(seed, b, h, w, ci, co, k, dev):
    g = torch.Generator().manual_seed(seed)
    x8 = torch.randint(-127, 128, (b, h, w, ci), generator=g,
                       dtype=torch.int8)
    w8 = torch.randint(-127, 128, (co, k, k, ci), generator=g,
                       dtype=torch.int8)
    factor = torch.rand(co, generator=g) * 1e-3 + 1e-4
    bias = torch.randn(co, generator=g) * 0.1
    return [t.to(dev) for t in (x8, w8, factor, bias)]


@pytest.mark.parametrize("b,h,w,ci,co,k,stride", [
    (2, 7, 5, 16, 8, 1, 1), (2, 7, 5, 16, 8, 3, 1), (3, 9, 6, 32, 16, 3, 2),
    (1, 8, 4, 16, 24, 3, 2), (2, 11, 7, 18, 16, 3, 1), (2, 5, 3, 48, 3, 3, 1),
    (2, 6, 6, 18, 8, 1, 2), (2, 17, 9, 144, 130, 3, 1),
    (1, 33, 20, 64, 72, 3, 2), (2, 16, 8, 256, 128, 1, 1)])
@pytest.mark.parametrize("out", ["s8-res8", "bf16-resbf", "f32"])
def test_s8_conv_is_bit_equal_to_its_plain_version(card, b, h, w, ci, co, k,
                                                   stride, out):
    from dpig_tpu_torch.kernels import s8_conv as sc
    x8, w8, factor, bias = _s8_case(h * 31 + ci, b, h, w, ci, co, k, card)
    shape = sc.out_shape(x8, w8, stride)
    g = torch.Generator().manual_seed(co)
    kw = {}
    if out == "s8-res8":
        kw = dict(relu=True, res=torch.randint(-127, 128, shape, generator=g,
                                               dtype=torch.int8).to(card),
                  res_scale=(torch.rand(co, generator=g) * 0.05).to(card),
                  out_scale=(torch.rand(co, generator=g) * 0.2 + 0.01
                             ).to(card), out_dtype=torch.int8)
    elif out == "bf16-resbf":
        kw = dict(relu=True, res=torch.randn(shape, generator=g).to(
            torch.bfloat16).to(card), out_dtype=torch.bfloat16)
    else:
        kw = dict(out_dtype=torch.float32)
    before = sc.launches
    got = sc.s8_conv(x8, w8, factor, bias, stride, **kw)
    assert sc.launches == before + 1
    want = sc.s8_conv_plain(x8, w8, factor, bias, stride, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert int((got != want).sum()) == 0


def test_s8_conv_refuses_bad_inputs(card):
    from dpig_tpu_torch.kernels import s8_conv as sc
    x8, w8, factor, bias = _s8_case(0, 1, 6, 4, 16, 8, 3, card)
    with pytest.raises(ValueError, match="CUDA"):
        sc.s8_conv_cuda(x8.cpu(), w8.cpu(), factor, bias)
    with pytest.raises(TypeError):
        sc.s8_conv_cuda(x8.float(), w8, factor, bias)
    with pytest.raises(ValueError, match="5x5"):
        sc.s8_conv_cuda(x8, torch.zeros(8, 5, 5, 16, dtype=torch.int8,
                                        device=card), factor, bias)
    with pytest.raises(ValueError, match="contiguous"):
        sc.s8_conv_cuda(x8.transpose(1, 2), w8, factor, bias)
    with pytest.raises(ValueError, match="scale"):
        sc.s8_conv_cuda(x8, w8, factor[:3], bias)


def _s8_out_kwargs(out, shape, co, dev):
    """Epilogue arguments of one output kind: s8 with an s8 residual and
    ReLU, s8 alone without ReLU, bf16 with a bf16 or an s8 residual, f32."""
    g = torch.Generator().manual_seed(co + len(out))

    def res8():
        return dict(res=torch.randint(-127, 128, shape, generator=g,
                                      dtype=torch.int8).to(dev),
                    res_scale=(torch.rand(co, generator=g) * 0.05).to(dev))

    def out8():
        return dict(out_scale=(torch.rand(co, generator=g) * 0.2 + 0.01
                               ).to(dev), out_dtype=torch.int8)

    if out == "s8-res8-relu":
        return dict(relu=True, **res8(), **out8())
    if out == "s8":
        return out8()
    if out == "bf16-resbf-relu":
        return dict(relu=True, res=torch.randn(shape, generator=g).to(
            torch.bfloat16).to(dev), out_dtype=torch.bfloat16)
    if out == "bf16-res8":
        return dict(**res8(), out_dtype=torch.bfloat16)
    return dict(out_dtype=torch.float32)


S8_WGMMA_CASES = [  # b, h, w, ci, co, k, stride
    (2, 9, 7, 64, 72, 3, 2),        # Ci 64: two taps a stage; odd, stride 2
    (2, 7, 5, 64, 100, 3, 1),       # Co % 8 != 0: the scalar epilogue
    (2, 33, 20, 192, 136, 3, 2),    # a stage straddling two taps
    (2, 17, 9, 256, 200, 3, 1),     # N tile 256, ragged M and N
    (3, 48, 48, 128, 128, 3, 1),    # ROI crops
    (1, 12, 12, 128, 96, 1, 1),     # 1x1
    (16, 8, 4, 640, 640, 3, 1),     # the Market tail: split-K 6
    (16, 8, 4, 768, 768, 3, 1),     # split-K 11, N tile 256
    (16, 64, 64, 128, 128, 3, 1),   # 256 x 128 tiles
    (5, 91, 93, 64, 120, 3, 1)]     # 256 x 128, ragged M and N
S8_OUTS = ["s8-res8-relu", "s8", "bf16-resbf-relu", "bf16-res8", "f32"]


@pytest.mark.parametrize("out", S8_OUTS)
@pytest.mark.parametrize("b,h,w,ci,co,k,stride", S8_WGMMA_CASES)
def test_s8_wgmma_route_is_bit_equal(card, b, h, w, ci, co, k, stride, out):
    """The wgmma route (csrc/s8_conv_sm90.cu) against the plain version
    and the mma_sync kernel: 0 differing elements; one launch, counted on
    its route."""
    from dpig_tpu_torch.kernels import s8_conv as sc
    x8, w8, factor, bias = _s8_case(h * 31 + ci, b, h, w, ci, co, k, card)
    kw = _s8_out_kwargs(out, sc.out_shape(x8, w8, stride), co, card)
    how = sc.plan(tuple(x8.shape), tuple(w8.shape), stride)
    assert how.route == "wgmma"
    before, routed = sc.launches, dict(sc.launches_by_route)
    got = sc.s8_conv(x8, w8, factor, bias, stride, **kw)
    assert sc.launches == before + 1
    assert sc.launches_by_route == {**routed,
                                    "wgmma": routed["wgmma"] + 1}
    want = sc.s8_conv_plain(x8, w8, factor, bias, stride, **kw)
    older = sc.s8_conv_cuda(x8, w8, factor, bias, stride, route="mma_sync",
                            **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert int((got != want).sum()) == 0
    assert int((got != older).sum()) == 0


@pytest.mark.parametrize("split", [True, False])
def test_s8_wgmma_split_k_on_and_off(card, monkeypatch, split):
    """One tail shape with split-K (its plan) and without (SM_COUNT 1
    leaves every grid unsplit): the same bytes as the plain version."""
    from dpig_tpu_torch.kernels import s8_conv as sc
    b, h, w, ci, co, k = 16, 16, 8, 512, 512, 3
    if not split:
        monkeypatch.setattr(sc, "SM_COUNT", 1)
    assert (sc.plan((b, h, w, ci), (co, k, k, ci), 1).split > 1) == split
    x8, w8, factor, bias = _s8_case(7, b, h, w, ci, co, k, card)
    kw = _s8_out_kwargs("s8-res8-relu", (b, h, w, co), co, card)
    got = sc.s8_conv(x8, w8, factor, bias, 1, **kw)
    want = sc.s8_conv_plain(x8, w8, factor, bias, 1, **kw)
    torch.cuda.synchronize()
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("b,h,w,ci,co,route", [
    (2, 11, 7, 18, 128, "narrow_ci"), (2, 9, 5, 256, 3, "narrow_co"),
    (2, 9, 5, 256, 8, "wgmma"), (2, 9, 5, 48, 64, "mma_sync")])
def test_s8_plan_routes_and_counts(card, b, h, w, ci, co, route):
    from dpig_tpu_torch.kernels import s8_conv as sc
    x8, w8, factor, bias = _s8_case(ci + co, b, h, w, ci, co, 3, card)
    assert sc.plan(tuple(x8.shape), tuple(w8.shape), 1).route == route
    routed = dict(sc.launches_by_route)
    got = sc.s8_conv(x8, w8, factor, bias, out_dtype=torch.float32)
    assert sc.launches_by_route == {**routed, route: routed[route] + 1}
    want = sc.s8_conv_plain(x8, w8, factor, bias, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert int((got != want).sum()) == 0


def test_s8_wgmma_on_a_side_stream_and_in_a_cuda_graph(card):
    """A split-K and an unsplit call on a non-default stream, and both
    captured in one CUDA graph replayed twice (the workspace's memset is
    replayed with them): the same bytes each time."""
    from dpig_tpu_torch.kernels import s8_conv as sc
    cases = []
    for seed, (b, h, w, ci, co) in enumerate([(16, 8, 4, 640, 640),
                                              (16, 64, 32, 256, 256)]):
        x8, w8, factor, bias = _s8_case(seed, b, h, w, ci, co, 3, card)
        kw = _s8_out_kwargs("s8-res8-relu", (b, h, w, co), co, card)
        cases.append((x8, w8, factor, bias, kw))
    assert [sc.plan(tuple(c[0].shape), tuple(c[1].shape), 1).split > 1
            for c in cases] == [True, False]
    want = [sc.s8_conv_plain(*c[:4], **c[4]) for c in cases]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [sc.s8_conv(*c[:4], **c[4]) for c in cases]
    side.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [sc.s8_conv(*c[:4], **c[4]) for c in cases]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(outs, want))


def test_s8_wgmma_refuses_bad_inputs(card):
    from dpig_tpu_torch.kernels import s8_conv as sc
    x8, w8, factor, bias = _s8_case(0, 1, 6, 4, 18, 8, 3, card)
    with pytest.raises(ValueError, match="wgmma"):
        sc.s8_conv_cuda(x8, w8, factor, bias, route="wgmma")
    with pytest.raises(ValueError, match="route"):
        sc.s8_conv_cuda(x8, w8, factor, bias, route="cudnn")
    x8, w8, factor, bias = _s8_case(0, 1, 6, 4, 64, 8, 3, card)
    shifted = torch.empty(x8.numel() + 1, dtype=torch.int8,
                          device=card)[1:].view(x8.shape)
    shifted.copy_(x8)
    with pytest.raises(ValueError, match="aligned"):
        sc.s8_conv_cuda(shifted, w8, factor, bias)
    with pytest.raises(ValueError, match="contiguous"):
        sc.s8_conv_cuda(x8.transpose(1, 2), w8, factor, bias)


S8_NARROW_CASES = [  # b, h, w, ci, co, k
    (2, 11, 7, 18, 128, 3),    # the stem's channels, W below the tile
    (16, 128, 64, 18, 128, 3),  # the Market stem
    (1, 5, 3, 3, 8, 3),        # Ci 3, Co 8
    (3, 9, 70, 32, 100, 3),    # Ci 32, Co past 3 warps; a ragged strip
    (2, 7, 5, 16, 8, 1),       # 1x1
    (1, 6, 20, 18, 256, 3),    # Co 256: 64-pixel tiles
    (2, 17, 9, 5, 13, 1),      # odd Ci and Co
    (2, 9, 5, 256, 3, 3),      # to_rgb's channels
    (2, 128, 64, 256, 3, 3),   # to_rgb at Market width
    (1, 5, 3, 16, 1, 3),       # Ci 16, Co 1
    (3, 11, 70, 48, 7, 3),     # Ci % 32 == 16, Co 7, ragged strip
    (2, 6, 17, 240, 5, 3),     # Ci % 32 == 16, every warp busy
    (1, 9, 9, 64, 2, 1),       # 1x1
    (2, 3, 100, 32, 4, 3)]     # H below a strip


@pytest.mark.parametrize("out", S8_OUTS)
@pytest.mark.parametrize("b,h,w,ci,co,k", S8_NARROW_CASES)
def test_s8_narrow_routes_are_bit_equal(card, b, h, w, ci, co, k, out):
    """The narrow_ci and narrow_co routes against the plain version and
    the mma_sync kernel: 0 differing elements; one launch, counted on its
    route."""
    from dpig_tpu_torch.kernels import s8_conv as sc
    x8, w8, factor, bias = _s8_case(h * 31 + ci + co, b, h, w, ci, co, k,
                                    card)
    kw = _s8_out_kwargs(out, sc.out_shape(x8, w8, 1), co, card)
    route = sc.plan(tuple(x8.shape), tuple(w8.shape), 1).route
    assert route == ("narrow_co" if co < 8 else "narrow_ci")
    before, routed = sc.launches, dict(sc.launches_by_route)
    got = sc.s8_conv(x8, w8, factor, bias, 1, **kw)
    assert sc.launches == before + 1
    assert sc.launches_by_route == {**routed, route: routed[route] + 1}
    want = sc.s8_conv_plain(x8, w8, factor, bias, 1, **kw)
    older = sc.s8_conv_cuda(x8, w8, factor, bias, 1, route="mma_sync", **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert int((got != want).sum()) == 0
    assert int((got != older).sum()) == 0


def test_s8_narrow_on_a_side_stream_and_in_a_cuda_graph(card):
    """The Market stem and to_rgb on a non-default stream, and both
    captured in one CUDA graph replayed twice: the same bytes each
    time."""
    from dpig_tpu_torch.kernels import s8_conv as sc
    cases = []
    for seed, (ci, co) in enumerate([(18, 128), (256, 3)]):
        x8, w8, factor, bias = _s8_case(seed, 16, 128, 64, ci, co, 3, card)
        kw = _s8_out_kwargs("f32" if seed else "bf16-res8", (16, 128, 64, co),
                            co, card)
        cases.append((x8, w8, factor, bias, kw))
    assert [sc.plan(tuple(c[0].shape), tuple(c[1].shape), 1).route
            for c in cases] == ["narrow_ci", "narrow_co"]
    want = [sc.s8_conv_plain(*c[:4], **c[4]) for c in cases]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [sc.s8_conv(*c[:4], **c[4]) for c in cases]
    side.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [sc.s8_conv(*c[:4], **c[4]) for c in cases]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(outs, want))


def test_s8_narrow_routes_refuse_bad_inputs(card):
    """A shape `plan` sends elsewhere, asked of a narrow route, raises;
    so does an input that is not 16-byte aligned; nothing reroutes."""
    from dpig_tpu_torch.kernels import s8_conv as sc
    x8, w8, factor, bias = _s8_case(0, 1, 6, 4, 64, 8, 3, card)  # wgmma
    before = dict(sc.launches_by_route)
    for route in ("narrow_ci", "narrow_co"):
        with pytest.raises(ValueError, match=route):
            sc.s8_conv_cuda(x8, w8, factor, bias, route=route)
    x8, w8, factor, bias = _s8_case(0, 1, 6, 4, 18, 128, 3, card)
    with pytest.raises(ValueError, match="narrow_co"):
        sc.s8_conv_cuda(x8, w8, factor, bias, route="narrow_co")
    with pytest.raises(ValueError, match="narrow_ci"):
        sc.s8_conv_cuda(x8, w8, factor, bias, 2, route="narrow_ci")
    for ci, co in ((18, 128), (256, 3)):
        x8, w8, factor, bias = _s8_case(0, 1, 6, 4, ci, co, 3, card)
        shifted = torch.empty(x8.numel() + 1, dtype=torch.int8,
                              device=card)[1:].view(x8.shape)
        shifted.copy_(x8)
        with pytest.raises(ValueError, match="aligned"):
            sc.s8_conv_cuda(shifted, w8, factor, bias)
    assert sc.launches_by_route == before


@pytest.mark.parametrize("kw", [
    {"inference_dtype": "int8"},
    {"inference_dtype": "int8", "int8_calibration": "absmax",
     "int8_fallback_layers": "dec/Conv_7,to_rgb"},
    {"inference_dtype": "int8", "int8_fallback_mode": "legacy",
     "int8_fallback_layers": "dec/Conv_7,to_rgb"},
    {"compute_dtype": "bfloat16"}],
    ids=["int8", "int8-island", "int8-legacy", "bf16"])
def test_reduced_precision_transfer_on_the_card_matches_the_cpu(card, kw,
                                                                tmp_path):
    """Model 12 at a small config, the same weights and first batch,
    each device calibrating its own int8 tables: the card's images within
    the CPU's own int8-vs-float32 gap (int8) or bf16-vs-float32 gap
    (bf16), in max and in mean |diff|. The tables themselves differ: the
    generator's scales are statistics of embeddings that the two devices'
    int8 encoders round differently (0.4% at most in one run on an
    H100)."""
    from dpig_tpu_torch.kernels import s8_conv as sc
    cfg = dict(platform="cpu", model_dir=str(tmp_path), img_H=32, img_W=16,
               batch_size=4, conv_hidden_num=16, z_num=16, **kw)
    cpu = ConditionalTransferTester(Config(**cfg))
    dev = ConditionalTransferTester(Config(**{**cfg, "platform": ""}),
                                    params=cpu.cpu_state())
    batch = next(SyntheticLoader(4, 32, 16, seed=1))
    out = {}
    for name, t in (("cpu", cpu), ("card", dev)):
        tb = batch_to_device(batch, t.device)
        t._inference_params(tb)
        before = sc.launches
        out[name] = t.transfer_step(tb)[0].cpu()
        if name == "card" and "inference_dtype" in kw:
            assert sc.launches > before
    diff = (out["card"] - out["cpu"]).abs()
    f32 = ConditionalTransferTester(Config(**{
        k: v for k, v in cfg.items() if k not in kw}),
        params=cpu.cpu_state())
    flt = f32.transfer_step(batch_to_device(batch, f32.device))[0]
    gap = (out["cpu"] - flt).abs()
    assert float(diff.max()) <= float(gap.max())
    assert float(diff.mean()) <= float(gap.mean())


DF_NARROW = dict(img_H=256, img_W=256, batch_size=2, conv_hidden_num=4,
                 z_num=4)


@pytest.mark.parametrize("model,kw", [
    (1001, {}), (1002, {"sample_fg": True}),
    (1001, {"inference_dtype": "int8"}),
    (1002, {"sample_fg": True, "inference_dtype": "int8"})],
    ids=["1001", "1002", "1001-int8", "1002-int8"])
def test_df256_testers_on_the_card_match_the_cpu(card, tmp_path, model, kw):
    """Models 1001 and 1002 at 256x256, narrow (hidden 4): the same
    weights, first batch and noise on the card and on the CPU. Float32:
    images within 2e-2 on [0,255] (the 1e-4 g_raw bound), scores 1e-4,
    pose maps bit-equal. int8 (each device calibrating its own generator
    table; no int8 encoder at 256): within the CPU's own int8-vs-float32
    gap in max and mean |diff|, the s8 conv launched."""
    from dpig_tpu_torch.kernels import s8_conv as sc
    cls = ConditionalTransferTester if model == 1001 else FactorSamplingTester
    cfg = dict(platform="cpu", model_dir=str(tmp_path), **DF_NARROW, **kw)
    cpu = cls(Config(**cfg))
    dev = cls(Config(**{**cfg, "platform": ""}), params=cpu.cpu_state())
    batch = next(SyntheticLoader(2, 256, 256, seed=1))
    noise = cpu.draw_noise(torch.Generator().manual_seed(1), 2)

    def step(t, tb):
        if model == 1001:
            return t.transfer_step(tb)
        return t.sample_step(tb, {k: v.to(t.device) for k, v in
                                  noise.items()})

    out = {}
    for name, t in (("cpu", cpu), ("card", dev)):
        tb = batch_to_device(batch, t.device)
        t._inference_params(tb)
        assert t.quant_enc is None
        before = sc.launches
        out[name] = [o.cpu() for o in step(t, tb)]
        if name == "card" and kw.get("inference_dtype") == "int8":
            assert sc.launches > before
    assert torch.equal(out["card"][1], out["cpu"][1])
    diff = (out["card"][0] - out["cpu"][0]).abs()
    if "inference_dtype" not in kw:
        assert float(diff.max()) <= 2e-2
        assert float((out["card"][2] - out["cpu"][2]).abs().max()) <= 1e-4
        return
    f32 = cls(Config(**{k: v for k, v in cfg.items()
                        if k != "inference_dtype"}), params=cpu.cpu_state())
    flt = step(f32, batch_to_device(batch, f32.device))[0]
    gap = (out["cpu"][0] - flt).abs()
    assert float(diff.max()) <= float(gap.max())
    assert float(diff.mean()) <= float(gap.mean())


# ------------------------------------------------------------------ DDP
# Two ranks of 4 rows against world 1 on 8, the whole step in float64 (the
# embedding-stem sum, the nets' outputs and the ROI crop too): the card
# read at most 2.6e-15 on these keys; per-rank BatchNorm 1.6e-3 and up.
DDP_FLOAT64_TOL = {"g_step_losses": 1e-12, "d_loss": 1e-12, "Encoder": 1e-12,
                   "ID_AE": 1e-12, "Discriminator": 1e-12, "d_stats": 1e-12}


def test_nccl_world_1_step_is_the_plain_step(card, tmp_path):
    """One small-config model-1 step as rank 0 of a one-rank NCCL group
    (the gradient and metric all-reduces run; BatchNorm takes no
    collective at world 1) equals the same step without a group, bit for
    bit: metrics, gradients and the D's statistics. Both run with the
    deterministic algorithms (`ranks.deterministic`): with the default
    ones two runs of one step differ by ~1e-7 (atomics in the ROI crop's
    backward and in cuDNN's)."""
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.parallel import dist, ranks
    batch = next(SyntheticLoader(4, 32, 16, seed=3))
    cfg = Config(model_dir=str(tmp_path), **SMALL)
    with ranks.deterministic():
        plain = recorded_train_step(Stage1App(cfg, card), batch)
        assert dist.init_distributed(f"127.0.0.1:{dist.free_port()}", 1, 0)
        try:
            assert torch.distributed.get_backend() == "nccl"
            grouped = recorded_train_step(Stage1App(cfg, dist.rank_device()),
                                          batch, g_updated=plain.g_updated)
        finally:
            dist.shutdown()
    assert grouped.metrics == plain.metrics
    for k, v in plain.grads.items():
        assert torch.equal(grouped.grads[k], v), k
    for k, v in plain.d_stats.items():
        assert torch.equal(grouped.d_stats[k], v), k


def test_two_ranks_on_one_card_match_world_1(card, tmp_path):
    """Two gloo ranks sharing the card (asked for by argument: NCCL
    refuses two ranks on one device), 4 rows each, against the world-1
    step on the 8 rows on the card, the whole step in float64 (the
    embedding-stem sum too): within DDP_FLOAT64_TOL; both ranks' metrics
    equal; one pose launch per rank. The same step with each rank's own
    BatchNorm statistics breaks a limit. In float32 cuDNN picks its
    algorithms by batch size, and the two sides differ by that (PERF.md
    §6, data parallelism)."""
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.parallel import ranks
    from dpig_tpu_torch.train.parity import to_float64
    batch = next(SyntheticLoader(8, 32, 16, seed=4))
    cfg = Config(model_dir=str(tmp_path), **{**SMALL, "batch_size": 8})
    app = Stage1App(cfg, card)
    params = {name: {k: v.cpu().clone() for k, v in m.state_dict().items()}
              for name, m in (("Encoder", app.encoder),
                              ("ID_AE", app.generator),
                              ("Discriminator", app.disc))}
    one = recorded_train_step(to_float64(app, stem=True, outputs=True),
                              batch)
    job = {"cfg": dict(SMALL, batch_size=8, model_dir=str(tmp_path)),
           "params": params, "batch": batch, "g_updated": one.g_updated,
           "float64": True, "stem64": True, "outputs64": True}
    outs, local_bn = ranks.run_many(
        [("stage1", job), ("stage1", dict(job, local_bn=True))], n=2,
        platform="", backend="gloo", timeout=300)
    assert outs[0]["metrics"] == outs[1]["metrics"]
    for o, control in zip(outs, local_bn):
        errs = step_errors(one, ranks.as_record(o))
        print(f"two ranks on one card vs world 1: {errs}")
        assert all(errs[k] <= t for k, t in DDP_FLOAT64_TOL.items()), errs
        assert o["pose_launches"] == 1
        errs = step_errors(one, ranks.as_record(control))
        print(f"control, per-rank BatchNorm: {errs}")
        assert any(errs[k] > t for k, t in DDP_FLOAT64_TOL.items()), errs


# ------------------------------------------------ scoring and the int8 gate
def test_score_pairs_on_the_card_match_the_cpu(card):
    """`eval/metrics.py`'s scoring protocol, float64 on both: within 1e-9,
    a flat target's NaN / inf where the CPU has them."""
    from dpig_tpu_torch.eval import metrics
    rng = np.random.default_rng(0)
    g = rng.integers(0, 256, (6, 128, 64, 3)).astype(np.uint8)
    x = rng.integers(0, 256, (6, 128, 64, 3)).astype(np.uint8)
    x[1] = 128
    g[1, :40] = 50
    m = rng.integers(0, 256, (6, 128, 64)).astype(np.uint8)
    args = [torch.from_numpy(a) for a in (g, x, m)]
    for fn, n in ((metrics.score_pair_gray, 2),
                  (metrics.score_pair_masked, 3)):
        want = fn(*args[:n])
        got = fn(*[a.to(card) for a in args[:n]])
        for k, v in want.items():
            w, c = v.numpy(), got[k].cpu().numpy()
            assert got[k].device.type == "cuda"
            assert np.array_equal(np.isnan(w), np.isnan(c)), k
            fin = np.isfinite(w)
            assert np.array_equal(w[~fin & ~np.isnan(w)],
                                  c[~fin & ~np.isnan(w)]), k
            np.testing.assert_allclose(c[fin], w[fin], rtol=0, atol=1e-9)


def test_gate_batch_s8_shapes_are_bit_equal(card, tmp_path):
    """Every s8 conv call of one Market int8 gate batch of 64 (`check
    --transfer`: the int8 encoder and generator, weights from a one-step
    `train`), on the route `plan` picks and on mma_sync, bit-equal to the
    plain version, each launch counted."""
    from dpig_tpu_torch.eval import int8_quality as pq
    from dpig_tpu_torch.kernels import s8_conv as sc
    pq.train(1, str(tmp_path), pool_size=1)
    calls, launch = [], sc.s8_conv_cuda

    def record(*a, **kw):
        calls.append((a, kw))
        return launch(*a, **kw)

    sc.s8_conv_cuda = record
    try:
        pq.check(str(tmp_path), n_batches=2, transfer=True)
    finally:
        sc.s8_conv_cuda = launch
    calls = calls[30:]  # the calibration batch's encoder pass
    assert len(calls) == 60
    assert {a[0].shape[0] for a, _ in calls} == {64, 7 * 64}  # ROI batch
    for a, kw in calls:
        want = sc.s8_conv_plain(*a, **kw)
        for route in {sc.plan(tuple(a[0].shape), tuple(a[1].shape),
                              a[4] if len(a) > 4 else kw.get("stride", 1)
                              ).route, "mma_sync"}:
            before = sc.launches_by_route[route]
            assert torch.equal(sc.s8_conv_cuda(*a, **kw, route=route),
                               want), (tuple(a[0].shape), route)
            assert sc.launches_by_route[route] == before + 1


def test_int8_gate_on_the_card_matches_the_cpu(card, tmp_path):
    """`check` at a small config (hidden 64: the wgmma route runs) on the
    card and on the CPU from one checkpoint: the four SSIM numbers within
    half the CPU's int8-vs-float SSIM gap (a card path that quietly ran
    float would be one gap off), chip_smoke.py's [quality] limit."""
    from dpig_tpu_torch.eval import int8_quality as pq
    small = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=64,
                 z_num=16)
    pq.train(2, str(tmp_path), pool_size=2,
             cfg_overrides=dict(small, platform="cpu"))
    got = pq.check(str(tmp_path), n_batches=2, cfg_overrides=small)
    want = pq.check(str(tmp_path), n_batches=2,
                    cfg_overrides=dict(small, platform="cpu"))
    gap = 1.0 - want["ssim_int8_float"]
    assert gap > 0.0, want
    for k, v in want.items():
        assert abs(got[k] - v) <= gap / 2, (k, got[k], v, gap)


# ------------------------------------------------------- TF1 checkpoints
def test_tf1_bundle_imported_on_the_card(card, tmp_path, capsys):
    """A TF1 bundle written by `write_bundle` (this machine has no
    TensorFlow to write one) of every scope of the small config's nets,
    read back bit for bit, imported by the CLI twin on the card, and model
    12 from the imported checkpoint through --pretrained_path: the same
    transfer step, bit for bit, as the tester on the source weights; no
    TensorFlow module loaded."""
    import sys
    from dpig_tpu_torch.train import checkpoint as ckpt
    from dpig_tpu_torch.train import tf1_bundle, tf1_import
    source = tf1_import.template_state(Config(
        platform="", model_dir=str(tmp_path / "src"), random_seed=4,
        **SMALL))
    var = tf1_import.reference_variables(source, 32, 16)
    prefix = tf1_bundle.write_bundle(str(tmp_path / "ref" / "model.ckpt"),
                                     var)
    back = tf1_bundle.read_bundle(prefix)
    assert sorted(back) == sorted(var)
    assert all(back[n].tobytes() == v.tobytes() for n, v in var.items())
    out = str(tmp_path / "imported")
    tf1_import.main([f"--ckpt_path={prefix}", f"--model_dir={out}",
                     *(f"--{k}={v}" for k, v in SMALL.items())])
    assert "scopes not found" not in capsys.readouterr().out
    tree = ckpt.load_tree(out)
    for sub in ("Encoder", "ID_AE", "PoseAE"):
        for n, t in source[sub].items():
            assert torch.equal(tree["g_params"][sub][n], t), (sub, n)
    batch = batch_to_device(next(SyntheticLoader(4, 32, 16, seed=3)), card)
    got = ConditionalTransferTester(Config(
        platform="", model_dir=str(tmp_path / "m12"), pretrained_path=out,
        **SMALL)).transfer_step(batch)
    want = ConditionalTransferTester(Config(
        platform="", model_dir=str(tmp_path / "m12s"), **SMALL), params={
            k: source[k] for k in ("Encoder", "ID_AE")}).transfer_step(batch)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not any(m.split(".")[0] == "tensorflow" for m in sys.modules)



# ------------------------------------------- the zoo, LayerNorm, SSIM
def _card_vs_cpu(card, make, inputs, call=lambda m, *xs: m(*xs)):
    """The module `make()` (seeded weights, 1-D params moved off their
    init) on the card and on the CPU, float32, TF32 off: (max |diff| of
    the outputs over their largest |value|, ||diff|| / ||grad|| over the
    gradients of sum(out * W) w.r.t. every parameter and input)."""
    from dpig_tpu_torch.models.layers import init_weights
    cpu = torch.device("cpu")
    m = make()
    g = torch.Generator().manual_seed(12)
    init_weights(m, g)
    with torch.no_grad():
        for p in m.parameters():
            if p.dim() == 1:
                p.add_(torch.rand(p.shape, generator=g) * 0.4 - 0.2)
    res = []
    for dev in (cpu, card):
        md = copy.deepcopy(m).to(dev)
        xs = [x.to(dev).requires_grad_(True) for x in inputs]
        out = call(md, *xs)
        w = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            13)).to(dev)
        grads = torch.autograd.grad((out * w).sum(),
                                    list(md.parameters()) + xs)
        res.append((out.detach().cpu(), [t.cpu() for t in grads]))
    (o_cpu, g_cpu), (o_card, g_card) = res
    out_err = float((o_card - o_cpu).abs().max() / o_cpu.abs().max())
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(g_card, g_cpu))
    den = sum(float((b ** 2).sum()) for b in g_cpu)
    return out_err, (num / den) ** 0.5


@pytest.mark.parametrize("resample", [None, "down", "up"])
def test_wgan_residual_block_on_the_card_matches_the_cpu(card, resample):
    """`models/zoo.py:WGANResidualBlock` at ResnetGenerator / Discriminator
    widths (128 channels in, 16x8, batch 4; its BatchNorm in train mode):
    the output within 1e-5 of its largest, the gradients within 1e-4."""
    from dpig_tpu_torch.models.zoo import WGANResidualBlock
    co = {None: 128, "down": 256, "up": 64}[resample]
    x = torch.randn(4, 128, 16, 8, generator=torch.Generator().manual_seed(1))
    errs = _card_vs_cpu(card, lambda: WGANResidualBlock(128, co, 3, resample),
                        [x])
    assert errs[0] <= 1e-5 and errs[1] <= 1e-4, errs


def test_subpixel_conv_on_the_card_matches_the_cpu(card):
    """`SubpixelConv` (3x3, 64 -> 4 x 32 channels, the JAX package's
    shuffle order) on a 16x8 map, batch 4: the output within 1e-5, the
    gradients within 1e-4; the shuffle alone bit-equal."""
    from dpig_tpu_torch.models.zoo import SubpixelConv
    x = torch.randn(4, 64, 16, 8, generator=torch.Generator().manual_seed(2))
    errs = _card_vs_cpu(card, lambda: SubpixelConv(64, 32, 3), [x])
    assert errs[0] <= 1e-5 and errs[1] <= 1e-4, errs
    m = SubpixelConv(64, 32, 1)
    with torch.no_grad():
        m.Conv_0.weight.copy_(torch.eye(128, 64)[:, :, None, None])
        m.Conv_0.bias.zero_()
        y = torch.randn(4, 128, 16, 8)[:, :64]
        assert torch.equal(m.to(card)(y.to(card)).cpu(), m.cpu()(y))


def test_layer_norm_on_the_card_matches_the_cpu(card):
    """`layers.LayerNorm` (flax's over the channels, 512 channels, 8x4,
    batch 16, a mean offset of 3) in float32: the output within 1e-5, the
    gradients within 1e-5; and its bfloat16 output within one bfloat16
    ulp of the CPU's."""
    from dpig_tpu_torch.models.layers import LayerNorm
    x = torch.randn(16, 512, 8, 4,
                    generator=torch.Generator().manual_seed(3)) + 3.0
    errs = _card_vs_cpu(card, lambda: LayerNorm(512), [x])
    assert errs[0] <= 1e-5 and errs[1] <= 1e-5, errs
    m = LayerNorm(512, dtype=torch.bfloat16)
    with torch.no_grad():
        m.weight.fill_(1.0)
        m.bias.zero_()
        a, b = m.to(card)(x.to(card)).float().cpu(), m.cpu()(x).float()
    assert float((a - b).abs().max()) <= 2.0 ** -7 * 4


def test_ssim_on_the_card_matches_the_cpu(card):
    """`ops/ssim.py`: SSIM at Market 128x64 (batch 16) and MS-SSIM at
    256x256 (batch 4) on the card against the CPU within 1e-5; SSIM's
    gradient w.r.t. the image within 1e-4 of its largest."""
    from dpig_tpu_torch.ops import ssim
    g = torch.Generator().manual_seed(4)
    for fn, shape in ((ssim.ssim, (16, 128, 64, 1)),
                      (ssim.ms_ssim, (4, 256, 256, 1))):
        a = torch.rand(shape, generator=g)
        b = (a + 0.1 * torch.randn(shape, generator=g)).clamp(0, 1)
        got = float(fn(a.to(card), b.to(card)))
        want = float(fn(a, b))
        assert abs(got - want) <= 1e-5, (fn.__name__, got, want)
    grads = []
    for dev in (torch.device("cpu"), card):
        x = a[:, :128, :64].to(dev).requires_grad_(True)
        (gx,) = torch.autograd.grad(ssim.ssim(x, b[:, :128, :64].to(dev)), x)
        grads.append(gx.cpu())
    assert float((grads[1] - grads[0]).abs().max()) <= \
        1e-4 * float(grads[0].abs().max())


def test_wgan_gp_step_of_the_dcgan_d_on_the_card(card):
    """The WGAN-GP critic step (`losses/gan.py:d_loss("wgan-gp")`) of the
    'wgan-gp' DCGAN D at Market width (128x64, dim 64, batch 4): its
    convs' double backward through `layers._NativeConv2dGrad` gives, bit
    for bit, what the whole step gives with cuDNN off, and the loss and
    the gradients match the CPU's within 1e-5 and 1e-4."""
    from dpig_tpu_torch.losses import gan
    from dpig_tpu_torch.models.discriminators import DCGANDiscriminator
    from dpig_tpu_torch.models.layers import init_weights
    g = torch.Generator().manual_seed(5)
    real, fake = (torch.rand(4, 128, 64, 3, generator=g) * 2 - 1
                  for _ in range(2))
    alpha = torch.rand(4, 1, 1, 1, generator=g)
    d = DCGANDiscriminator(128, 64, mode="wgan-gp")
    init_weights(d, torch.Generator().manual_seed(6))

    def step(dev):
        m = copy.deepcopy(d).to(dev)
        r, f, a = real.to(dev), fake.to(dev), alpha.to(dev)
        loss = gan.d_loss("wgan-gp", m(r), m(f), critic_fn=m, real_data=r,
                          fake_data=f, alpha=a)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        return loss.detach().cpu(), [t.cpu() for t in grads]

    native = step(card)
    with torch.backends.cudnn.flags(enabled=False):
        off = step(card)
    assert torch.equal(native[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(native[1], off[1]))
    cpu = step(torch.device("cpu"))
    assert abs(float(native[0] - cpu[0])) <= 1e-5 * abs(float(cpu[0]))
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(native[1], cpu[1]))
    den = sum(float((b ** 2).sum()) for b in cpu[1])
    assert (num / den) ** 0.5 <= 1e-4
