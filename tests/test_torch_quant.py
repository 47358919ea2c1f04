"""The int8 serving path of the port (`models/quant.py`, the plain s8 conv
of `kernels/s8_conv.py`, the testers' `--inference_dtype=int8`) against
the JAX package's `models/quant.py`, on the CPU at a tiny config.

Bit-equal to JAX: `quantize_weights` (with and without the per-channel
fold, with `g_stem`), `quantize_encoder_weights`, `_kl_threshold_scale`,
and the plain s8 conv against `conv_general_dilated(...,
preferred_element_type=int32)` (exact integer sums in both).

Within stated limits: `calibrate` (each method's scales within 1e-4
relative: both take statistics of a float32 forward whose sums run in
other orders), and the int8 forwards, which run one JAX table (bridged by
`quant_from_jax`) on both sides. Their limit is JAX's own int8-vs-float
gap on the same inputs: the port's int8 output must be as close to JAX's
int8 output as JAX's int8 is to its float32 (max |diff|), and far closer
on average (mean |diff| at most a tenth of the gap's). An s8 store turns
a float32 difference in the last bit into a whole quantum where a value
sits on a rounding boundary, so a few elements may differ by that much.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpig_tpu.apps import testers as jtesters
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.data.synthetic import SyntheticLoader as JaxLoader
from dpig_tpu.models import quant as jquant
from dpig_tpu.models.mappers import sample_mapper_noise as jax_noise
from dpig_tpu.ops.pose import render_pose_maps
from dpig_tpu_torch.apps import testers
from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.bridge import params_from_flax, quant_from_jax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.kernels.s8_conv import s8_conv, s8_conv_plain
from dpig_tpu_torch.models import quant

torch.set_num_threads(1)

SMALL = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16)
REPEAT, HIDDEN = 3, 16
FULL = testers.FullSamplingTester


def _t(a):
    return torch.from_numpy(np.array(a))


def _f(a):
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def jparams():
    """The JAX FullSamplingTester's cold-start params, once per module."""
    return jtesters.FullSamplingTester(JaxConfig(**SMALL)).params


@pytest.fixture(scope="module")
def port(jparams):
    """The port's Stage-I nets on the same weights, with a batch, its
    encoder embeddings and pose maps (JAX's)."""
    state = params_from_flax(jparams, FULL.SUBTREES)
    tester = FULL(Config(platform="cpu", **SMALL),
                  params={k: state[k] for k in FULL.SUBTREES})
    batch = next(JaxLoader(4, 32, 16, seed=3))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    bbox, vis = jb["part_bbox"][:, :7], jb["part_vis"][:, :7].astype(
        jnp.float32)
    embs = np.asarray(quant_enc_float(jparams["Encoder"], jb, bbox, vis))
    pose = np.asarray(render_pose_maps(jb["pose_rcv"], 32, 16))
    return tester, batch, jb, bbox, vis, embs, pose


@jax.jit
def quant_enc_float(enc_params, jb, bbox, vis):
    """JAX's float32 FG/BG encoder forward on raw params."""
    return jquant.roi_fgbg_forward(enc_params, jb["x"], jb["mask_r6"], bbox,
                                   vis, REPEAT, HIDDEN)


# ------------------------------------------------------------- weights
@pytest.mark.parametrize("fold", [False, True], ids=["tensor", "folded"])
def test_quantize_weights_is_bit_equal_to_jax(jparams, port, fold):
    gen = port[0].stage1.generator
    rng = np.random.default_rng(0)
    fold_scales = None
    if fold:
        shapes = {**{f"enc/{n}": gen.ConvBlockTower_0.get_submodule(n)
                     .weight.shape[1] for _, n in
                     quant.enc_layer_names(REPEAT)},
                  **{f"dec/{n}": getattr(gen, n).weight.shape[1] for _, n in
                     quant.dec_layer_names(REPEAT)},
                  "to_rgb": gen.to_rgb.weight.shape[1], "g_stem": 18}
        fold_scales = {k: rng.uniform(0.01, 0.2, c).astype(np.float32)
                       for k, c in shapes.items()}
    ref = jquant.quantize_weights(jparams["ID_AE"], REPEAT,
                                  fold_act_scales=fold_scales, emb_dim=352)
    got = quant.quantize_weights(gen, REPEAT, fold_act_scales=fold_scales,
                                 emb_dim=352)
    want = quant_from_jax({"weights": ref, "act_scales": {}})["weights"]
    assert set(got) == set(want) and "g_stem" in got
    for k, (w8, s) in want.items():
        assert got[k][0].dtype == torch.int8
        assert torch.equal(got[k][0], w8), k
        assert torch.equal(got[k][1], s), k


@pytest.mark.parametrize("fold", [False, True], ids=["tensor", "folded"])
def test_quantize_encoder_weights_is_bit_equal_to_jax(jparams, port, fold):
    enc = port[0].stage1.encoder
    fold_scales = None
    if fold:
        rng = np.random.default_rng(1)
        fold_scales = {n: rng.uniform(0.01, 0.2, quant._enc_layer(enc, n)
                                      .weight.shape[1]).astype(np.float32)
                       for n in quant.quantize_encoder_weights(enc, REPEAT)}
    ref = jquant.quantize_encoder_weights(jparams["Encoder"], REPEAT,
                                          fold_act_scales=fold_scales)
    got = quant.quantize_encoder_weights(enc, REPEAT,
                                         fold_act_scales=fold_scales)
    want = quant_from_jax({"weights": ref, "act_scales": {}})["weights"]
    assert set(got) == set(want) and "stem/Conv_0" not in got
    for k, (w8, s) in want.items():
        assert torch.equal(got[k][0], w8) and torch.equal(got[k][1], s), k


def test_kl_threshold_scale_is_jaxs():
    rng = np.random.default_rng(5)
    hist = np.bincount(np.minimum(rng.exponential(60, 200_000), 511)
                       .astype(np.int64), minlength=512)
    hist[rng.integers(0, 512, 40)] = 0
    for amax in (3.7, 0.25):
        assert quant._kl_threshold_scale(hist, amax) == \
            jquant._kl_threshold_scale(hist, amax)
    assert quant._kl_threshold_scale(np.zeros(512), 2.0) == \
        jquant._kl_threshold_scale(np.zeros(512), 2.0)


# --------------------------------------------------------------- s8 conv
@pytest.mark.parametrize("h,w,ci,co,k,stride", [
    (7, 5, 16, 8, 1, 1), (7, 5, 16, 8, 3, 1), (9, 6, 32, 16, 3, 2),
    (8, 4, 16, 24, 3, 2), (11, 7, 18, 16, 3, 1), (5, 3, 48, 3, 3, 1),
    (6, 6, 18, 8, 1, 2)])
def test_plain_s8_conv_equals_jax_int32_conv(h, w, ci, co, k, stride):
    """The int32 sums bit-equal, odd sizes, stride 2's asymmetric pads,
    Ci = 18; and the epilogue against JAX's float32 graph ops."""
    rng = np.random.default_rng(h * 100 + ci)
    x8 = rng.integers(-127, 128, (2, h, w, ci)).astype(np.int8)
    w8 = rng.integers(-127, 128, (k, k, ci, co)).astype(np.int8)
    acc = np.asarray(jquant._qconv_raw(jnp.asarray(x8), jnp.asarray(w8),
                                       stride))
    factor = rng.uniform(1e-4, 1e-3, co).astype(np.float32)
    bias = rng.normal(0, 0.1, co).astype(np.float32)
    w_ohwi = _t(w8.transpose(3, 0, 1, 2)).contiguous()
    y = s8_conv_plain(_t(x8), w_ohwi, _t(factor), _t(bias), stride,
                      out_dtype=torch.float32)
    want = (acc.astype(np.float32) * factor + bias)
    assert y.shape == acc.shape
    np.testing.assert_array_equal(y.numpy(), want)
    # s8 out with an s8 residual, ReLU, per-channel scales
    res = rng.integers(-127, 128, acc.shape).astype(np.int8)
    rs = rng.uniform(0.01, 0.05, co).astype(np.float32)
    os_ = rng.uniform(0.02, 0.2, co).astype(np.float32)
    got = s8_conv(_t(x8), w_ohwi, _t(factor), _t(bias), stride, relu=True,
                  res=_t(res), res_scale=_t(rs), out_scale=_t(os_),
                  out_dtype=torch.int8)
    yj = jnp.maximum(jnp.asarray(acc).astype(jnp.float32) * factor + bias,
                     0) + jnp.asarray(res).astype(jnp.float32) * rs
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jquant._quantize(yj, os_)))
    bf = s8_conv(_t(x8), w_ohwi, 0.5e-3, _t(bias), stride,
                 res=_t(np.asarray(yj.astype(jnp.bfloat16).astype(
                     jnp.float32))).to(torch.bfloat16))
    yb = (jnp.asarray(acc).astype(jnp.float32) * 0.5e-3 + bias
          + yj.astype(jnp.bfloat16).astype(jnp.float32)).astype(
              jnp.bfloat16)
    assert torch.equal(bf.float(), _t(np.asarray(yb.astype(jnp.float32))))


# ------------------------------------------------------------- calibrate
@pytest.mark.parametrize("kw", [
    {}, {"calib_percentile": 99.9}, {"calib_method": "entropy"},
    {"calib_granularity": "channel"}],
    ids=["absmax", "percentile", "entropy", "channel"])
def test_calibrate_matches_jax(jparams, port, kw):
    """Every layer's scale within 1e-4 relative of JAX's (reading: 1.9e-5,
    a per-channel absmax of enc/Conv_6), and the pinned
    downsample scales equal to their decoder tail slices."""
    gen, embs, pose = port[0].stage1.generator, port[5], port[6]
    embs2 = embs[::-1].copy()
    ref = jquant.calibrate(jparams["ID_AE"], [embs, embs2], [pose, pose],
                           REPEAT, HIDDEN, **kw)
    with torch.no_grad():
        got = quant.calibrate(gen, [_t(embs), _t(embs2)],
                              [_t(pose), _t(pose)], REPEAT, HIDDEN, **kw)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(v, np.float64), rtol=1e-4,
                                   err_msg=k)
    if kw.get("calib_granularity") == "channel":
        assert np.array_equal(got["enc/Conv_2"], got["dec/Conv_6"][-16:])


# ------------------------------------------------------ int8 forwards
def _jax_table(jparams, port, **kw):
    embs, pose = port[5], port[6]
    qg = jquant.QuantizedGenerator(jparams["ID_AE"], REPEAT, HIDDEN, **kw)
    return qg.calibrate([embs], [pose])


@pytest.mark.parametrize("kw,chained", [
    ({"calib_granularity": "channel"}, True),
    ({"calib_granularity": "channel",
      "bf16_layers": frozenset({"dec/Conv_7", "to_rgb"})}, True),
    ({"bf16_layers": frozenset({"dec/Conv_7", "to_rgb"}),
      "fallback_mode": "legacy"}, False),
    ({}, True)],
    ids=["all-int8", "island", "legacy", "tensor-scales"])
def test_uae_forward_int8_matches_jax(jparams, port, kw, chained):
    """One JAX table (bridged) on both sides: the s8-chained graph, its
    bf16 islands (`dec/Conv_7,to_rgb`, the last decoder conv and to_rgb at
    this depth, as `dec/Conv_13,to_rgb` at full width), the legacy graph.
    Readings: max |diff| at most one JAX int8 quantum of g_raw here."""
    gen, embs, pose = port[0].stage1.generator, port[5], port[6]
    qg = _jax_table(jparams, port, **kw)
    ref, ref_z = jquant.uae_forward(jparams["ID_AE"], embs, pose, REPEAT,
                                    HIDDEN, quant=qg.quant, chained=chained)
    flt, _ = jquant.uae_forward(jparams["ID_AE"], embs, pose, REPEAT, HIDDEN)
    table = quant_from_jax(qg.quant)
    with torch.no_grad():
        out, z = quant.uae_forward(gen, _t(embs), _t(pose), REPEAT, HIDDEN,
                                   quant=table, chained=chained)
    assert out.dtype == torch.float32 and z.dtype == torch.bfloat16
    gap = np.abs(_f(ref) - _f(flt))
    diff = np.abs(out.numpy() - _f(ref))
    assert diff.max() <= gap.max(), (diff.max(), gap.max())
    assert diff.mean() <= gap.mean() / 10, (diff.mean(), gap.mean())
    assert np.abs(z.float().numpy() - _f(ref_z)).max() <= \
        np.abs(_f(ref_z) - _f(jquant.uae_forward(
            jparams["ID_AE"], embs, pose, REPEAT, HIDDEN)[1])).max()


@pytest.mark.parametrize("granularity", ["tensor", "channel"])
def test_roi_fgbg_forward_int8_matches_jax(jparams, port, granularity):
    tester, _, jb, bbox, vis, _, _ = port
    qe = jquant.QuantizedEncoder(jparams["Encoder"], REPEAT, HIDDEN,
                                 calib_granularity=granularity)
    qe.calibrate([(jb["x"], jb["mask_r6"], bbox, vis)])
    ref = np.asarray(qe(jb["x"], jb["mask_r6"], bbox, vis))
    flt = np.asarray(quant_enc_float(jparams["Encoder"], jb, bbox, vis))
    pq = quant.QuantizedEncoder(tester.stage1.encoder, REPEAT, HIDDEN,
                                calib_granularity=granularity)
    args = (_t(jb["x"]), _t(jb["mask_r6"]), _t(bbox), _t(vis))
    with torch.no_grad():
        pq.calibrate([args])
        got_own = pq(*args).numpy()
        pq.quant = quant_from_jax(qe.quant)
        got = pq(*args).numpy()
    gap = np.abs(ref - flt)
    for g in (got, got_own):  # JAX's table, and the port's own
        diff = np.abs(g - ref)
        assert diff.max() <= gap.max() and diff.mean() <= gap.mean() / 10, (
            diff.max(), diff.mean(), gap.max(), gap.mean())


# ------------------------------------------------------------- testers
def _jax_tester(cls, monkeypatch, jparams, tmp_path, **kw):
    monkeypatch.setattr(jtesters._TesterBase, "_restore_params",
                        lambda self: jparams)
    return cls(JaxConfig(model_dir=str(tmp_path), **SMALL, **kw))


def _ssim(text):
    return float(re.search(r"SSIM\(int8,float\)=([0-9.]+)", text).group(1))


@pytest.mark.parametrize("cls_name,kw", [
    ("ConditionalTransferTester", {}),
    ("FullSamplingTester", {"sample_app": True})],
    ids=["model12", "model11-sample_app"])
def test_int8_testers_match_jax(jparams, port, monkeypatch, tmp_path,
                                capsys, cls_name, kw):
    """Calibration on the same first batch (and, with sample_app, the same
    mapper noise), then one step on it: the images within JAX's
    int8-vs-float gap (max and mean |diff|), the self-check SSIM within
    2e-3 of JAX's. The mean is not held tighter here: JAX's testers run
    the int8 graph jitted, and on the CPU XLA's jitted int8 encoder differs
    from JAX's own eager one in 1107 of its 1408 outputs at this config
    (the port equals the eager one bit for bit, per-tensor scales: the
    tests above), so the two calibrations see other embeddings. Readings:
    model 12 max 4.1 / mean 0.75 against a gap of 0.98 mean (0-255)."""
    batch, jb = port[1], port[2]
    jt = _jax_tester(getattr(jtesters, cls_name), monkeypatch, jparams,
                     tmp_path, inference_dtype="int8", **kw)
    params = jt._inference_params(batch)
    ssim_jax = _ssim(capsys.readouterr().out)
    state = params_from_flax(jparams, FULL.SUBTREES)
    cls = getattr(testers, cls_name)
    pt = cls(Config(platform="cpu", model_dir=str(tmp_path),
                    inference_dtype="int8", **SMALL, **kw),
             params={k: state[k] for k in cls.SUBTREES})
    rng = jax.random.PRNGKey(jt.cfg.random_seed)
    r_fg, r_bg = jax.random.split(rng)
    noise = {"fg": _t(jax_noise(r_fg, 4, 224)),
             "bg": _t(jax_noise(r_bg, 4, 128)),
             "pose": torch.zeros(4, 32)}
    tb = batch_to_device(batch, torch.device("cpu"))
    pt._inference_params(tb, calib_noise=noise)
    ssim_port = _ssim(capsys.readouterr().out)
    assert pt.quant_gen["act_folded"] and pt.quant_gen["act_pinned"]
    assert abs(ssim_port - ssim_jax) <= 2e-3, (ssim_port, ssim_jax)
    assert ssim_port == pytest.approx(pt.int8_fidelity, abs=5e-5)

    if cls_name == "ConditionalTransferTester":
        g_ref = jt.transfer_step(params, jb)[0]
        g_flt = jt.transfer_step(jt.params, jb)[0]
        g = pt.transfer_step(tb)[0]
    else:
        step_rng = jax.random.PRNGKey(11)
        r_fg, r_bg, _ = jax.random.split(step_rng, 3)
        g_ref = jt.sample_step(params, jb, step_rng, "real")[0]
        g_flt = jt.sample_step(jt.params, jb, step_rng, "real")[0]
        g = pt.sample_step(tb, {"fg": _t(jax_noise(r_fg, 4, 224)),
                                "bg": _t(jax_noise(r_bg, 4, 128)),
                                "pose": torch.zeros(4, 32)}, "real")[0]
    gap = np.abs(_f(g_ref) - _f(g_flt))
    diff = np.abs(g.numpy() - _f(g_ref))
    assert diff.max() <= gap.max(), (diff.max(), gap.max())
    assert diff.mean() <= gap.mean(), (diff.mean(), gap.mean())


# ---------------------------------------------------------- error paths
def _cfg(tmp_path, **kw):
    return Config(platform="cpu", model_dir=str(tmp_path), **SMALL, **kw)


def test_int8_error_paths_match_jax(jparams, port, monkeypatch, tmp_path):
    """Unknown fallback names and an unknown --int8_calibration raise
    ValueError on both sides. JAX's third refusal, encoder fallback names
    on a path with no int8 encoder, is its 256 family (the single-branch
    encoder): the port refuses that family when the tester is built."""
    batch = port[1]
    state = params_from_flax(jparams, FULL.SUBTREES)
    params = {k: state[k] for k in
              testers.ConditionalTransferTester.SUBTREES}
    tb = batch_to_device(batch, torch.device("cpu"))
    for kw, match in (
            ({"int8_fallback_layers": "dec/Conv_99"}, "unknown bf16_layers"),
            ({"int8_fallback_layers": "fg/Conv_99"}, "unknown bf16_layers"),
            ({"int8_calibration": "median"}, "unknown --int8_calibration")):
        jt = _jax_tester(jtesters.ConditionalTransferTester, monkeypatch,
                         jparams, tmp_path, inference_dtype="int8", **kw)
        with pytest.raises(ValueError, match=match):
            jt._inference_params(batch)
        pt = testers.ConditionalTransferTester(
            _cfg(tmp_path, inference_dtype="int8", **kw), params=params)
        with pytest.raises(ValueError, match=match):
            pt._inference_params(tb)
    with pytest.raises(NotImplementedError, match='"The 256 family"'):
        testers.ConditionalTransferTester(Config(
            platform="cpu", img_H=256, img_W=256, inference_dtype="int8",
            int8_fallback_layers="fg/Conv_0", model_dir=str(tmp_path)))


def test_cli_runs_int8_and_bf16_testers(tmp_path, capsys):
    """Models 12, 11 and 13 through the CLI with --inference_dtype=int8,
    and model 12 with --compute_dtype=bfloat16: trees written, the
    self-check line printed for int8."""
    from dpig_tpu_torch import main
    base = ["--is_train=false", "--platform=cpu", "--synthetic_data=true",
            "--test_batch_num=1", "--img_H=32", "--img_W=16",
            "--batch_size=4", "--conv_hidden_num=16", "--z_num=16"]
    for i, flags in enumerate((
            ["--model=12", "--inference_dtype=int8"],
            ["--model=11", "--sample_app=true", "--inference_dtype=int8",
             "--int8_fallback_layers=dec/Conv_7,to_rgb"],
            ["--model=13", "--sample_fg=true", "--inference_dtype=int8",
             "--int8_calibration=absmax"],
            ["--model=12", "--compute_dtype=bfloat16"])):
        main.main(base + flags + [f"--model_dir={tmp_path}/{i}"])
        out = capsys.readouterr().out
        assert ("int8 self-check: SSIM(int8,float)=" in out) == (
            "--inference_dtype=int8" in flags), out
    assert (tmp_path / "0" / "test_result" / "G").is_dir()
