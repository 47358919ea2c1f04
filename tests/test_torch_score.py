"""The port's scoring protocol (`dpig_tpu_torch/eval/metrics.py`,
`eval/score.py`, `eval/inception.py`) against the JAX package's
`dpig_tpu/eval/metrics.py`, `score.py` and `inception.py`, on the CPU.

Limits: the metrics and the scored dicts within 1e-10 (both float64; the
port's window sums and means run in other orders than scipy's running
sums and numpy's pairwise sums, ~1e-15 apart on these images), the
uint8 masking bit-equal, the score*.txt files equal, the IS protocol
within 1e-12.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from dpig_tpu.eval import inception as jinception
from dpig_tpu.eval import metrics as jmetrics
from dpig_tpu.eval import score as jscore
from dpig_tpu_torch.apps.testers import ConditionalTransferTester
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.data.synthetic import SyntheticLoader
from dpig_tpu_torch.eval import inception, metrics, score

torch.set_num_threads(1)

TOL = 1e-10
KEYS = ("ssim", "psnr", "l1", "l2")


def _images(seed, n=4, h=32, w=16):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    # the target: a smoothed copy of g plus noise, so SSIM is far from 0
    x = np.clip(g.astype(np.int64) // 2 + rng.integers(0, 128, g.shape),
                0, 255).astype(np.uint8)
    mask = rng.integers(0, 256, (n, h, w)).astype(np.uint8)  # graded
    return g, x, mask


def _close(got, want, tol=TOL):
    """Equal NaN / inf where JAX has them, else within tol."""
    got, want = float(got), float(want)
    if np.isnan(want) or np.isinf(want):
        return got == want or (np.isnan(got) and np.isnan(want))
    return abs(got - want) <= tol


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------- metrics
@pytest.mark.parametrize("case", ["random", "flat_target", "same_flat",
                                  "max_le_1", "target_is_g"])
def test_score_pair_gray_matches_jax(case):
    g, x, _ = _images(1)
    g, x = g.astype(np.float64), x.astype(np.float64)
    if case == "flat_target":    # data range 0: SSIM ~0, PSNR -inf
        x[:] = 128
    elif case == "same_flat":    # 0/0: SSIM NaN, PSNR +inf
        x[:] = g[:] = 200
    elif case == "max_le_1":     # no division by 255 for these images
        g, x = g / 300.0, x / 300.0
    elif case == "target_is_g":
        x = g.copy()
    got = metrics.score_pair_gray(_t(g), _t(x))
    for i in range(g.shape[0]):
        want = jmetrics.score_pair_gray(g[i], x[i])
        for k in KEYS:
            assert _close(got[k][i], want[k]), (case, i, k, got[k][i],
                                                want[k])


def test_gray_partly_flat_target_is_nan_as_in_jax():
    """Windows where both images hold one value give 0/0 at a flat
    target's data range 0, in both."""
    g, x, _ = _images(2, n=2)
    x[:] = 128
    g[:, :12] = 50
    got = metrics.score_pair_gray(_t(g), _t(x))
    for i in range(2):
        want = jmetrics.score_pair_gray(g[i], x[i])
        assert np.isnan(want["ssim"]) and torch.isnan(got["ssim"][i])
        assert want["psnr"] == float(got["psnr"][i]) == -np.inf


@pytest.mark.parametrize("mask_kind", ["graded_2d", "graded_3d", "binary",
                                       "rgb"])
def test_apply_mask_and_masked_protocol_match_jax(mask_kind):
    g, x, mask = _images(3)
    if mask_kind == "graded_3d":
        mask = mask[..., None]
    elif mask_kind == "binary":
        mask = np.where(mask > 127, 255, 0).astype(np.uint8)
    elif mask_kind == "rgb":
        mask = np.stack([mask, mask[:, ::-1], 255 - mask], -1)
    got_m = metrics.apply_mask_uint8(_t(g), _t(mask))
    got = metrics.score_pair_masked(_t(g), _t(x), _t(mask))
    for i in range(g.shape[0]):
        want_m = jmetrics.apply_mask_uint8(g[i], mask[i])
        assert got_m.dtype == torch.uint8
        np.testing.assert_array_equal(got_m[i].numpy(), want_m)
        want = jmetrics.score_pair_masked(g[i], x[i], mask[i])
        for k in KEYS:
            assert _close(got[k][i], want[k]), (mask_kind, i, k)


def test_each_metric_matches_its_jax_twin():
    g, x, _ = _images(4)
    gf, xf = g.astype(np.float64), x.astype(np.float64)
    ssim = metrics.ssim_multichannel(_t(g), _t(x), 255.0)
    psnr = metrics.psnr(_t(x), _t(g), 255.0)
    l1, l2 = metrics.l1_mean_dist(_t(gf), _t(xf)), metrics.l2_mean_dist(
        _t(gf), _t(xf))
    gray = metrics.rgb2gray_batch(_t(g))
    single = metrics.ssim_batch(gray, gray.flip(1), 0.7)
    for i in range(g.shape[0]):
        assert _close(ssim[i], jmetrics.ssim_multichannel(g[i], x[i], 255))
        assert _close(psnr[i], jmetrics.psnr(x[i], g[i], 255))
        assert _close(l1[i], jmetrics.l1_mean_dist(gf[i], xf[i]))
        assert _close(l2[i], jmetrics.l2_mean_dist(gf[i], xf[i]))
        jg = jmetrics.rgb2gray(g[i])
        np.testing.assert_allclose(gray[i].numpy(), jg, rtol=0, atol=1e-15)
        assert _close(single[i], jmetrics.ssim(jg, jg[::-1], 0.7))
    # the numpy preview SSIM the testers use is the JAX package's
    np.testing.assert_array_equal(metrics.ssim_images(gf, xf),
                                  jmetrics.ssim_images(gf, xf))


# ------------------------------------------------------------ score CLI
def _write_tree(root, n, seed, gens=("G",), flat=(), odd=0):
    """A tester-like PNG tree: G/<idx>_score<s>.png, x_target/<idx>.png,
    mask/<idx>.png (grayscale, graded); the last `odd` samples at another
    size; the samples listed in `flat` with a flat target and rows of the
    generated image flat (SSIM 0/0 and PSNR -inf in both scorers)."""
    rng = np.random.default_rng(seed)
    for d in (*gens, "x_target", "mask"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n):
        h = 24 if i >= n - odd else 32
        g, x, m = _images(int(rng.integers(1 << 30)), n=1, h=h)
        if i in flat:
            x[:] = 128
            g[:, :12] = 50
        Image.fromarray(x[0]).save(os.path.join(root, "x_target",
                                                f"{i:05d}.png"))
        Image.fromarray(m[0]).save(os.path.join(root, "mask", f"{i:05d}.png"))
        for k, gen in enumerate(gens):
            gi = np.roll(g[0], k, axis=0)
            Image.fromarray(gi).save(os.path.join(
                root, gen, f"{i:05d}_score{rng.uniform():.3f}.png"))


def _read(path):
    with open(path) as f:
        return f.read()


def _same_dicts(got, want):
    assert list(got) == list(want)
    for k in want:
        assert _close(got[k], want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("masked", [False, True], ids=["gray", "mask"])
@pytest.mark.parametrize("tree", ["plain", "flat", "two_sizes"])
def test_score_stage1_matches_jax(tmp_path, masked, tree):
    """70 pairs (more than one scoring batch of 64); 'flat' has one flat
    target (NaN SSIM mean, -inf PSNR mean, as in JAX); 'two_sizes' ends
    with 5 pairs at 24x16."""
    _write_tree(str(tmp_path / "t"), 70, 5, flat=(3,) if tree == "flat"
                else (), odd=5 if tree == "two_sizes" else 0)
    name = "score_mask.txt" if masked else "score.txt"
    want = jscore.score_stage1(str(tmp_path), "t", masked=masked)
    want_txt = _read(tmp_path / "t" / name)
    os.remove(tmp_path / "t" / name)
    got = score.score_stage1(str(tmp_path), "t", masked=masked,
                             platform="cpu")
    _same_dicts(got, want)
    assert _read(tmp_path / "t" / name) == want_txt
    if tree == "flat" and not masked:
        assert np.isnan(got["ssim_G_x_mean"])
        assert got["psnr_G_x_mean"] == -np.inf


@pytest.mark.parametrize("masked", [False, True], ids=["gray", "mask"])
def test_score_stage2_matches_jax(tmp_path, masked):
    _write_tree(str(tmp_path / "t"), 20, 6, gens=("G1", "G2"))
    name = "score_mask.txt" if masked else "score.txt"
    want = jscore.score_stage2(str(tmp_path), "t", masked=masked)
    want_txt = _read(tmp_path / "t" / name)
    os.remove(tmp_path / "t" / name)
    got = score.score_stage2(str(tmp_path), "t", masked=masked,
                             platform="cpu")
    _same_dicts(got, want)
    assert _read(tmp_path / "t" / name) == want_txt


@pytest.mark.parametrize("fault", ["mispaired", "duplicate", "short_mask",
                                   "empty"])
def test_pairing_errors_raise_as_in_jax(tmp_path, fault):
    root = tmp_path / "t"
    _write_tree(str(root), 6, 7)
    if fault == "mispaired":
        os.rename(root / "x_target" / "00005.png",
                  root / "x_target" / "00009.png")
    elif fault == "duplicate":
        Image.fromarray(np.zeros((32, 16, 3), np.uint8)).save(
            root / "G" / "00002_again.png")
        os.remove(next((root / "G").glob("00003_*")))
    elif fault == "short_mask":
        os.remove(root / "mask" / "00001.png")
    else:
        for f in (root / "G").iterdir():
            os.remove(f)
        for f in (root / "x_target").iterdir():
            os.remove(f)
    masked = fault == "short_mask"
    with pytest.raises(AssertionError) as want:
        jscore.score_stage1(str(tmp_path), "t", masked=masked)
    with pytest.raises(AssertionError) as got:
        score.score_stage1(str(tmp_path), "t", masked=masked,
                           platform="cpu")
    assert str(got.value) == str(want.value)


def test_cli_scores_a_model12_tree_and_refuses_inception(tmp_path, capsys):
    """The port's model-12 tester writes the tree; the CLI scores it as
    JAX's scorer does; --inception_pb is refused, IS is skipped with a
    line, and without --platform=cpu the CLI needs a card."""
    small = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16,
                 z_num=16)
    tester = ConditionalTransferTester(Config(
        platform="cpu", model_dir=str(tmp_path), **small))
    tester.run(SyntheticLoader(4, 32, 16, seed=2), test_batch_num=2)
    for mask in ([], ["--mask"]):
        name = "score_mask.txt" if mask else "score.txt"
        want = jscore.score_stage1(str(tmp_path), "test_result",
                                   masked=bool(mask))
        want_txt = _read(tmp_path / "test_result" / name)
        capsys.readouterr()
        score.main(["1", str(tmp_path), "test_result", "--platform=cpu",
                    *mask])
        out = capsys.readouterr().out
        assert out.splitlines()[0] == score.IS_SKIPPED
        assert _read(tmp_path / "test_result" / name) == want_txt
        assert want_txt.startswith("Image number: 8\n")
        for k, v in want.items():
            assert f"{k}: {v:.6f}" in out
    score.main(["1", str(tmp_path), "test_result", "--platform=cpu",
                "--no_is", "--inception_pb=/nowhere/graph.pb"])
    assert score.IS_SKIPPED not in capsys.readouterr().out
    with pytest.raises(ValueError, match="TensorFlow.*ROADMAP"):
        score.main(["1", str(tmp_path), "test_result", "--platform=cpu",
                    "--inception_pb=/nowhere/graph.pb"])
    with pytest.raises(SystemExit):
        score.main(["3", str(tmp_path), "test_result", "--platform=cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            score.main(["1", str(tmp_path), "test_result"])


# ------------------------------------------------------------------- IS
def _logits_fn(seed, probs=False):
    """A fixed seeded classifier on [n,H,W,3] float32 batches: pooled
    pixel features times a random matrix -> 1008 logits (or softmax)."""
    w = np.random.default_rng(seed).normal(0, 0.05, (48, 1008))

    def fn(batch):
        b = np.asarray(batch, np.float64)
        feats = b.reshape(b.shape[0], 4, -1, 3).mean(2).reshape(
            b.shape[0], -1) / 255.0
        feats = np.concatenate([feats, feats ** 2, np.sin(feats),
                                np.cos(feats)], 1)
        logits = feats @ w * 20
        if not probs:
            return logits.astype(np.float32)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        return p / p.sum(-1, keepdims=True)
    return fn


@pytest.mark.parametrize("probs", [False, True], ids=["logits", "probs"])
def test_inception_protocol_matches_jax(probs):
    rng = np.random.default_rng(8)
    images = list(rng.integers(0, 256, (253, 16, 8, 3)).astype(np.uint8))
    fn = _logits_fn(9, probs)
    want = jinception.get_inception_score(images, fn)
    got = inception.get_inception_score(
        images, lambda b: fn(b.numpy()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    got4 = inception.get_inception_score(
        torch.from_numpy(np.stack(images)), lambda b: torch.from_numpy(
            np.asarray(fn(b.numpy()))), batch_size=64)
    np.testing.assert_allclose(got4, want, rtol=0, atol=1e-12)
    preds = rng.dirichlet(np.full(30, 0.3), 97)
    np.testing.assert_allclose(
        inception.inception_score_from_probs(preds, splits=7),
        jinception.inception_score_from_probs(preds, splits=7),
        rtol=0, atol=1e-12)
