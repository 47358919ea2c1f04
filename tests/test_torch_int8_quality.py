"""The port's int8 quality gate (`dpig_tpu_torch/eval/int8_quality.py`)
against the JAX package's `scripts/int8_quality.py`, on the CPU at a tiny
config, on one checkpoint: JAX's `train(3, ...)` writes it (orbax) and
`scripts/orbax_to_torch.py` imports it into the port.

JAX's `check` runs eagerly (`jax.disable_jit()`): its jitted int8 graph
differs from its own eager one on the CPU, and the port's equals the
eager one (tests/test_torch_quant.py). Each side calibrates its own
tables (their scales within 1e-4 relative: float32 statistics summed in
other orders), so an activation on a rounding boundary can land a quantum
apart. The limit is test_torch_quant.py's int8 limit carried to the
gate's numbers: the port's int8 as close to JAX's int8 as JAX's int8 is
to its float, so each SSIM number within half JAX's own int8-vs-float
SSIM gap `1 - SSIM_JAX(int8, float)` of that scheme (readings: at most
0.14 of the gap, the legacy tail fallback; the rest 0.06 or less). Half,
not the whole gap: an int8 path that quietly ran float reads
SSIM(int8, float) = 1, exactly one gap off, and the control test below
holds that it fails the limit. `emb_rel_err`
within a tenth of JAX's (the encoder's mean limit there; reading 1%),
and the float-only SSIM to target within 1e-5 (float32 forwards on both
sides; reading 1.0e-6). A per-layer recovery is a difference of two
unchained mean |err|s, each held to a tenth of JAX's all-int8 one, so
within a fifth of it.
"""
import os
import re
import sys

import jax
import pytest
import torch

from dpig_tpu_torch.config import Config
from dpig_tpu_torch.eval import int8_quality as pq
from dpig_tpu_torch.train import checkpoint as ckpt
from scripts.orbax_to_torch import import_checkpoint

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import int8_quality as jq  # noqa: E402

torch.set_num_threads(1)

TINY = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16,
            compute_dtype="float32")
PTINY = dict(TINY, platform="cpu")
SCHEMES = ("absmax", "percentile 99.9", "per-channel (default)",
           "tail-fallback (legacy)", "tail-fallback (island)", "entropy")
SSIM_KEYS = ("ssim_int8_float", "ssim_to_target_int8", "delta")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """(JAX model_dir, port model_dir holding the same weights, JAX's
    gate context built once: its forwards run eagerly under
    disable_jit)."""
    root = tmp_path_factory.mktemp("q")
    jdir, pdir = str(root / "jax"), str(root / "port")
    jq.train(3, jdir, pool_size=2, cfg_overrides=TINY)
    import_checkpoint(jdir, pdir)
    return jdir, pdir, jq._gate_context(jdir, 2, TINY)


def _jax_check(ckpts, **kw):
    jdir, _, ctx = ckpts
    with jax.disable_jit():
        return jq.check(jdir, n_batches=2, cfg_overrides=TINY, ctx=ctx, **kw)


def _assert_close(got, want):
    gap = 1.0 - want["ssim_int8_float"]
    assert 0.0 < gap < 0.2, want
    for k in SSIM_KEYS:
        assert abs(got[k] - want[k]) <= gap / 2, (k, got[k], want[k], gap)
    assert abs(got["ssim_to_target_float"]
               - want["ssim_to_target_float"]) <= 1e-5
    if "emb_rel_err" in want:
        assert abs(got["emb_rel_err"] - want["emb_rel_err"]) <= \
            want["emb_rel_err"] / 10, (got, want)


@pytest.fixture(scope="module")
def sweeps(ckpts):
    """JAX's sweep (eager, on the shared context) and the port's."""
    jdir, pdir, ctx = ckpts
    patch = pytest.MonkeyPatch()
    patch.setattr(jq, "_gate_context", lambda *a, **k: ctx)
    try:
        with jax.disable_jit():
            want = jq.sweep(jdir, n_batches=2, cfg_overrides=TINY)
    finally:
        patch.undo()
    return pq.sweep(pdir, n_batches=2, cfg_overrides=PTINY), want


def test_sweep_has_all_six_schemes(sweeps):
    got, want = sweeps
    assert tuple(got) == tuple(want) == SCHEMES
    for label, r in got.items():
        assert 0.0 <= r["ssim_int8_float"] <= 1.0 and abs(r["delta"]) < 0.5


@pytest.mark.parametrize("scheme", SCHEMES)
def test_sweep_scheme_matches_jax_eager(sweeps, scheme):
    got, want = sweeps
    _assert_close(got[scheme], want[scheme])


def test_a_check_that_never_quantizes_fails_the_limit(ckpts, sweeps):
    """The control: the port's check with its int8 forward swapped for
    the float one (the table built, never applied) reads
    SSIM(int8, float) = 1 and delta = 0, and `_assert_close` must refuse
    it against JAX's default scheme."""
    ctx = pq._gate_context(ckpts[1], 2, PTINY)
    fwd_f = ctx["fwd_f"]
    ctx["fwds"] = dict.fromkeys((True, False),
                                lambda e, po, q=None: fwd_f(e, po))
    got = pq.check(ckpts[1], n_batches=2, cfg_overrides=PTINY, ctx=ctx)
    assert got["ssim_int8_float"] == 1.0 and got["delta"] == 0.0
    with pytest.raises(AssertionError, match="ssim_int8_float"):
        _assert_close(got, sweeps[1]["per-channel (default)"])


def _per_layer_rows(text):
    base = float(re.search(r"all-int8 \(unchained\) mean\|err\| = "
                           r"([-0-9.]+)", text).group(1))
    rows = re.findall(r"^    (\S+)\s+([-+][0-9.]+)$", text, re.M)
    return base, {n: float(v) for n, v in rows}


def test_check_and_per_layer_match_jax_eager(ckpts, sweeps, capsys):
    """The plain check (the shipping default: per-channel, chained) with
    --per_layer: the four numbers, and the six top recoveries JAX prints
    against the port's for the same layers."""
    want = _jax_check(ckpts, per_layer=True)
    base, want_rows = _per_layer_rows(capsys.readouterr().out)
    got = pq.check(ckpts[1], n_batches=2, per_layer=True,
                   cfg_overrides=PTINY)
    got_base, got_rows = _per_layer_rows(capsys.readouterr().out)
    _assert_close(got, want)
    assert {k: got[k] for k in want} == sweeps[0]["per-channel (default)"]
    assert len(want_rows) == 6 and len(got["per_layer"]) == 18
    assert abs(got_base - base) <= base / 10, (got_base, base)
    for name, rec in want_rows.items():
        assert abs(got["per_layer"][name] - rec) <= base / 5, (name, rec)
    assert list(got_rows) == sorted(got["per_layer"], key=lambda n: (
        got["per_layer"][n], n), reverse=True)[:6]


def test_transfer_check_matches_jax_eager(ckpts):
    """--transfer: the int8 FG/BG encoder feeding the int8 generator."""
    want = _jax_check(ckpts, transfer=True)
    got = pq.check(ckpts[1], n_batches=2, transfer=True,
                   cfg_overrides=PTINY)
    assert 0.0 < want["emb_rel_err"] < 1.0
    _assert_close(got, want)


def test_transfer_at_256_raises_before_any_restore(tmp_path):
    """No int8 encoder exists at 256: both refuse before reading a
    checkpoint (the empty model_dir would fail otherwise)."""
    big = dict(TINY, img_H=256, img_W=256)
    with pytest.raises(AssertionError, match="256") as want:
        jq.check(str(tmp_path), n_batches=2, transfer=True,
                 cfg_overrides=big)
    with pytest.raises(AssertionError, match="256") as got:
        pq.check(str(tmp_path), n_batches=2, transfer=True,
                 cfg_overrides=dict(big, platform="cpu"))
    assert "no int8 encoder exists at 256" in str(want.value)
    assert "no int8 encoder exists at 256" in str(got.value)
    with pytest.raises(AssertionError, match="no checkpoint"):
        pq.check(str(tmp_path), n_batches=2, cfg_overrides=PTINY)


def test_gen_repeat_and_df256_match_jax():
    assert pq.DF256 == jq.DF256 and pq.DF256["batch_size"] <= 32
    for kw in ({"img_H": 128, "img_W": 64}, pq.DF256):
        assert pq._gen_repeat(Config(**kw)) == 5
    assert Config(**pq.DF256).repeat_num == 6


def test_gate_and_its_exit_code(ckpts, monkeypatch, capsys):
    """JAX's test thresholds: passes at (0.5, 0.0), fails at min_ssim 1.1,
    returning either way; the CLI returns 0 / 1 by the verdict. The CLI
    reaches the tiny config through --size=256's overrides, set here to
    it."""
    pdir = ckpts[1]
    assert pq.gate(pdir, max_delta=0.5, min_ssim=0.0,
                   cfg_overrides=PTINY) is True
    assert pq.gate(pdir, max_delta=0.5, min_ssim=1.1,
                   cfg_overrides=PTINY) is False
    assert pq.gate(pdir, max_delta=0.5, min_ssim=0.0, transfer=True,
                   cfg_overrides=PTINY) is True
    monkeypatch.setattr(pq, "DF256", TINY)
    argv = ["gate", pdir, "--size=256", "--platform=cpu", "--max_delta=0.5"]
    capsys.readouterr()
    assert pq.main(argv + ["--min_ssim=0.0"]) == 0
    assert "[PASS]" in capsys.readouterr().out
    assert pq.main(argv + ["--min_ssim=1.1"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL]" in out and "remedy order" in out
    assert pq.main(["check", pdir, "--size=256", "--platform=cpu",
                    "--method=absmax", "--fallback=dec/Conv_7,to_rgb",
                    "--fallback_mode=legacy"]) == 0
    assert "legacy per-layer-quant routing" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pq.main(["gate", pdir])


def test_train_resumes_the_imported_checkpoint_and_guards(ckpts, tmp_path,
                                                          capsys):
    """The port's train resumes JAX's imported step-3 state (step from the
    directory's name), writes step 5 named by its step, and a target at
    or below the newest step writes nothing."""
    pdir = str(tmp_path / "m")
    import_checkpoint(ckpts[0], pdir)
    pq.train(5, pdir, pool_size=2, cfg_overrides=PTINY)
    out = capsys.readouterr().out
    assert "(step 3)" in out and "[4] g_loss=" in out
    newest = ckpt.latest_checkpoint(pdir)
    assert newest.endswith("step_00000005")
    assert ckpt.load_tree(newest)["step"] == 5
    before = sorted(os.listdir(os.path.join(pdir, "ckpt")))
    for target in (2, 5):
        pq.train(target, pdir, pool_size=2, cfg_overrides=PTINY)
        assert "nothing to do" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(pdir, "ckpt"))) == before
