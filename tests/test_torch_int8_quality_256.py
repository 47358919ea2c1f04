"""The port's int8 quality gate at the DeepFashion model-101 shape
(`--size=256`: 256x256, the generator at repeat_num - 1 = 5, the
single-branch encoder), on the CPU at a narrow width (hidden 4, z 4,
batch 2): its own train, the six-scheme sweep with the tail fallback at
the 256 depth's last decoder pair, the gate and --per_layer. The JAX
package's gate is held against the port at 32x16
(tests/test_torch_int8_quality.py); this file checks that the 256 path
runs end to end and gives numbers in range.
"""
import os

import pytest
import torch

from dpig_tpu_torch.eval import int8_quality as pq
from dpig_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

NARROW = dict(pq.DF256, conv_hidden_num=4, z_num=4, batch_size=2,
              platform="cpu")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("q256"))
    pq.train(2, d, pool_size=2, cfg_overrides=NARROW)
    return d


def test_train_at_256_writes_its_step(model_dir):
    path = ckpt.latest_checkpoint(model_dir)
    assert path.endswith("step_00000002")
    tree = ckpt.load_tree(path)
    assert tree["step"] == 2
    # the 256 generator: 5 stages, so 3*5-1 decoder convs (dec/Conv_0..13)
    assert any(k.startswith("Conv_13.") for k in tree["g_params"]["ID_AE"])
    assert not any(k.startswith("Conv_14.")
                   for k in tree["g_params"]["ID_AE"])


def test_sweep_at_256_has_six_rows_and_the_256_tail(model_dir, capsys):
    rows = pq.sweep(model_dir, n_batches=2, cfg_overrides=NARROW)
    out = capsys.readouterr().out
    assert tuple(rows) == ("absmax", "percentile 99.9",
                           "per-channel (default)", "tail-fallback (legacy)",
                           "tail-fallback (island)", "entropy")
    assert "['dec/Conv_12', 'dec/Conv_13', 'to_rgb']" in out
    assert "[!]" not in out
    for label, r in rows.items():
        assert 0.5 < r["ssim_int8_float"] <= 1.0, (label, r)
        assert abs(r["delta"]) < 0.1, (label, r)


def test_gate_and_per_layer_at_256(model_dir):
    assert pq.gate(model_dir, max_delta=0.5, min_ssim=0.0,
                   cfg_overrides=NARROW) is True
    assert pq.gate(model_dir, max_delta=0.5, min_ssim=1.1,
                   cfg_overrides=NARROW) is False
    r = pq.check(model_dir, n_batches=2, per_layer=True,
                 cfg_overrides=NARROW)
    # 14 tower + 14 decoder convs, to_rgb and the stem's pose part
    assert len(r["per_layer"]) == 30
    assert {"g_stem", "to_rgb", "enc/Conv_13", "dec/Conv_13"} <= set(
        r["per_layer"])


def test_batch_is_capped_at_32_for_256(model_dir, monkeypatch):
    seen = []
    real = pq.SyntheticLoader

    def loader(b, h, w, seed):
        seen.append((b, h, w, seed))
        return real(2, h, w, seed=seed)

    monkeypatch.setattr(pq, "SyntheticLoader", loader)
    pq.check(model_dir, n_batches=2,
             cfg_overrides=dict(NARROW, batch_size=64))
    assert seen == [(32, 256, 256, pq.HELD_OUT_SEED)]
