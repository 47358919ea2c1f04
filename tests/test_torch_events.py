"""The port's TensorBoard events (`train/events.py`, written by the
Trainer) against the JAX package's (`dpig_tpu/train/harness.py`, through
tf.summary, TF being installed here): the same `loss/<k>` scalars at the
same steps, and the same histogram buckets, read back by TensorFlow's
`summary_iterator` (eagerly); a model-1 run through the CLI twin writes
an event file whose scalars are the rows of its metrics.jsonl."""
import glob
import json
import os

import numpy as np
import pytest
import tensorflow as tf
import torch

from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.train.harness import Trainer as JaxTrainer
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.train.events import histogram_buckets
from dpig_tpu_torch.train.harness import Trainer

torch.set_num_threads(1)

SMALL = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16)


@pytest.fixture(scope="module", autouse=True)
def tf_eager():
    """TensorFlow runs eagerly here whatever an earlier test of this
    worker left on (tests/test_tf1_import.py turns graph mode on for the
    rest of its process), and as it was after this module."""
    from tensorflow.python.eager import context
    with context.eager_mode():
        yield


def _read(model_dir):
    """{(step, tag): float or [k,3] array} of the event files in
    model_dir, and the file version."""
    out, version = {}, None
    for path in glob.glob(os.path.join(model_dir, "*tfevents*")):
        for event in tf.compat.v1.train.summary_iterator(path):
            if event.file_version:
                version = event.file_version
            for v in event.summary.value:
                if v.HasField("tensor"):
                    val = tf.make_ndarray(v.tensor)
                    val = float(val) if val.ndim == 0 else val
                else:
                    val = v.simple_value
                out[event.step, v.tag] = val
    return out, version


def test_scalars_and_histograms_match_the_jax_harness(tmp_path):
    rng = np.random.default_rng(0)
    rows = [(0, {"g_loss": 1.25, "d_loss": 0.5, "imgs_per_sec": 123.4},
             {"fg_real": rng.normal(size=(4, 224))}),
            (7, {"g_loss": -3e-7, "d_loss": 1e6, "imgs_per_sec": 0.1},
             {"fg_real": np.full((4, 3), 2.5), "bg": rng.uniform(
                 -1, 1, (2, 128)).astype(np.float32)})]
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jt = JaxTrainer(JaxConfig(model_dir=jax_dir, **SMALL), None, None,
                    use_mesh=False)
    assert jt._tb is not None
    pt = Trainer(Config(platform="cpu", model_dir=port_dir, **SMALL), None,
                 None)
    for step, metrics, hists in rows:
        jt.log_metrics(step, metrics, hists)
        pt.log_metrics(step, metrics, hists)
    pt.events.close()
    want, _ = _read(jax_dir)
    got, version = _read(port_dir)
    assert version == "brain.Event:2"
    assert sorted(got) == sorted(want)
    assert {tag for _, tag in got} >= {"loss/g_loss", "loss/fg_real_mean",
                                       "loss/bg_std", "fg_real", "bg"}
    for key, w in want.items():
        if isinstance(w, float):
            assert got[key] == np.float32(w), key
        else:
            np.testing.assert_array_equal(got[key][:, 2], w[:, 2])
            np.testing.assert_allclose(got[key][:, :2], w[:, :2],
                                       rtol=1e-12, atol=0)


@pytest.mark.parametrize("values", [np.zeros(0), np.full(5, -2.0),
                                    np.arange(100.0) ** 2])
def test_histogram_buckets_of_edge_cases(values):
    table = histogram_buckets(values)
    assert table.shape == (30, 3) and table[:, 2].sum() == values.size
    if values.size > 1 and np.ptp(values):
        assert table[0, 0] == values.min() and table[-1, 1] == values.max()


def test_cli_run_writes_its_metrics_as_events(tmp_path):
    from dpig_tpu_torch.main import main as port_main
    out = str(tmp_path / "m1")
    port_main(["--model=1", "--platform=cpu", "--synthetic_data=true",
               "--max_step=2", "--log_step=1", f"--model_dir={out}",
               *(f"--{k}={v}" for k, v in SMALL.items())])
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    got, _ = _read(out)
    assert len(glob.glob(os.path.join(out, "*tfevents*"))) == 1
    want = {(r["step"], f"loss/{k}"): np.float32(v) for r in rows
            for k, v in r.items() if k != "step"}
    assert {k: np.float32(v) for k, v in got.items()} == want
