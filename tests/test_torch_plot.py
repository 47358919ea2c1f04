"""The port's metrics plot (`dpig_tpu_torch/utils/plot.py`, its own copy
of `dpig_tpu/utils/plot.py`) on a metrics.jsonl written by the port's
`Trainer` (model 1 through the CLI twin at a tiny size, 3 steps logged):
`load_metrics` equal to JAX's, and `plot_metrics` writing a PNG of the
size JAX's writes from the same file."""
import json

import numpy as np
from PIL import Image

from dpig_tpu.utils import plot as jplot
from dpig_tpu_torch import main as port_main
from dpig_tpu_torch.utils import plot


def test_metrics_of_the_trainer_load_and_plot_as_in_jax(tmp_path):
    port_main.main([
        "--model=1", "--platform=cpu", "--synthetic_data=true",
        "--max_step=3", "--log_step=1", f"--model_dir={tmp_path}",
        "--img_H=32", "--img_W=16", "--batch_size=4",
        "--conv_hidden_num=16", "--z_num=16"])
    got = plot.load_metrics(str(tmp_path))
    assert got == jplot.load_metrics(str(tmp_path))
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert set(got) == set(recs[0]) - {"step"}
    assert all(len(v) == 3 and np.isfinite([y for _, y in v]).all()
               for v in got.values())
    out = plot.plot_metrics(str(tmp_path))
    assert out == str(tmp_path / "curves.png")
    ref = jplot.plot_metrics(str(tmp_path), str(tmp_path / "jax.png"))
    with Image.open(out) as a, Image.open(ref) as b:
        assert a.format == b.format == "PNG" and a.size == b.size
