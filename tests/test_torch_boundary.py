"""The port imports nothing of JAX, of the JAX package or of TensorFlow
(it reads TF1 checkpoints itself, `train/tf1_bundle.py`), and refuses to
run on the CPU unless asked."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from dpig_tpu_torch.apps.common import select_device
from dpig_tpu_torch.apps.testers import ConditionalTransferTester
from dpig_tpu_torch.config import Config

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "dpig_tpu",
             "tensorflow"}


def _port_files():
    return sorted((ROOT / "dpig_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_no_port_module_imports_scripts_or_protobuf():
    """`scripts/` (the orbax importer imports both packages) and protobuf /
    google_crc32c (the port parses and checksums tfrecords itself) stay
    out of the port and of chip_smoke.py."""
    bad = {str(p.relative_to(ROOT)): sorted(
        set(_imported_roots(p)) & {"scripts", "google", "google_crc32c"})
        for p in _port_files()}
    assert not {k: v for k, v in bad.items() if v}


def test_the_scan_sees_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom dpig_tpu.ops import pose\n"
                 "import tensorflow.compat.v1 as tf1\n")
    assert {"dpig_tpu", "tensorflow"} <= set(_imported_roots(f))
    assert "dpig_tpu_torch" not in FORBIDDEN


def test_the_tf1_import_loads_no_tensorflow():
    """Importing the TF1 reader, the importer and the CLI twin (where
    TensorFlow is installed, as here) loads no TensorFlow module."""
    code = ("import sys; import dpig_tpu_torch.train.tf1_import, "
            "dpig_tpu_torch.train.tf1_bundle, dpig_tpu_torch.main; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'tensorflow'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_default_platform_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        select_device("")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConditionalTransferTester(Config(model_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="platform"):
        select_device("tpu")
    assert select_device("cpu") == torch.device("cpu")
