"""The port imports nothing of JAX or of the JAX package, and refuses to
run on the CPU unless asked."""
import ast
import pathlib

import pytest
import torch

from dpig_tpu_torch.apps.common import select_device
from dpig_tpu_torch.apps.testers import ConditionalTransferTester
from dpig_tpu_torch.config import Config

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "dpig_tpu"}


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


def test_the_scan_sees_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom dpig_tpu.ops import pose\n")
    assert "dpig_tpu" in set(_imported_roots(f))
    assert "dpig_tpu_torch" not in FORBIDDEN


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
