"""The port's recipe scripts (`scripts/port_run_*.sh`) beside the JAX
package's (`scripts/run_*.sh`): both parse (`bash -n`); with the port's
entry points read as the JAX ones (`python -m dpig_tpu_torch.main` as
`python main.py`, `python -m dpig_tpu_torch.eval.score` as
`python -m dpig_tpu.eval.score`) and the train recipes' TF1-import branch
set aside, every command, flag and `ckpt/step_*` lookup is the same, step
by step; every flag they pass is a field of the port's Config (its parser
ignores unknown flags)."""
import dataclasses
import pathlib
import re
import subprocess

import pytest

from dpig_tpu_torch.config import Config

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"
RECIPES = ("market_train", "market_test", "DF_train", "DF_test")
PORT_NAMES = {"python -m dpig_tpu_torch.main": "python main.py",
              "python -m dpig_tpu_torch.eval.score":
                  "python -m dpig_tpu.eval.score"}


def _commands(path, port):
    """The script's non-comment lines, continuations joined, the port's
    entry points and usage texts read as the JAX script's, the TF1 block
    and its argument left out."""
    lines = [ln.strip() for ln in path.read_text().replace(
        "\\\n", " ").splitlines()]
    lines = [" ".join(ln.split()) for ln in lines
             if ln and not ln.startswith("#")]
    if port:
        if 'if [ -n "$TF1" ]; then' in lines:
            start = lines.index('if [ -n "$TF1" ]; then')
            lines = lines[:start] + lines[lines.index("fi", start) + 1:]
        lines = [ln for ln in lines if ln != "TF1=${3:-}"]
        out = []
        for ln in lines:
            for new, old in PORT_NAMES.items():
                ln = ln.replace(new, old)
            out.append(ln)
        lines = out
    return [re.sub(r"usage: [^}]*", "usage", ln) for ln in lines]


def _steps(lines):
    return [ln for ln in lines if ln.startswith(tuple(PORT_NAMES.values()))]


@pytest.mark.parametrize("name", RECIPES)
def test_port_recipe_is_the_jax_recipe_step_by_step(name):
    port = SCRIPTS / f"port_run_{name}.sh"
    ref = SCRIPTS / f"run_{name}.sh"
    for path in (port, ref):
        subprocess.run(["bash", "-n", str(path)], check=True, timeout=30)
    got, want = _commands(port, True), _commands(ref, False)
    assert len(_steps(got)) == len(_steps(want)) >= 3
    for a, b in zip(_steps(got), _steps(want)):
        assert a == b
    assert got == want
    text = port.read_text()
    assert "python main.py" not in text and "dpig_tpu.eval" not in text


@pytest.mark.parametrize("name", RECIPES)
def test_every_port_recipe_flag_is_a_config_field(name):
    fields = {f.name for f in dataclasses.fields(Config)}
    flags = set(re.findall(r"--([A-Za-z_]+)=", (
        SCRIPTS / f"port_run_{name}.sh").read_text()))
    assert flags and flags <= fields, flags - fields


@pytest.mark.parametrize("name", ("market_train", "DF_train"))
def test_train_recipe_imports_a_tf1_prefix(name):
    text = (SCRIPTS / f"port_run_{name}.sh").read_text()
    block = text[text.index('if [ -n "$TF1" ]; then'):]
    block = block[:block.index("\nfi\n")]
    assert "python -m dpig_tpu_torch.train.tf1_import" in block
    assert '--ckpt_path="$TF1"' in block and "exit 0" in block
    size = "128 --img_W=64" if name.startswith("market") else \
        "256 --img_W=256"
    assert f"--img_H={size}" in block
    stages = re.findall(r"\$LOG_DIR\"?/(\w+)/ckpt/step_\*", (
        SCRIPTS / f"run_{name.replace('train', 'test')}.sh").read_text())
    assert stages and all(s in block for s in stages), stages
