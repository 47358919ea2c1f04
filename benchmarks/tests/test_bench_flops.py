"""The FLOP count behind `train.mfu` and `gen.mfu` is the reference's:
swapping the program's modules leaves it unchanged, and at a tiny width
it is within a percent of what PyTorch's counter sees the program do (the
reference spells out none of the program's work twice)."""
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmarks import harness, spec, weights
from benchmarks.entries import stage1_train, transfer
from benchmarks.reference import flops
from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.models import generator

CPU = harness.Device("cpu")


def test_count_ignores_the_program(monkeypatch):
    cfg = spec.load_cell("market.train.b16").config
    before = flops.train_step_flops(cfg, 16), flops.transfer_flops(cfg, 32)

    def broken(self, embs, pose):
        raise AssertionError("the count ran the program")
    monkeypatch.setattr(generator.UAEGenerator, "forward", broken)
    assert (flops.train_step_flops(cfg, 16),
            flops.transfer_flops(cfg, 32)) == before


@pytest.mark.parametrize("name", ["market.train.b16", "df256.train.b6"])
def test_train_count_is_the_programs_work(tiny_cell, name, tmp_path):
    cell = tiny_cell(name)
    s = harness.Seeds(3)
    cfg = stage1_train.program_config(cell, "cpu", str(tmp_path))
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    app = Stage1App(cfg, CPU.torch,
                    state=weights.draw(cell.config, s.weights, "cpu"))
    state = app.init_state()
    batch = batch_to_device(stage1_train.host_ring(cell, s)[0], CPU.torch)
    with FlopCounterMode(display=False) as counter:
        app.train_step(state, batch)
    ours = flops.train_step_flops(cell.config, cell.traffic["batch_size"])
    assert abs(ours - counter.get_total_flops()) <= 0.01 * ours


@pytest.mark.parametrize("name", ["market.transfer.b32",
                                  "df256.transfer.b16"])
def test_transfer_count_is_the_programs_work(tiny_cell, name, tmp_path):
    cell = tiny_cell(name)
    s = harness.Seeds(3)
    tester = transfer.build(cell, s, CPU, str(tmp_path))
    batch = batch_to_device(transfer.host_ring(cell, s)[0], CPU.torch)
    with FlopCounterMode(display=False) as counter:
        tester.transfer_step(batch)
    ours = flops.transfer_flops(cell.config, cell.traffic["batch_size"])
    assert abs(ours - counter.get_total_flops()) <= 0.01 * ours


@pytest.mark.parametrize("name", ["market_128x64", "deepfashion_256x256"])
def test_count_scales_with_the_batch(name):
    with open(os.path.join(spec.HERE, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    assert flops.train_step_flops(cfg, 6) == 6 * flops.train_step_flops(
        cfg, 1)
    assert flops.transfer_flops(cfg, 16) == 16 * flops.transfer_flops(cfg, 1)
