"""The plain reference against the program, on the CPU at a tiny width:
the same weights (drawn by the benchmark, loaded strictly into the
program's nets), the same batches, the program in float32 and the
reference in float64: the gaps are the program's round-off, within the
cells' limits."""
import pytest
import torch

from benchmarks import check, harness, weights
from benchmarks.entries import stage1_train, transfer
from benchmarks.reference import pose as ref_pose
from dpig_tpu_torch.ops.pose import render_pose_maps_plain

CPU = harness.Device("cpu")
TRAIN = ["market.train.b16", "df256.train.b6"]
GEN = ["market.transfer.b32", "df256.transfer.b16"]


@pytest.mark.parametrize("name", TRAIN)
def test_train_steps_match(tiny_cell, name):
    cell = tiny_cell(name)
    s = harness.Seeds(2 ** 31 + 7)
    prog = stage1_train.program_numbers(cell, s, CPU)
    ref = stage1_train.reference_steps(cell, s, CPU)
    ok, rows = check.judge(check.train_numbers(prog, ref),
                           cell.traffic["limits"])
    assert ok, rows
    assert len(prog["losses"]) == cell.traffic["checked_steps"]


@pytest.mark.parametrize("name", GEN)
def test_transfer_matches(tiny_cell, name):
    cell = tiny_cell(name)
    s = harness.Seeds(11)
    kept = transfer.program_outputs(cell, s, CPU)
    numbers = check.transfer_numbers(transfer.reference_pairs(cell, s, CPU,
                                                              kept))
    assert numbers["pose_mismatch"] == 0
    ok, rows = check.judge(numbers, cell.traffic["limits"])
    assert ok, rows


def test_weights_follow_the_seed(tiny_cell):
    cfg = tiny_cell("market.train.b16").config
    a, b = weights.draw(cfg, 5, "cpu"), weights.draw(cfg, 5, "cpu")
    c = weights.draw(cfg, 6, "cpu")
    for net in a:
        for k in a[net]:
            assert torch.equal(a[net][k], b[net][k])
    assert not torch.equal(a["ID_AE"]["stem_kernel"], c["ID_AE"]["stem_kernel"])


@pytest.mark.parametrize("hw", [(128, 64), (256, 256), (32, 16)])
def test_pose_reference_is_the_programs_plain_raster(hw):
    g = torch.Generator().manual_seed(hw[0])
    b, k = 3, 18
    rcv = torch.stack([torch.rand(b, k, generator=g) * (hw[0] + 8) - 4,
                       torch.rand(b, k, generator=g) * (hw[1] + 8) - 4,
                       (torch.rand(b, k, generator=g) > 0.3).float()], -1)
    assert torch.equal(ref_pose.render_pose_maps(rcv, *hw),
                       render_pose_maps_plain(rcv, *hw))
