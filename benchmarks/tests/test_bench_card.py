"""On the card (marked `cuda`, skipped elsewhere): the control, the
reference in float32 with TF32 on in cuBLAS and cuDNN put in the
program's place, fails the cell's limits, on three seeds, at the cell's
widths and a batch the test holds quickly; and the program itself passes
them there."""
import pytest
import torch

from benchmarks import check, harness, spec
from benchmarks.entries import stage1_train, transfer

SEEDS = [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3]


def small(name, batch):
    cell = spec.load_cell(name)
    cell.traffic["batch_size"] = batch
    return cell


def numbers(cell, seed, dev, control):
    s = harness.Seeds(seed)
    if cell.traffic["entry"] == "stage1_train":
        ref = stage1_train.reference_steps(cell, s, dev)
        got = (stage1_train.reference_steps(cell, s, dev, torch.float32,
                                            tf32=True) if control
               else stage1_train.program_numbers(cell, s, dev))
        return check.train_numbers(got, ref)
    kept = transfer.program_outputs(cell, s, dev)
    ref = transfer.reference_pairs(cell, s, dev, kept)
    if not control:
        return check.transfer_numbers(ref)
    ctrl = transfer.reference_pairs(cell, s, dev, kept, torch.float32,
                                    tf32=True)
    return check.transfer_numbers([(c, r) for (_, r), (_, c)
                                   in zip(ref, ctrl)])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,batch", [("market.train.b16", 4),
                                        ("df256.train.b6", 2),
                                        ("market.transfer.b32", 4),
                                        ("df256.transfer.b16", 2)])
def test_control_fails_and_program_passes(card, name, batch, seed):
    cell = small(name, batch)
    dev = harness.Device("cuda")
    limits = cell.traffic["limits"]
    assert not check.judge(numbers(cell, seed, dev, True), limits)[0]
    ok, rows = check.judge(numbers(cell, seed, dev, False), limits)
    assert ok, rows
