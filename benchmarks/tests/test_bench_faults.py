"""A run with the timed path broken underneath comes out not correct: the
whole of a run but the look for a card, on the CPU at a tiny width, with
the cell's own limits. Once for each fault the cell can have: a training
step that leaves its state unchanged, half of the batch left out (the
means over the rest), an answer altered where it is produced, and for
transfer a stale answer (the previous batch's images). No cell spans
chips, so none can leave out an exchange between them."""
import time

import pytest
import torch

from benchmarks import harness
from dpig_tpu_torch.apps.stage1_app import Stage1App
from dpig_tpu_torch.apps.testers import ConditionalTransferTester
from dpig_tpu_torch.train import state as train_state

TRAIN = ["market.train.b16", "df256.train.b6"]
GEN = ["market.transfer.b32", "df256.transfer.b16"]


def run(cell):
    result, rows = harness.run_cell(cell, 2 ** 31 + 99, 0.3, False, "cpu",
                                    time.perf_counter())
    return result["correct"], rows


def _half(batch):
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def train_unchanged(mp):
    def apply(self, grads):
        self.count += 1
    mp.setattr(train_state._Optimizer, "apply", apply)


def train_half_batch(mp):
    plain = Stage1App.step_inputs
    mp.setattr(Stage1App, "step_inputs",
               lambda self, batch: plain(self, _half(batch)))


def train_altered(mp):
    plain = Stage1App.train_step

    def step(self, state, batch, mark=None):
        out = plain(self, state, batch, mark)
        return {**out, "g_loss": out["g_loss"] * (1 + 1e-3)}
    mp.setattr(Stage1App, "train_step", step)


def gen_half_batch(mp):
    plain = ConditionalTransferTester.transfer_step

    def step(self, batch):
        outs = plain(self, _half(batch))
        return tuple(torch.cat([o, o]) for o in outs)
    mp.setattr(ConditionalTransferTester, "transfer_step", step)


def gen_altered(mp):
    plain = ConditionalTransferTester.transfer_step

    def step(self, batch):
        images, pose, score = plain(self, batch)
        images = images.clone()
        images[0, 0, 0, 0] += 1.0
        return images, pose, score
    mp.setattr(ConditionalTransferTester, "transfer_step", step)


def gen_stale(mp):
    plain = ConditionalTransferTester.transfer_step
    last = {}

    def step(self, batch):
        out = plain(self, batch)
        prev = last.get("out", out)
        last["out"] = out
        return prev
    mp.setattr(ConditionalTransferTester, "transfer_step", step)


@pytest.mark.parametrize("name", TRAIN + GEN)
def test_sound_run_is_correct(tiny_cell, name):
    ok, rows = run(tiny_cell(name))
    assert ok, rows


@pytest.mark.parametrize("fault", [train_unchanged, train_half_batch,
                                   train_altered])
@pytest.mark.parametrize("name", TRAIN)
def test_train_fault_is_caught(tiny_cell, monkeypatch, name, fault):
    fault(monkeypatch)
    ok, rows = run(tiny_cell(name))
    assert not ok, rows


@pytest.mark.parametrize("fault", [gen_half_batch, gen_altered, gen_stale])
@pytest.mark.parametrize("name", GEN)
def test_transfer_fault_is_caught(tiny_cell, monkeypatch, name, fault):
    fault(monkeypatch)
    ok, rows = run(tiny_cell(name))
    assert not ok, rows
