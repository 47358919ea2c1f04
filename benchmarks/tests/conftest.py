"""Fixtures of the benchmark's own tests: a cell of BENCHMARK.json cut to
a size the CPU runs in seconds (the same entry, traffic and limits; 32x16
images, hidden 8, batch 4), and the card marker. Whether a card is there
is decided inside the `card` fixture, never at import."""
import copy
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmarks import spec  # noqa: E402

torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped without one")


def tiny(cell: spec.Cell, batch_size: int = 0) -> spec.Cell:
    """`cell` at a width the CPU runs in seconds: hidden 8, z 8 and 32x16
    images for the Market nets (batch 4); hidden 4, z 4 at 256x256 for
    the DeepFashion nets, whose single-branch encoder the program builds
    from 256 pixels on (batch 2). The check compares every batch of a
    short window."""
    c = copy.deepcopy(cell)
    n = c.config["nets"]
    if n["encoder"]["kind"] == "fg_bg":
        hw, width, b = {"img_H": 32, "img_W": 16}, 8, 4
        n["encoder"]["repeat"] = n["generator"]["repeat"] = 3
    else:
        hw, width, b = {}, 8, 2
    c.config["config"].update(hw, conv_hidden_num=width, z_num=width)
    n.update(hw, hidden=width)
    n["generator"]["z"] = width
    c.traffic.update(batch_size=batch_size or b, check_span=3,
                     check_batches=2)
    return c


@pytest.fixture
def tiny_cell():
    return lambda name, **kw: tiny(spec.load_cell(name), **kw)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
