"""The harness finds each cell's configuration, traffic, entry and
per-layer readers by name, and BENCHMARK.json keeps to its contract."""
import json
import math
import os
import re

import pytest

from benchmarks import spec
from benchmarks.reference import nets

with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_found_by_name(name):
    cell = spec.load_cell(name)
    assert spec.entry(cell).run
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}
    limits = cell.traffic["limits"]
    assert limits and set(limits) <= set(spec.entry(cell).NUMBERS)


def test_unknown_cell_names_the_known_ones():
    with pytest.raises(KeyError, match="market.train.b16"):
        spec.load_cell("no.such.cell")


def test_reader_returns_nothing_without_its_data():
    for m in BENCH["per_layer"]:
        assert spec.reader(m["name"])({"config": {}, "traffic": {}}) is None


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    with open(os.path.join(spec.ROOT, conf["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"] == []
    assert cfg["precision"] == {"dtype": "float32", "tf32": False}
    c, n = cfg["config"], cfg["nets"]
    assert (n["img_H"], n["img_W"], n["hidden"], n["keypoints"],
            n["part_num"]) == (c["img_H"], c["img_W"], c["conv_hidden_num"],
                               c["keypoint_num"], c["part_num"])
    assert (n["encoder"]["parts"], n["encoder"]["z"],
            n["generator"]["z"]) == (c["roi_part_num"], c["roi_z_num"],
                                     c["z_num"])
    depth = int(math.log2(c["img_H"])) - 2
    big = c["img_H"] >= 256
    assert n["encoder"]["repeat"] == depth + big
    assert n["generator"]["repeat"] == depth - big
    assert n["encoder"]["kind"] == ("single" if big else "fg_bg")
    assert n["discriminator"]["stages"] == 4 + big
    assert nets.param_specs(cfg)


def test_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmarks"] and b["command"][1].startswith(
        "benchmarks/")
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    configs = {c["name"] for c in b["configs"]}
    used = {w["config"] for w in b["workloads"]}
    assert used == configs
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(
        b["workloads"])
    for w in b["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert os.path.exists(os.path.join(spec.HERE, "traffic",
                                           f"{w['traffic']}.json"))
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in b["per_layer"]:
        assert m["better"] in ("lower", "higher") and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    setup = [m for m in b["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    assert len(json.dumps(b)) < 64 * 1024
