"""The span recorder (`dpig_tpu_torch/utils/spans.py`) and the spans the
port records: off by default and free when off, the same numbers on and
off, what one Trainer step and one transfer batch record, the order of
the backward split, and the summary's self time."""
import types

import pytest
import torch

from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.apps.stage1_app import Stage1App
from dpig_tpu_torch.apps.testers import ConditionalTransferTester
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.data.synthetic import SyntheticLoader
from dpig_tpu_torch.train import checkpoint as ckpt
from dpig_tpu_torch.train.harness import Trainer
from dpig_tpu_torch.utils import profiling, spans

torch.set_num_threads(1)

SMALL = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16)


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def trainer(tmp_path, fast=False):
    cfg = Config(platform="cpu", model_dir=str(tmp_path), fast_gan_step=fast,
                 **SMALL)
    app = Stage1App(cfg, torch.device("cpu"))
    t = Trainer(cfg, app, SyntheticLoader(4, 32, 16, seed=1))
    return t, t.init_state()


def test_the_recorder_is_off_by_default_and_records_nothing():
    assert not spans.enabled()
    a, b = spans.span("a"), spans.span("b")
    assert a is b
    with a as s:
        assert s is None
    assert spans.summary() == {}


def test_off_it_makes_no_event_annotation_or_hook(tmp_path, monkeypatch):
    """A Trainer step and a transfer batch with the recorder off create no
    CUDA event, open no record_function and register no tensor hook."""
    t, state = trainer(tmp_path)
    tester = ConditionalTransferTester(
        Config(platform="cpu", model_dir=str(tmp_path), **SMALL))
    batch = next(SyntheticLoader(4, 32, 16, seed=2))

    def refuse(*args, **kwargs):
        raise AssertionError("made while the recorder was off")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.Tensor, "register_hook", refuse)
    t.step(state)
    tester.transfer_step(batch_to_device(batch, tester.device))
    assert spans.summary() == {}


def state_after_steps(tmp_path, fast, on):
    t, state = trainer(tmp_path, fast)
    if on:
        spans.enable()
    metrics = [t.step(state) for _ in range(2)]
    spans.disable()
    return metrics, ckpt.state_tree(state)


@pytest.mark.parametrize("fast", [False, True])
def test_on_and_off_compute_the_same_bits(tmp_path, fast):
    """Two Stage-I steps with the recorder on give the metrics, the
    parameters and the D statistics of two steps with it off."""
    (m0, s0), (m1, s1) = (state_after_steps(tmp_path / str(on), fast, on)
                          for on in (False, True))
    assert spans.summary()["trainer.step"]["count"] == 2
    for a, b in zip(m0, m1):
        assert {k: float(v) for k, v in a.items()} == {
            k: float(v) for k, v in b.items()}
    assert s0["step"] == s1["step"] == 2
    for key in ("g_params", "d_params", "d_stats"):
        for net, tensors in s0[key].items():
            for n, v in tensors.items():
                assert torch.equal(v, s1[key][net][n]), (key, net, n)


@pytest.mark.parametrize("fast", [False, True])
def test_one_trainer_step_records_each_layer_once_per_pass(tmp_path, fast):
    """One Trainer.step: the step, its copy-in with the batch's bytes, an
    encoder and a generator forward for the G step and for the re-forward
    (the G step's alone with --fast_gan_step), and each net's backward,
    all under the step and with its id."""
    t, state = trainer(tmp_path, fast)
    host = next(SyntheticLoader(4, 32, 16, seed=1))
    spans.enable()
    t.step(state)
    table = spans.summary()
    forwards = 1 if fast else 2
    assert {k: v["count"] for k, v in table.items()} == {
        "trainer.step": 1, "copy_in": 1, "encoder": forwards,
        "generator": forwards, "generator.backward": 1,
        "encoder.backward": 1}
    assert table["copy_in"]["counts"]["bytes"] == sum(
        v.nbytes for v in host.values())
    assert table["trainer.step"]["parent"] == [None]
    for name, row in table.items():
        assert row["step"] == [1] * row["count"], name
        if name != "trainer.step":
            assert row["parent"] == ["trainer.step"] * row["count"], name
        assert all(ms >= 0 for ms in row["device_ms"] + row["self_ms"])


def test_the_backward_split_falls_between_the_two_nets(tmp_path,
                                                       monkeypatch):
    """Full backward hooks on every generator submodule fire after the
    `generator.backward` boundary and before the `encoder.backward` one;
    every encoder submodule's fires after it."""
    t, state = trainer(tmp_path)
    log = []
    new = spans._new

    def logged_new(name, parent):
        log.append(("span", name))
        return new(name, parent)
    monkeypatch.setattr(spans, "_new", logged_new)
    nets = {"generator": t.app.generator, "encoder": t.app.encoder}
    for net, module in nets.items():
        for name, m in module.named_modules():
            m.register_full_backward_hook(
                lambda *a, net=net, name=name: log.append((net, name)))
    spans.enable()
    t.step(state)
    order = [e for e in log if e[0] != "span"
             or e[1].endswith(".backward")]
    gen_b = order.index(("span", "generator.backward"))
    enc_b = order.index(("span", "encoder.backward"))
    fired = {net: [i for i, e in enumerate(order) if e[0] == net]
             for net in nets}
    assert len(fired["generator"]) >= len(list(
        t.app.generator.named_modules())) - 1
    assert len(fired["encoder"]) >= len(list(
        t.app.encoder.named_modules())) - 1
    assert gen_b < min(fired["generator"])
    assert max(fired["generator"]) < enc_b < min(fired["encoder"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transfer_step_records_one_span_per_net(tmp_path, dtype):
    tester = ConditionalTransferTester(Config(
        platform="cpu", model_dir=str(tmp_path), compute_dtype=dtype,
        **SMALL))
    jb = batch_to_device(next(SyntheticLoader(4, 32, 16, seed=2)),
                         tester.device)
    spans.enable()
    tester.transfer_step(jb)
    tester.transfer_step(jb)
    table = spans.summary()
    assert {k: v["count"] for k, v in table.items()} == {
        "transfer_step": 2, "encoder": 2, "pose_raster": 2, "generator": 2,
        "disc_score": 2}
    assert table["transfer_step"]["step"] == [1, 2]
    for name in ("encoder", "pose_raster", "generator", "disc_score"):
        assert table[name]["parent"] == ["transfer_step"] * 2
        assert table[name]["step"] == [1, 2]


def test_summary_counts_and_self_time(monkeypatch):
    """Hand-made spans on a scripted host clock (no card: the device time
    is the host's): a parent's self time leaves out its children."""
    ms = iter([0, 10, 30, 40, 45, 100, 200, 250])
    monkeypatch.setattr(spans, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: next(ms) * 1_000_000))
    spans.enable()
    with spans.span("outer"):
        with spans.span("inner") as s:
            s.add(bytes=3)
        with spans.span("inner") as s:
            s.add(bytes=4)
    with spans.span("outer"):
        pass
    spans.disable()
    with spans.span("ignored"):
        pass
    table = spans.summary()
    assert list(table) == ["outer", "inner"]
    outer, inner = table["outer"], table["inner"]
    assert outer["count"] == 2 and inner["count"] == 2
    assert outer["device_ms"] == outer["host_ms"] == [100.0, 50.0]
    assert outer["self_ms"] == [75.0, 50.0]
    assert inner["device_ms"] == inner["self_ms"] == [20.0, 5.0]
    assert inner["counts"] == {"bytes": 7}
    assert outer["step"] == [1, 2] and inner["step"] == [1, 1]
    assert outer["parent"] == [None, None]
    assert inner["parent"] == ["outer", "outer"]
    spans.reset()
    assert spans.summary() == {}


def test_stage_ms_reads_the_spans_of_real_transfer_steps(tmp_path):
    tester = ConditionalTransferTester(
        Config(platform="cpu", model_dir=str(tmp_path), **SMALL))
    jb = batch_to_device(next(SyntheticLoader(4, 32, 16, seed=2)),
                         tester.device)
    ms = profiling.stage_ms(tester, jb, 2)
    assert list(ms) == ["encode", "pose_raster", "generate", "disc_score"]
    assert all(v > 0 for v in ms.values())
    assert not spans.enabled() and spans.summary() == {}


def test_union_and_covered():
    assert spans.union([(5, 7), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 7]]
    assert spans.covered([(5, 7), (0, 2), (1, 3)]) == 5
    assert spans.covered([(5, 7), (0, 2), (1, 3)], 2.5, 6) == 1.5
    assert spans.covered([], 0, 1) == 0


def test_device_summary_puts_idle_time_inside_copy_in():
    """A hand-made profile: device ops on [0, 10] and [20, 40] of a 50-us
    stretch, the host inside `copy_in` over [5, 25] (idle 10 us of it);
    the device-side copy of a span's annotation is not a device op."""
    cuda = torch.autograd.DeviceType.CUDA

    def event(name, start, end, device=True, annotation=False):
        return types.SimpleNamespace(
            name=name, device_type=cuda if device else
            torch.autograd.DeviceType.CPU, is_user_annotation=annotation,
            time_range=types.SimpleNamespace(
                start=start, end=end, elapsed_us=lambda: end - start))
    prof = types.SimpleNamespace(events=lambda: [
        event("k1", 0, 10), event("k2", 20, 30), event("k2", 25, 40),
        event("copy_in", 0, 50, annotation=True),
        event("copy_in", 5, 25, device=False, annotation=True),
        event("aten::copy_", 6, 24, device=False)])
    out = profiling._device_summary(prof, 50.0, top=5)
    assert out["device_busy_share"] == 30 / 50
    assert out["copy_in_idle_share"] == 10 / 50
    assert out["device_events"] == 3
    assert [r["name"] for r in out["top"]] == ["k2", "k1"]


def test_print_spans_reports_each_span_with_its_self_time(tmp_path, capsys):
    t, state = trainer(tmp_path)
    prof = {"spans": profiling.recorded(lambda: t.step(state), 2),
            "trace": {"device_busy_share": 0.9, "copy_in_idle_share": 0.01}}
    profiling._print_spans("model 1", prof, 2)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[1].split(" x")[0].strip() for ln in lines[:-1]] == [
        "trainer.step", "copy_in in trainer.step", "encoder in trainer.step",
        "generator in trainer.step", "generator.backward in trainer.step",
        "encoder.backward in trainer.step"]
    assert " x2: " in lines[2] and "MB" in lines[1] and "(self " in lines[0]
    assert lines[-1].endswith("idle inside copy_in 0.0100 of the stretch")
