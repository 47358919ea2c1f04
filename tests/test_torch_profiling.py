"""The port's profiler: its stage-by-stage model-11 step, its
phase-by-phase train steps (models 1, 3 and 4), and its refusal to
measure without a card (its model-12 stages: tests/test_torch_spans.py)."""
import pytest
import torch

from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.apps.stage1_app import Stage1App
from dpig_tpu_torch.apps.stage2_app import STAGE2_PHASES, Stage2AppApp
from dpig_tpu_torch.apps.stage2_pose import Stage2PoseApp
from dpig_tpu_torch.apps.testers import FullSamplingTester
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.data.synthetic import SyntheticLoader
from dpig_tpu_torch.train import checkpoint as ckpt
from dpig_tpu_torch.utils import profiling

torch.set_num_threads(1)

SMALL = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16)


@pytest.mark.parametrize("fast", [False, True])
def test_train_step_marks_each_phase_and_the_marks_change_nothing(tmp_path,
                                                                  fast):
    """train_step calls `mark` once per phase, in order, and computes bit
    for bit on the CPU what it computes without a mark."""
    cfg = Config(platform="cpu", model_dir=str(tmp_path), fast_gan_step=fast,
                 **SMALL)
    batch = next(SyntheticLoader(4, 32, 16, seed=1))
    results = []
    for marks in (None, []):
        app = Stage1App(cfg, torch.device("cpu"))
        state = app.init_state()
        metrics = app.train_step(state, batch_to_device(batch, app.device),
                                 None if marks is None else marks.append)
        results.append((metrics, ckpt.state_tree(state)))
    assert marks == list(profiling.TRAIN_PHASES)
    (m0, s0), (m1, s1) = results
    assert {k: float(v) for k, v in m0.items()} == {
        k: float(v) for k, v in m1.items()}
    assert s0["step"] == s1["step"] == 1
    for key in ("g_params", "d_params", "d_stats"):
        for net, tensors in s0[key].items():
            for n, t in tensors.items():
                assert torch.equal(t, s1[key][net][n]), (key, net, n)


@pytest.mark.parametrize("sample_app", [False, True])
def test_sampling_stages_mark_each_stage_and_compute_the_step(tmp_path,
                                                              sample_app):
    """The model-11 stage profile marks every stage in order and computes
    bit for bit what sample_step computes (pose_source 'sampled')."""
    cfg = Config(platform="cpu", model_dir=str(tmp_path),
                 sample_app=sample_app, **SMALL)
    tester = FullSamplingTester(cfg)
    jb = batch_to_device(next(SyntheticLoader(4, 32, 16, seed=1)),
                         tester.device)
    noise = tester.draw_noise(torch.Generator().manual_seed(0), 4)
    marks = []
    g_raw, score = profiling.sampling_stages(tester, jb, noise, marks.append)
    assert marks == list(profiling.SAMPLING_STAGES)
    g, _, score_step, _ = tester.sample_step(jb, noise,
                                             profiling.SAMPLING_SOURCE)
    assert torch.equal(torch.clamp((g_raw + 1) * 127.5, 0, 255), g)
    assert torch.equal(score, score_step)


@pytest.mark.parametrize("cls", [Stage2AppApp, Stage2PoseApp])
def test_stage2_step_marks_each_phase_and_the_marks_change_nothing(tmp_path,
                                                                   cls):
    """The Stage-II step marks the real embeddings, the G phases, then the
    three critic phases once per critic iteration, and computes bit for
    bit on the CPU what it computes without a mark."""
    cfg = Config(platform="cpu", model_dir=str(tmp_path), **SMALL)
    loader = SyntheticLoader(4, 32, 16, seed=1)
    host = [next(loader) for _ in range(6)]
    results = []
    for marks in (None, []):
        app = cls(cfg, torch.device("cpu"))
        state = app.init_state()
        noise = app.step_noise(torch.Generator().manual_seed(2), 4)
        batches = tuple(batch_to_device(b, app.device) for b in host)
        metrics = app.train_step(state, batches, noise,
                                 None if marks is None else marks.append)
        results.append((metrics, ckpt.state_tree(state)))
    assert marks == list(STAGE2_PHASES[:3]) + list(STAGE2_PHASES[3:]) * 5
    (m0, s0), (m1, s1) = results
    for k, v in m0.items():
        assert torch.equal(v, m1[k]), k
    for key in ("g_params", "d_params"):
        for net, tensors in s0[key].items():
            for n, t in tensors.items():
                assert torch.equal(t, s1[key][net][n]), (key, net, n)


def test_profiling_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    with pytest.raises(SystemExit, match="no CUDA device"):
        profiling.main()
