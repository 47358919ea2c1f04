"""The port's profiler: its FLOP count per stage of the model-12
transfer step, and its refusal to measure without a card."""
import pytest
import torch

from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.apps.testers import ConditionalTransferTester
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.data.synthetic import SyntheticLoader
from dpig_tpu_torch.utils import profiling

torch.set_num_threads(1)

SMALL = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16)


def test_stage_flops_counts_the_discriminator_from_its_shapes(tmp_path):
    cfg = Config(platform="cpu", model_dir=str(tmp_path), **SMALL)
    tester = ConditionalTransferTester(cfg)
    jb = batch_to_device(next(SyntheticLoader(4, 32, 16, seed=1)),
                         tester.device)
    flops = profiling.stage_flops(tester, jb)
    assert set(flops) == {"encode", "generate", "disc_score"}
    assert flops["encode"] > 0 and flops["generate"] > 0
    # DCGAN D: four 5x5 stride-2 SAME convs (64, 128, 256, 512 channels)
    # and a 1-unit dense layer over the NHWC-flattened features
    macs, h, w, ch_in = 0, cfg.img_H, cfg.img_W, 3
    for ch in (64, 128, 256, 512):
        h, w = -(-h // 2), -(-w // 2)
        macs += cfg.batch_size * h * w * ch * ch_in * 25
        ch_in = ch
    macs += cfg.batch_size * h * w * ch_in
    assert flops["disc_score"] == 2 * macs


def test_profiling_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    with pytest.raises(SystemExit, match="no CUDA device"):
        profiling.main()
