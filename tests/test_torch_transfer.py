"""The model-12 slice end to end: the JAX ConditionalTransferTester's
cold-start params bridged into the port's tester give the same
transfer_step outputs on the same batch; the port's run() writes the same
tree; the port's SyntheticLoader gives the JAX loader's batches."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpig_tpu.apps import testers as jtesters
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.data.synthetic import SyntheticLoader as JaxLoader
from dpig_tpu_torch.apps import testers
from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.data.synthetic import SyntheticLoader

torch.set_num_threads(1)

SMALL = dict(img_H=32, img_W=16, batch_size=4, conv_hidden_num=16, z_num=16)
TREE = ("x", "x_target", "G", "pose", "pose_target", "mask", "mask_target")


def small_cfg(tmp_path, **kw):
    return Config(model_dir=str(tmp_path), platform="cpu", **SMALL, **kw)


def test_transfer_step_matches_jax_tester(tmp_path):
    jt = jtesters.ConditionalTransferTester(
        JaxConfig(model_dir=str(tmp_path), **SMALL))
    state = params_from_flax(jt.params,
                             testers.ConditionalTransferTester.SUBTREES)
    t = testers.ConditionalTransferTester(small_cfg(tmp_path), params=state)
    batch = next(JaxLoader(4, 32, 16, seed=3))
    g_ref, pose_ref, score_ref = jt.transfer_step(
        jt.params, {k: jnp.asarray(v) for k, v in batch.items()})
    g, pose, score = t.transfer_step(batch_to_device(batch, t.device))
    # 2e-2 on [0,255] is the 1e-4 bound on g_raw times 127.5 (f32, other
    # conv summation order)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), atol=2e-2, rtol=0)
    np.testing.assert_array_equal(pose.numpy(), np.asarray(pose_ref))
    np.testing.assert_allclose(score.numpy(), np.asarray(score_ref),
                               atol=1e-4, rtol=0)


def test_forwards_run_float32_whatever_the_tf32_flags(tmp_path):
    """Stage1App, the pose AE and the testers' mappers own the precision:
    with PyTorch's TF32 flags on, every module of transfer_step, and every
    module of the sampling steps (the Gaussian mappers, the pose encoder
    and decoder), still runs with them off, and the caller's flags come
    back after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    t = testers.ConditionalTransferTester(small_cfg(tmp_path))
    s = testers.FullSamplingTester(small_cfg(tmp_path, sample_app=True))
    seen = []
    modules = [t.stage1.encoder, t.stage1.generator, t.stage1.disc,
               *s.mappers.values(), s.pose_ae.encoder, s.pose_ae.decoder]
    for m in modules:
        m.register_forward_pre_hook(
            lambda *_: seen.append((cudnn.allow_tf32, matmul.allow_tf32)))
    batch = next(SyntheticLoader(4, 32, 16, seed=3))
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        t.transfer_step(batch_to_device(batch, t.device))
        assert seen == [(False, False)] * 3
        noise = s.draw_noise(torch.Generator().manual_seed(0), 4)
        for source in ("sampled", "reconstructed"):
            s.sample_step(batch_to_device(batch, s.device), noise, source)
        # per step the FG and BG mappers, the pose mapper or the pose
        # encoder, and the pose decoder
        assert seen == [(False, False)] * 11
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_port_run_writes_the_tree(tmp_path, capsys):
    cfg = small_cfg(tmp_path)
    t = testers.ConditionalTransferTester(cfg)
    assert "RANDOM init" in capsys.readouterr().out
    out = t.run(SyntheticLoader(cfg.batch_size, cfg.img_H, cfg.img_W, seed=3),
                test_batch_num=2)
    for sub in TREE:
        files = os.listdir(os.path.join(out, sub))
        assert len(files) == 2 * cfg.batch_size, (sub, files)
    assert "transfer SSIM vs x_target" in capsys.readouterr().out


def test_synthetic_loader_matches_jax():
    port, ref = SyntheticLoader(4, 32, 16, seed=5), JaxLoader(4, 32, 16, seed=5)
    for _ in range(2):
        a, b = next(port), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


def test_preview_ssim_and_pose_gray_match_jax(rng):
    """The port's own copies of the preview SSIM and the pose preview."""
    from dpig_tpu.eval.metrics import ssim_images as jssim_images
    from dpig_tpu.utils.viz import pose_to_gray as jpose_to_gray
    from dpig_tpu_torch.eval.metrics import ssim_images
    from dpig_tpu_torch.utils.viz import pose_to_gray
    g = rng.uniform(-10, 265, (3, 32, 16, 3)).astype(np.float32)
    x = rng.uniform(0, 255, (3, 32, 16, 3)).astype(np.float32)
    x[2] = 77.0  # a flat target: data range 0 falls back to 1
    np.testing.assert_array_equal(ssim_images(g, x), jssim_images(g, x))
    maps = np.where(rng.uniform(size=(2, 32, 16, 18)) > 0.9, 1.0,
                    -1.0).astype(np.float32)
    np.testing.assert_array_equal(pose_to_gray(maps), jpose_to_gray(maps))


def test_unported_options_raise(tmp_path):
    """An orbax checkpoint of the JAX package raises, naming the importer;
    a port checkpoint loads, and with every sub-tree it needs and no D the
    tester scores zeros, as JAX does."""
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.train import checkpoint as ckpt
    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError,
                       match="orbax.*scripts/orbax_to_torch.py"):
        testers.ConditionalTransferTester(
            small_cfg(tmp_path, pretrained_path=str(tmp_path / "orbax")))
    app = Stage1App(small_cfg(tmp_path, random_seed=5), torch.device("cpu"))
    ckpt.save_checkpoint(str(tmp_path / "s1"), 0, app.init_state())
    t = testers.ConditionalTransferTester(
        small_cfg(tmp_path, pretrained_path=str(tmp_path / "s1")))
    for a, b in ((t.stage1.encoder, app.encoder),
                 (t.stage1.generator, app.generator)):
        for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(p, q), n
    _, _, score = t.transfer_step(batch_to_device(
        next(SyntheticLoader(4, 32, 16, seed=1)), t.device))
    assert t.stage1.disc is None and not score.any()
    # int8 is ported (tests/test_torch_quant.py): the tester builds, and
    # its tables come from the first batch of run()
    t8 = testers.ConditionalTransferTester(
        small_cfg(tmp_path, inference_dtype="int8"))
    assert t8.quant_enc is None and t8.quant_gen is None
