"""CLI twin of the JAX package's `main.py` for the ported models.

    python -m dpig_tpu_torch.main --model=1 --synthetic_data=true \
        --max_step=1000 --log_step=50 --model_dir=<s1>
    python -m dpig_tpu_torch.main --model=2 --synthetic_data=true \
        --max_step=1000 --model_dir=<s2>
    python -m dpig_tpu_torch.main --model=3 --pretrained_path=<s1> \
        --synthetic_data=true --max_step=1000 --model_dir=<s3>
    python -m dpig_tpu_torch.main --model=4 --pretrained_path=<s1> \
        --pretrained_poseAE_path=<s2> --synthetic_data=true \
        --max_step=1000 --model_dir=<s4>
    python -m dpig_tpu_torch.main --model=12 --is_train=false \
        --synthetic_data=true --test_batch_num=4 --model_dir=<dir>
    python -m dpig_tpu_torch.main --model=11 --sample_app=true \
        --pose_source=sampled --pretrained_path=<s1> \
        --pretrained_poseAE_path=<s2> --pretrained_appSample_path=<s3> \
        --pretrained_poseSample_path=<s4> --synthetic_data=true \
        --test_batch_num=4 --model_dir=<dir>

The DeepFashion 256x256 family runs the same chain as models 101 -> 102
-> 103 -> 104 (the single-branch ROI encoder, one 7x32 appearance mapper)
and tests as models 1001 (transfer) and 1002 (factor sampling):

    D="--img_H=256 --img_W=256 --batch_size=6 --synthetic_data=true"
    python -m dpig_tpu_torch.main --model=101 $D --max_step=1000 \
        --model_dir=<d1>
    python -m dpig_tpu_torch.main --model=102 $D --model_dir=<d2>
    python -m dpig_tpu_torch.main --model=103 $D --pretrained_path=<d1> \
        --model_dir=<d3>
    python -m dpig_tpu_torch.main --model=104 $D --pretrained_path=<d1> \
        --pretrained_poseAE_path=<d2> --model_dir=<d4>
    python -m dpig_tpu_torch.main --model=1002 --is_train=false \
        --img_H=256 --img_W=256 --synthetic_data=true --sample_fg=true \
        --pretrained_path=<d1> --pretrained_poseAE_path=<d2> \
        --pretrained_appSample_path=<d3> --pretrained_poseSample_path=<d4> \
        --test_batch_num=4 --model_dir=<dir>

On real data, drop --synthetic_data and name the directory of a Market
(or DeepFashion: a dataset name without "market") pair dataset (`<data_dir>/<dataset>/*_train_*.tfrecord`,
`*_test_*.tfrecord`, `pn_pairs_num_<split>.p`, as the JAX package reads):

    python -m dpig_tpu_torch.main --model=1 --data_dir=<dir> \
        --dataset=Market_train_data --num_worker=4 --max_step=1000 \
        --model_dir=<s1>
    python -m dpig_tpu_torch.main --model=12 --is_train=false \
        --data_dir=<dir> --dataset=Market_train_data --test_batch_num=4 \
        --pretrained_path=<s1> --model_dir=<dir>

The remaining modes of the JAX package's main.py run the same way:

    python -m dpig_tpu_torch.main --model=1 --D_arch=DCGANRegion \
        --synthetic_data=true --max_step=1000 --model_dir=<s1>
        # --D_arch=DCGAN (default) | DCGANRegion* | Patch* | FCDis
    python -m dpig_tpu_torch.main --model=1 --remat=true --batch_size=256 \
        --synthetic_data=true --max_step=1000 --model_dir=<s1>
    python -m dpig_tpu_torch.main --model=11 --is_train=false \
        --inverse_fg=true --inverse_bg=true --pretrained_path=<s1> \
        --pretrained_appSample_path=<s3> --synthetic_data=true \
        --model_dir=<dir>    # -> <dir>/inverted_z.npz
    python -m dpig_tpu_torch.main --model=12 --is_train=false \
        --test_one_by_one=true --demo_img_dir=<imgs> \
        --demo_pair_path=<pairs.p> --demo_all_peaks_path=<peaks.p> \
        --demo_subsets_path=<subsets.p> --pretrained_path=<s1> \
        --model_dir=<dir>    # -> <dir>/test_demo/{x,G,pose,mask,...}

Training reads `--split` shuffled with `--random_seed`; testing reads the
test split in file order and raises StopIteration when it ends before
`--test_batch_num` batches. Weights trained by the JAX package come in
through `scripts/orbax_to_torch.py` (run where JAX is installed).

Runs the Market training chain, Stage I (model 1), the pose AE (2), the
appearance samplers (3) and the pose sampler (4), each stage's checkpoints
feeding the `--pretrained_*` flags of the next and of the testers, then
model-11 sampling, model-12 pose transfer, model-13 factor sampling and
the `--interpolate_*` factor interpolation, the embedding inversion
(`--inverse_fg/bg/pose`) and the one-by-one demo (`--test_one_by_one`),
and the DeepFashion twins (101-104, 1001, 1002), with every `--D_arch`
and `--remat`, on the card (`--platform=cpu` for the CPU). As in the JAX
package, `--model` alone picks training (1-4, 101-104) or testing (11,
12, 13, 1001, 1002).

Across processes, as the JAX package runs across hosts: one process per
rank, each with the same flags but its --process_id (or torchrun's RANK
and WORLD_SIZE with --process_id=-1, the default, and --num_processes
left out or equal to WORLD_SIZE); NCCL on the card, gloo with
--platform=cpu:

    for r in 0 1; do python -m dpig_tpu_torch.main --model=1 \
        --synthetic_data=true --batch_size=16 --num_processes=2 \
        --process_id=$r --coordinator_address=127.0.0.1:29500 \
        --model_dir=<s1> & done; wait
    torchrun --nproc_per_node=2 -m dpig_tpu_torch.main --model=1 \
        --synthetic_data=true --model_dir=<s1>

--batch_size is the global batch: each rank reads batch_size / N rows
(its loader's host share), and a train step computes what one process
computes on the N ranks' rows together (`parallel/dist.py`). Rank 0
writes the model_dir. Testing runs one tester per rank on its share of
the test split, as the JAX package's testers do; each rank needs its own
--model_dir, since their PNG names would collide.
"""
from __future__ import annotations

import contextlib
import os
import socket

import torch.distributed as torch_dist

from .apps.common import (batch_to_device, pose_maps_from_batch,
                          select_device, select_parts)
from .config import Config, get_config
from .data.loader import TFRecordPairLoader
from .data.synthetic import SyntheticLoader
from .models.mappers import sample_mapper_noise
from .parallel import dist

TRAIN_MODELS = (1, 2, 3, 4, 101, 102, 103, 104)


def make_loader(cfg: Config):
    """This process's loader (the JAX package's main.py:21-40): synthetic
    batches seeded with `random_seed` + the rank, or the rank's share of
    the tfrecord pairs of `cfg.data_path` (host `rank` of `world`): the
    `split` when training, shuffled with `random_seed`, else the test
    split in file order, which ends (the testers then raise
    StopIteration). Each batch holds batch_size / world rows."""
    host_id, host_count = dist.rank(), dist.world()
    if cfg.batch_size % host_count:
        raise ValueError(
            f"--batch_size={cfg.batch_size} must be divisible by the "
            f"process count ({host_count}): a truncated per-host batch "
            "would silently shrink the global batch and break sharding")
    local_bs = cfg.batch_size // host_count
    if cfg.synthetic_data:
        return SyntheticLoader(local_bs, cfg.img_H, cfg.img_W,
                               seed=cfg.random_seed + host_id)
    return TFRecordPairLoader(
        cfg.data_path, cfg.split if cfg.is_train else "test",
        local_bs, cfg.img_H, cfg.img_W, dataset=cfg.dataset,
        shuffle=cfg.is_train, seed=cfg.random_seed,
        num_workers=cfg.num_worker, worker_mode=cfg.worker_mode,
        host_id=host_id, host_count=host_count)


def train_model(cfg: Config):
    """Models 1-4 and 101-104 through the Trainer (main.py:43-115);
    returns the final GanState."""
    if cfg.model not in TRAIN_MODELS:
        raise ValueError(f"unknown training model {cfg.model}")
    with contextlib.closing(make_loader(cfg)) as loader:
        return _train(cfg, loader)


def _train(cfg: Config, loader):
    from .train import checkpoint as ckpt
    from .train.harness import Trainer

    device = select_device(cfg.platform)
    if cfg.model in (1, 101):
        from .apps.stage1_app import Stage1App
        app = Stage1App(cfg, device, fg_bg=cfg.model == 1)
        trainer = Trainer(cfg, app, loader)

        def preview(state, batch, step):
            jb = batch_to_device(batch, device)
            bbox, vis = select_parts(jb["part_bbox"], jb["part_vis"],
                                     cfg.roi_part_num)
            imgs = app.generate_step(jb["x"], pose_maps_from_batch(jb, cfg),
                                     jb["mask_r6"], bbox, vis)
            trainer.preview_with_ssim(imgs.cpu().numpy(), batch["x"], step)

        return trainer.train(preview_fn=preview)
    if cfg.model in (2, 102):
        from .apps.stage1_pose import Stage1PoseApp
        return Trainer(cfg, Stage1PoseApp(cfg, device), loader).train()

    frozen = {}
    if cfg.model in (4, 104) and cfg.pretrained_poseAE_path:
        frozen.update(ckpt.restore_subtrees(cfg.pretrained_poseAE_path,
                                            ["PoseAE"]))
    if cfg.pretrained_path:
        frozen.update(ckpt.restore_subtrees(cfg.pretrained_path,
                                            ["Encoder", "ID_AE"]))
    if cfg.model == 3:
        from .apps.stage2_app import Stage2AppApp
        app = Stage2AppApp(cfg, device, frozen)
    elif cfg.model == 103:  # DF: one 7*32-d mapper (trainer_256.py:266-403)
        from .apps.stage2_app_single import Stage2AppSingleApp
        app = Stage2AppSingleApp(cfg, device, frozen)
    else:
        from .apps.stage2_pose import Stage2PoseApp
        app = Stage2PoseApp(cfg, device, frozen)
    trainer = Trainer(cfg, app, loader)

    def preview(state, batch, step):
        noise = sample_mapper_noise(trainer.noise_gen, batch["x"].shape[0],
                                    app.noise_dim, device)
        imgs = app.preview_step(batch_to_device(batch, device), noise)
        trainer.preview_with_ssim(imgs.cpu().numpy(), batch["x"], step)

    return trainer.train(preview_fn=preview)


def test_model(cfg: Config) -> str:
    """The test dispatch of the JAX package's main.py:118-156; returns the
    output directory (the inversion's: the model_dir)."""
    if cfg.test_one_by_one:  # before any loader, as in JAX
        from .apps.demo import run_one_by_one
        return run_one_by_one(cfg, cfg.demo_img_dir, cfg.demo_pair_path,
                              cfg.demo_all_peaks_path, cfg.demo_subsets_path)
    with contextlib.closing(make_loader(cfg)) as loader:
        return _test(cfg, loader)


def _invert(cfg: Config, loader) -> str:
    """--inverse_fg/bg/pose (main.py:128-140): invert the first batch, the
    BG code only with --inverse_bg (so --inverse_fg and --inverse_pose
    both invert the FG code), from z0 drawn from a CPU torch.Generator
    seeded with --random_seed; write <model_dir>/inverted_z.npz."""
    import numpy as np
    import torch
    from .apps.inversion import InversionTool
    tool = InversionTool(cfg)
    batch = batch_to_device(next(loader), tool.device)
    z0 = tool.draw_noise(torch.Generator().manual_seed(cfg.random_seed),
                         batch["x"].shape[0])
    zf, zb, loss = tool.invert(batch, z0, invert_bg=cfg.inverse_bg)
    out = f"{cfg.model_dir}/inverted_z.npz"
    np.savez(out, z_fg=zf.cpu().numpy(), z_bg=zb.cpu().numpy())
    print(f"[*] inversion loss {float(loss):.6f}; saved {out}")
    return cfg.model_dir


def _test(cfg: Config, loader) -> str:
    from .apps import testers
    if cfg.inverse_fg or cfg.inverse_bg or cfg.inverse_pose:
        return _invert(cfg, loader)
    if (cfg.interpolate_fg or cfg.interpolate_fg_up or cfg.interpolate_fg_down
            or cfg.interpolate_bg or cfg.interpolate_pose):
        return testers.InterpolationTester(cfg).run(loader)
    if cfg.model == 11:
        # --sample_pose maps to the reference behavior (tester.py:93-95):
        # True decodes the AE code of the real pose ('reconstructed');
        # --pose_source overrides (incl. 'sampled', the paper's sampler).
        pose_source = cfg.pose_source or (
            "reconstructed" if cfg.sample_pose else "real")
        return testers.FullSamplingTester(cfg).run(loader,
                                                   pose_source=pose_source)
    if cfg.model in (12, 1001):
        return testers.ConditionalTransferTester(cfg).run(loader)
    if cfg.model in (13, 1002):
        return testers.FactorSamplingTester(cfg).run(loader)
    raise ValueError(f"unknown test model {cfg.model}")


def _refuse_a_shared_test_dir(cfg: Config) -> None:
    """The JAX package's testers, one per process, name their PNGs by the
    process's own batch index (testers.py:77-85, :407), so two processes
    on one host writing to one model_dir overwrite each other's files.
    Raise instead, on every rank, before anything is written."""
    seen = [None] * dist.world()
    torch_dist.all_gather_object(
        seen, (socket.gethostname(), os.path.abspath(cfg.model_dir)))
    if len(set(seen)) != len(seen):
        raise ValueError(
            f"{dist.world()} test processes share a --model_dir on one host "
            f"({sorted(seen)}): each writes its share of the test split "
            "under the same PNG names, so they would overwrite each other "
            "(as the JAX package's processes do); give each process its "
            "own --model_dir")


def main(argv=None) -> None:
    cfg = get_config(argv)
    select_device(cfg.platform)  # fail before starting anything
    # as the JAX main.py:165 (--num_processes > 1 or an address), and
    # torchrun's environment with --process_id=-1; else a no-op
    started = dist.init_distributed(
        cfg.coordinator_address, cfg.num_processes, cfg.process_id,
        platform=cfg.platform)
    try:
        train = cfg.model in TRAIN_MODELS
        if train and dist.world() > 1:  # one run: rank 0's model_dir (a
            shared = [cfg.model_dir]    # default one carries a time stamp)
            torch_dist.broadcast_object_list(shared, src=0)
            cfg.model_dir = shared[0]
        elif dist.world() > 1:
            _refuse_a_shared_test_dir(cfg)
        if not train or dist.rank() == 0:  # a training run's model_dir is
            cfg.save()                     # rank 0's to write
            print(f"[*] MODEL dir: {cfg.model_dir}")
        if train:
            train_model(cfg)
        else:
            test_model(cfg)
    finally:
        if started:
            dist.shutdown()


if __name__ == "__main__":
    main()
