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

Training reads `--split` shuffled with `--random_seed`; testing reads the
test split in file order and raises StopIteration when it ends before
`--test_batch_num` batches. Weights trained by the JAX package come in
through `scripts/orbax_to_torch.py` (run where JAX is installed).

Runs the Market training chain, Stage I (model 1), the pose AE (2), the
appearance samplers (3) and the pose sampler (4), each stage's checkpoints
feeding the `--pretrained_*` flags of the next and of the testers, then
model-11 sampling, model-12 pose transfer, model-13 factor sampling and
the `--interpolate_*` factor interpolation, and the DeepFashion twins
(101-104, 1001, 1002), on the card (`--platform=cpu` for the CPU). As in
the JAX package, `--model` alone picks training (1-4, 101-104) or testing
(11, 12, 13, 1001, 1002). Every option whose path is not ported yet
raises NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

import contextlib

from .apps.common import (batch_to_device, pose_maps_from_batch,
                          select_device, select_parts)
from .config import Config, get_config
from .data.loader import TFRecordPairLoader
from .data.synthetic import SyntheticLoader
from .models.mappers import sample_mapper_noise

TRAIN_MODELS = (1, 2, 3, 4, 101, 102, 103, 104)


def make_loader(cfg: Config):
    """Synthetic batches, or the tfrecord pairs of `cfg.data_path` (the JAX
    package's main.py:19-36, one process: host 0 of 1): the `split` when
    training, shuffled with `random_seed`, else the test split in file
    order, which ends (the testers then raise StopIteration)."""
    if cfg.synthetic_data:
        return SyntheticLoader(cfg.batch_size, cfg.img_H, cfg.img_W,
                               seed=cfg.random_seed)
    return TFRecordPairLoader(
        cfg.data_path, cfg.split if cfg.is_train else "test",
        cfg.batch_size, cfg.img_H, cfg.img_W, dataset=cfg.dataset,
        shuffle=cfg.is_train, seed=cfg.random_seed,
        num_workers=cfg.num_worker, worker_mode=cfg.worker_mode)


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
    output directory."""
    unported = [f for f in ("test_one_by_one", "inverse_fg", "inverse_bg",
                            "inverse_pose") if getattr(cfg, f)]
    if unported:
        raise NotImplementedError(
            f"--{unported[0]} is not ported to dpig_tpu_torch yet (ROADMAP "
            '§1, "The remaining CLI modes and options")')
    if cfg.model not in (11, 12, 13, 1001, 1002):
        raise ValueError(f"unknown test model {cfg.model}")
    with contextlib.closing(make_loader(cfg)) as loader:
        return _test(cfg, loader)


def _test(cfg: Config, loader) -> str:
    from .apps import testers
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
    return testers.FactorSamplingTester(cfg).run(loader)  # 13, 1002


def main(argv=None) -> None:
    cfg = get_config(argv)
    if cfg.num_processes > 1 or cfg.coordinator_address:
        raise NotImplementedError("multi-process runs (DDP) are not ported "
                                  'to dpig_tpu_torch yet (ROADMAP §1, "DDP")')
    select_device(cfg.platform)  # fail before writing anything
    cfg.save()
    print(f"[*] MODEL dir: {cfg.model_dir}")
    if cfg.model in TRAIN_MODELS:
        train_model(cfg)
    else:
        test_model(cfg)


if __name__ == "__main__":
    main()
