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

Runs the Market training chain, Stage I (model 1), the pose AE (2), the
appearance samplers (3) and the pose sampler (4), each stage's checkpoints
feeding the `--pretrained_*` flags of the next and of the testers, then
model-11 sampling, model-12 pose transfer, model-13 factor sampling and
the `--interpolate_*` factor interpolation, on the card (`--platform=cpu`
for the CPU). As in the JAX package, `--model` alone picks training (1-4,
101-104) or testing (11, 12, 13, 1001, 1002). Every model and option whose
path is not ported yet raises NotImplementedError naming its ROADMAP
item.
"""
from __future__ import annotations

from .apps.common import (batch_to_device, pose_maps_from_batch,
                          select_device, select_parts)
from .config import Config, get_config
from .data.synthetic import SyntheticLoader
from .models.mappers import sample_mapper_noise

TRAIN_MODELS = (1, 2, 3, 4, 101, 102, 103, 104)


def make_loader(cfg: Config):
    if cfg.synthetic_data:
        return SyntheticLoader(cfg.batch_size, cfg.img_H, cfg.img_W,
                               seed=cfg.random_seed)
    raise NotImplementedError(
        "the tfrecord pair loader is not ported to dpig_tpu_torch yet; "
        "pass --synthetic_data=true")


def train_model(cfg: Config):
    """Models 1-4 through the Trainer (main.py:43-115); returns the final
    GanState."""
    if cfg.model not in (1, 2, 3, 4):
        raise NotImplementedError(
            f"--model={cfg.model}: the 256x256 family is not ported to "
            "dpig_tpu_torch yet (ROADMAP queue item 4)")
    from .train import checkpoint as ckpt
    from .train.harness import Trainer

    device = select_device(cfg.platform)
    loader = make_loader(cfg)
    if cfg.model == 1:
        from .apps.stage1_app import Stage1App
        app = Stage1App(cfg, device)
        trainer = Trainer(cfg, app, loader)

        def preview(state, batch, step):
            jb = batch_to_device(batch, device)
            bbox, vis = select_parts(jb["part_bbox"], jb["part_vis"],
                                     cfg.roi_part_num)
            imgs = app.generate_step(jb["x"], pose_maps_from_batch(jb, cfg),
                                     jb["mask_r6"], bbox, vis)
            trainer.preview_with_ssim(imgs.cpu().numpy(), batch["x"], step)

        return trainer.train(preview_fn=preview)
    if cfg.model == 2:
        from .apps.stage1_pose import Stage1PoseApp
        return Trainer(cfg, Stage1PoseApp(cfg, device), loader).train()

    frozen = {}
    if cfg.model == 4 and cfg.pretrained_poseAE_path:
        frozen.update(ckpt.restore_subtrees(cfg.pretrained_poseAE_path,
                                            ["PoseAE"]))
    if cfg.pretrained_path:
        frozen.update(ckpt.restore_subtrees(cfg.pretrained_path,
                                            ["Encoder", "ID_AE"]))
    if cfg.model == 3:
        from .apps.stage2_app import Stage2AppApp
        app = Stage2AppApp(cfg, device, frozen)
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
    from .apps import testers
    unported = [f for f in ("test_one_by_one", "inverse_fg", "inverse_bg",
                            "inverse_pose") if getattr(cfg, f)]
    if unported:
        raise NotImplementedError(f"--{unported[0]} is not ported to "
                                  "dpig_tpu_torch yet")
    if cfg.model in (1001, 1002):
        raise NotImplementedError(
            f"--model={cfg.model}: the 256x256 family is not ported to "
            "dpig_tpu_torch yet (ROADMAP queue item 4)")
    if cfg.model not in (11, 12, 13):
        raise ValueError(f"unknown test model {cfg.model}")
    loader = make_loader(cfg)
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
    if cfg.model == 12:
        return testers.ConditionalTransferTester(cfg).run(loader)
    return testers.FactorSamplingTester(cfg).run(loader)


def main(argv=None) -> None:
    cfg = get_config(argv)
    if cfg.num_processes > 1 or cfg.coordinator_address:
        raise NotImplementedError("multi-process runs (DDP) are not ported "
                                  "to dpig_tpu_torch yet")
    select_device(cfg.platform)  # fail before writing anything
    cfg.save()
    print(f"[*] MODEL dir: {cfg.model_dir}")
    if cfg.model in TRAIN_MODELS:
        train_model(cfg)
    else:
        test_model(cfg)


if __name__ == "__main__":
    main()
