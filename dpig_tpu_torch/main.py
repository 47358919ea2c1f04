"""CLI twin of the JAX package's `main.py` for the ported models.

    python -m dpig_tpu_torch.main --model=1 --synthetic_data=true \
        --max_step=1000 --log_step=50 --model_dir=<dir>
    python -m dpig_tpu_torch.main --model=12 --is_train=false \
        --synthetic_data=true --test_batch_num=4 --model_dir=<dir>
    python -m dpig_tpu_torch.main --model=11 --sample_app=true \
        --pose_source=sampled --synthetic_data=true --test_batch_num=4 \
        --model_dir=<dir>

Runs Stage-I training (model 1), model-11 sampling, model-12 pose
transfer, model-13 factor sampling and the `--interpolate_*` factor
interpolation on the card (`--platform=cpu` for the CPU). As in the JAX
package, `--model` alone picks training (1-4, 101-104) or testing (11, 12,
13, 1001, 1002). Every model and option whose path is not ported yet
raises NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

from .apps.common import (batch_to_device, pose_maps_from_batch,
                          select_device, select_parts)
from .config import Config, get_config
from .data.synthetic import SyntheticLoader

TRAIN_MODELS = (1, 2, 3, 4, 101, 102, 103, 104)


def make_loader(cfg: Config):
    if cfg.synthetic_data:
        return SyntheticLoader(cfg.batch_size, cfg.img_H, cfg.img_W,
                               seed=cfg.random_seed)
    raise NotImplementedError(
        "the tfrecord pair loader is not ported to dpig_tpu_torch yet; "
        "pass --synthetic_data=true")


def train_model(cfg: Config):
    """Model 1 through the Trainer (main.py:51-67); returns the final
    GanState."""
    if cfg.model in (2, 3, 4):
        raise NotImplementedError(
            f"--model={cfg.model}: the pose AE and the Stage-II samplers are "
            "not ported to dpig_tpu_torch yet (ROADMAP queue item 3)")
    if cfg.model != 1:
        raise NotImplementedError(
            f"--model={cfg.model}: the 256x256 family is not ported to "
            "dpig_tpu_torch yet (ROADMAP queue item 4)")
    from .apps.stage1_app import Stage1App
    from .train.harness import Trainer

    app = Stage1App(cfg, select_device(cfg.platform))
    trainer = Trainer(cfg, app, make_loader(cfg))

    def preview(state, batch, step):
        jb = batch_to_device(batch, app.device)
        bbox, vis = select_parts(jb["part_bbox"], jb["part_vis"],
                                 cfg.roi_part_num)
        imgs = app.generate_step(jb["x"], pose_maps_from_batch(jb, cfg),
                                 jb["mask_r6"], bbox, vis)
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
