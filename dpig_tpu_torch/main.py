"""CLI twin of the JAX package's `main.py` (:118-180) for the ported models.

    python -m dpig_tpu_torch.main --model=12 --is_train=false \
        --synthetic_data=true --test_batch_num=4 --model_dir=<dir>

Runs model-12 pose transfer on the card (`--platform=cpu` for the CPU).
Every other `--model`, and every option whose path is not ported yet,
raises NotImplementedError.
"""
from __future__ import annotations

from .apps.common import select_device
from .config import Config, get_config
from .data.synthetic import SyntheticLoader


def make_loader(cfg: Config):
    if cfg.synthetic_data:
        return SyntheticLoader(cfg.batch_size, cfg.img_H, cfg.img_W,
                               seed=cfg.random_seed)
    raise NotImplementedError(
        "the tfrecord pair loader is not ported to dpig_tpu_torch yet; "
        "pass --synthetic_data=true")


def test_model(cfg: Config) -> str:
    from .apps import testers
    if cfg.model != 12:
        raise NotImplementedError(
            f"--model={cfg.model}: dpig_tpu_torch ports model 12 (pose "
            "transfer) only so far")
    unported = [f for f in ("test_one_by_one", "inverse_fg", "inverse_bg",
                            "inverse_pose", "interpolate_fg",
                            "interpolate_fg_up", "interpolate_fg_down",
                            "interpolate_bg", "interpolate_pose")
                if getattr(cfg, f)]
    if unported:
        raise NotImplementedError(f"--{unported[0]} is not ported to "
                                  "dpig_tpu_torch yet")
    return testers.ConditionalTransferTester(cfg).run(make_loader(cfg))


def main(argv=None) -> None:
    cfg = get_config(argv)
    if cfg.num_processes > 1 or cfg.coordinator_address:
        raise NotImplementedError("multi-process runs (DDP) are not ported "
                                  "to dpig_tpu_torch yet")
    select_device(cfg.platform)  # fail before writing anything
    cfg.save()
    print(f"[*] MODEL dir: {cfg.model_dir}")
    test_model(cfg)


if __name__ == "__main__":
    main()
