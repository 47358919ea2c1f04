"""Configuration: the port's own copy of `dpig_tpu/config.py:1-224`.

Same dataclass, same defaults and the same CLI flags, so a run script for
the JAX package translates 1:1. Two fields read differently here:
`platform` picks the torch device (see `apps/common.py:select_device`),
and the fields that only select a JAX/TPU code path are accepted for flag
compatibility; the port's entry points reject the ones whose path is not
ported yet instead of ignoring them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
from dataclasses import dataclass
from datetime import datetime
from typing import Optional


def str2bool(v: str) -> bool:
    return str(v).lower() in ("true", "1")


@dataclass
class Config:
    # Network (reference config.py:16-27)
    img_H: int = 128
    img_W: int = 64
    conv_hidden_num: int = 128
    z_num: int = 64

    # Data (config.py:30-36)
    dataset: str = "Market_train_data"
    split: str = "train"
    batch_size: int = 16
    grayscale: bool = False
    num_worker: int = 4
    worker_mode: str = "thread"

    # Training / test (config.py:38-79)
    is_train: bool = True
    test_one_by_one: bool = False
    optimizer: str = "adam"
    start_step: int = 0
    ckpt_path: Optional[str] = None
    pretrained_path: Optional[str] = None
    pretrained_appSample_path: Optional[str] = None
    pretrained_poseAE_path: Optional[str] = None
    pretrained_poseSample_path: Optional[str] = None
    z_emb_dir: Optional[str] = None
    max_step: int = 500000
    lr_update_step: int = 100000
    L1Loss_weight: float = 20.0
    d_lr: float = 0.00008
    g_lr: float = 0.00008
    beta1: float = 0.5
    beta2: float = 0.999
    gamma: float = 0.5
    lambda_k: float = 0.001
    model: int = 0
    D_arch: str = "DCGAN"
    sample_app: bool = False
    sample_fg: bool = False
    sample_bg: bool = False
    sample_pose: bool = False
    one_app_per_batch: bool = False
    interpolate_fg: bool = False
    interpolate_fg_up: bool = False
    interpolate_fg_down: bool = False
    interpolate_bg: bool = False
    interpolate_pose: bool = False
    inverse_fg: bool = False
    inverse_bg: bool = False
    inverse_pose: bool = False

    # Misc (config.py:81-94)
    load_path: str = ""
    log_step: int = 200
    save_model_secs: int = 1000
    num_log_samples: int = 3
    log_level: str = "INFO"
    log_dir: str = "logs"
    model_dir: Optional[str] = None
    data_dir: str = "data"
    test_data_path: Optional[str] = None
    sample_per_image: int = 64
    random_seed: int = 123

    # Extras of the JAX package (no reference equivalent)
    compute_dtype: str = "float32"      # 'float32' | 'bfloat16' (Stage-I nets)
    mesh_axis: str = "data"
    test_batch_num: int = 0             # 0 -> model-specific default
    keypoint_num: int = 18
    part_num: int = 37                  # bboxes stored per sample
    roi_part_num: int = 7               # parts actually encoded (trainer.py:576)
    roi_z_num: int = 32                 # trainer.py:581 hardcodes 32
    synthetic_data: bool = False        # run on generated fixtures (no tfrecords)
    # Torch device: '' = CUDA (raises when no CUDA device is present),
    # 'cpu' = the CPU (tests, parity runs). Nothing falls back silently.
    platform: str = ""
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = -1
    remat: bool = False
    # JAX rasterizer choice ('xla' | 'pallas'); the port always runs its
    # CUDA rasterizer for tensors on the card.
    pose_raster: str = "xla"
    inference_dtype: str = "bf16"       # 'bf16' (float nets) | 'int8'
    int8_fallback_layers: str = ""
    int8_fallback_mode: str = "island"
    int8_calibration: str = "channel"
    int8_selfcheck: bool = True
    pose_source: str = ""               # '' | 'real' | 'reconstructed' | 'sampled'
    fast_gan_step: bool = False
    critic_batch_mode: str = "fresh"    # 'fresh' | 'reused'
    demo_img_dir: Optional[str] = None  # test_one_by_one inputs
    demo_pair_path: Optional[str] = None
    demo_all_peaks_path: Optional[str] = None
    demo_subsets_path: Optional[str] = None

    # Derived
    data_path: str = ""

    @property
    def repeat_num(self) -> int:
        """log2(H) - 2 (trainer.py:75): 5 at 128px, 6 at 256px."""
        return int(math.log2(self.img_H)) - 2

    def finalize(self) -> "Config":
        """Resolve model_dir / data_path (reference utils.py:111-141)."""
        if not self.model_dir:
            stamp = datetime.now().strftime("%m%d_%H%M%S")
            self.model_dir = os.path.join(self.log_dir, f"{self.dataset}_{stamp}")
        if not self.data_path:
            self.data_path = os.path.join(self.data_dir, self.dataset)
        return self

    def save(self, path: Optional[str] = None) -> None:
        """Persist params.json (reference utils.py:145-152)."""
        if not self.model_dir:
            raise ValueError("Config.save needs model_dir (call finalize())")
        os.makedirs(self.model_dir, exist_ok=True)
        path = path or os.path.join(self.model_dir, "params.json")
        with open(path, "w") as fp:
            json.dump(dataclasses.asdict(self), fp, indent=4, sort_keys=True)


def get_config(argv=None) -> Config:
    parser = argparse.ArgumentParser()
    for f in dataclasses.fields(Config):
        if f.name in ("data_path",):
            continue
        default = f.default
        if isinstance(default, bool):
            parser.add_argument(f"--{f.name}", type=str2bool, default=default)
        elif default is None:
            parser.add_argument(f"--{f.name}", type=str, default=None)
        elif isinstance(default, int):
            parser.add_argument(f"--{f.name}", type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(f"--{f.name}", type=float, default=default)
        else:
            parser.add_argument(f"--{f.name}", type=str, default=default)
    args, _unknown = parser.parse_known_args(argv)
    cfg = Config(**vars(args))
    return cfg.finalize()
