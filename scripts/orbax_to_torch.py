"""Import a checkpoint of the JAX package (orbax) into dpig_tpu_torch's
format, so that the port's `--ckpt_path` and `--pretrained_*` take it.

    python scripts/orbax_to_torch.py <orbax step dir or model_dir> \
        <port model_dir>

A model_dir stands for its newest step, as everywhere else. The output is
`<port model_dir>/ckpt/step_XXXXXXXX/state.pt` (the port's
`train/checkpoint.py`): params, frozen nets, the D's running statistics,
the optimizer moments and counts and the step, each present where the JAX
checkpoint has it (`dpig_tpu_torch.bridge.state_from_orbax`). It prints
the directory it wrote.

It reads orbax through `dpig_tpu.train.checkpoint.restore_tree`, so it
runs where JAX is installed; JAX runs on the CPU here unless JAX_PLATFORMS
says otherwise. The port itself imports no JAX and nothing of this
script.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def import_checkpoint(src: str, dst_model_dir: str) -> str:
    """Convert the orbax checkpoint at or under `src`; returns the port
    checkpoint directory written under `dst_model_dir`."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from dpig_tpu.train.checkpoint import restore_tree
    from dpig_tpu_torch.bridge import state_from_orbax
    from dpig_tpu_torch.train.checkpoint import save_tree

    tree = state_from_orbax(restore_tree(src))
    return save_tree(dst_model_dir, tree["step"], tree)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="orbax step directory or JAX model_dir")
    ap.add_argument("dst", help="port model_dir to write ckpt/step_* into")
    args = ap.parse_args(argv)
    print(import_checkpoint(args.src, args.dst))


if __name__ == "__main__":
    main()
