"""Pair mining (reference convert_market.py:114-219, convert_DF.py:111-160):
the port's own copy of `dpig_tpu/data/convert/pairs.py`, the same lists
in the same order.

Market filenames: '<id:4>_c<cam>s...' -> id = name[0:4], cam = name[6].
DeepFashion:      '<id>_...'          -> id = name.split('_')[0].
"""
from __future__ import annotations

import random
from typing import List, Sequence, Tuple

Pair = Tuple[str, str]


def market_id_cam(name: str) -> Tuple[str, str]:
    return name[0:4], name[6]


def df_id(name: str) -> str:
    return name.split("_")[0]


def mine_pairs_market(filelist: Sequence[str], mode: str = "same_diff_cam",
                      augment_ratio: int = 1, add_switch_pair: bool = True,
                      seed: int = 0) -> Tuple[List[Pair], List[Pair]]:
    """Positive/negative pair mining by person-id/camera
    (convert_market.py:141-199)."""
    p_pairs: List[Pair] = []
    n_pairs: List[Pair] = []
    n = len(filelist)
    for i in range(n):
        id_i, cam_i = market_id_cam(filelist[i])
        for j in range(i + 1, n):
            id_j, cam_j = market_id_cam(filelist[j])
            if mode == "diff_cam":
                if id_j == id_i and cam_j != cam_i:
                    p_pairs.append((filelist[i], filelist[j]))
                elif j % 10 == 0 and id_j != id_i and cam_j != cam_i:
                    n_pairs.append((filelist[i], filelist[j]))
            elif mode == "same_cam":
                if id_j == id_i and cam_j == cam_i:
                    p_pairs.append((filelist[i], filelist[j]))
                elif j % 10 == 0 and id_j != id_i and cam_j == cam_i:
                    n_pairs.append((filelist[i], filelist[j]))
            elif mode == "same_diff_cam":
                if id_j == id_i:
                    p_pairs.append((filelist[i], filelist[j]))
                    if add_switch_pair:
                        p_pairs.append((filelist[j], filelist[i]))
                elif j % 2000 == 0 and id_j != id_i:
                    n_pairs.append((filelist[i], filelist[j]))
            else:
                raise ValueError(mode)
    p_pairs = list(p_pairs) * augment_ratio
    rng = random.Random(seed)  # converter seeds random(0), convert_market.py:39-40
    rng.shuffle(n_pairs)
    n_pairs = n_pairs[:len(p_pairs)]
    return p_pairs, n_pairs


def mine_pairs_df(filelist: Sequence[str], test_seq: bool = False,
                  seed: int = 0) -> Tuple[List[Pair], List[Pair]]:
    """DF mining: same-id positives both directions; test_seq = all ordered
    pairs (convert_DF.py:138-160)."""
    p_pairs: List[Pair] = []
    n_pairs: List[Pair] = []
    n = len(filelist)
    if test_seq:
        for i in range(n):
            for j in range(n):
                p_pairs.append((filelist[i], filelist[j]))
        return p_pairs, n_pairs
    for i in range(n):
        id_i = df_id(filelist[i])
        for j in range(i + 1, n):
            id_j = df_id(filelist[j])
            if id_j == id_i:
                p_pairs.append((filelist[i], filelist[j]))
                p_pairs.append((filelist[j], filelist[i]))
            elif j % 2000 == 0:
                n_pairs.append((filelist[i], filelist[j]))
    rng = random.Random(seed)
    rng.shuffle(n_pairs)
    n_pairs = n_pairs[:len(p_pairs)]
    return p_pairs, n_pairs
