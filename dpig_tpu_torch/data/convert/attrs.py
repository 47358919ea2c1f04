"""Per-id attribute ingestion for the Market converter
(reference convert_market.py:755-800 mat loading, :411-434 lookup): the
port's own copy of `dpig_tpu/data/convert/attrs.py`.

The Market-1501 attribute bundle ships as .mat files:
  * market_attribute.mat: structured array with one named field per
    attribute; field values are indexed by person-id ORDER OF FIRST
    APPEARANCE in the sorted image file list (id_map_attr,
    convert_market.py:760-770).
  * {train,test}_att_wordvec_dim{25,50,100,150}.mat: word2vec attribute
    embeddings, rows concatenated per id (convert_market.py:428-446).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

W2V_DIMS = (25, 50, 100, 150)


def build_id_map(filenames: Sequence[str]) -> Dict[str, int]:
    """person-id (first 4 chars) -> index of first appearance, over the
    SORTED file list (convert_market.py:762-770)."""
    id_map: Dict[str, int] = {}
    for name in sorted(filenames):
        pid = name[0:4]
        if pid not in id_map:
            id_map[pid] = len(id_map)
    return id_map


class MarketAttributes:
    """Lazy holder for the attribute .mats; returns per-id vectors."""

    def __init__(self, onehot_mat_path: Optional[str] = None,
                 w2v_dir: Optional[str] = None, split: str = "train",
                 filenames: Optional[Sequence[str]] = None):
        import scipy.io
        self.id_map = build_id_map(filenames or [])
        mat_split = "test" if split.startswith("test") else split
        self.onehot = None
        if onehot_mat_path:
            self.onehot = scipy.io.loadmat(
                onehot_mat_path)["market_attribute"][mat_split][0][0]
        self.w2v: Dict[int, np.ndarray] = {}
        if w2v_dir:
            key = "test_att" if mat_split == "test" else "train_att"
            for dim in W2V_DIMS:
                p = os.path.join(w2v_dir,
                                 f"{key}_wordvec_dim{dim}.mat")
                if os.path.exists(p):
                    self.w2v[dim] = scipy.io.loadmat(p)[key]

    def onehot_for(self, person_id: str) -> Optional[List[int]]:
        if self.onehot is None:
            return None
        idx = self.id_map[person_id]
        return [int(self.onehot[name][0][0][0][idx])
                for name in self.onehot.dtype.names]

    def w2v_for(self, person_id: str) -> Dict[int, List[float]]:
        """dim -> concatenated per-attribute embedding rows
        (convert_market.py:428-446)."""
        out: Dict[int, List[float]] = {}
        idx = self.id_map.get(person_id)
        if idx is None:
            return out
        for dim, mat in self.w2v.items():
            vals: List[float] = []
            for i in range(mat[0].shape[0]):
                vals.extend(np.asarray(mat[0][i][idx]).ravel().tolist())
            out[dim] = vals
        return out
