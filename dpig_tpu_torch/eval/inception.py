"""Inception Score protocol: the port's own copy of
`dpig_tpu/eval/inception.py:23-56` (tflib/inception_score.py:25-55:
batches of 100, 10 splits, IS = exp(mean_split KL(p(y|x) || p(y)))), in
float64 on the images' device.

The classifier is the caller's `logits_fn`. The port has none of its own:
the protocol's classifier is the 2015-12-05 frozen Inception graph, which
needs TensorFlow and a download, and neither is in the repo nor on the
card's machine, so `eval/score.py` skips IS (ROADMAP "Later").
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

SPLITS = 10       # tflib/inception_score.py:25
BATCH_SIZE = 100  # tflib/inception_score.py:35
F64 = torch.float64


def inception_score_from_probs(preds, splits: int = SPLITS
                               ) -> Tuple[float, float]:
    """exp(mean KL) over `splits` chunks of preds [N, classes]; the mean
    and the population std over the splits."""
    preds = torch.as_tensor(preds).to(F64)
    n = preds.shape[0]
    scores = []
    for i in range(splits):
        part = preds[(i * n // splits):((i + 1) * n // splits)]
        kl = part * (torch.log(part) - torch.log(part.mean(0, keepdim=True)))
        scores.append(torch.exp(kl.sum(1).mean()))
    scores = torch.stack(scores)
    return float(scores.mean()), float(scores.std(correction=0))


def get_inception_score(images: Sequence,
                        logits_fn: Callable[[torch.Tensor], object],
                        splits: int = SPLITS, batch_size: int = BATCH_SIZE
                        ) -> Tuple[float, float]:
    """images: [H,W,3] uint8-range arrays or tensors, or one [N,H,W,3]
    batch. `logits_fn` takes float32 batches [n,H,W,3] on the images'
    device and returns logits or probabilities [n, classes] (a tensor or
    an array); rows that are not probabilities go through a softmax."""
    if not (isinstance(images, (list, tuple)) or images.ndim == 4):
        raise AssertionError("images must be a list of [H,W,3] images or "
                             "one [N,H,W,3] batch")
    device = torch.as_tensor(images[0]).device
    preds = []
    n = len(images)
    for i in range((n + batch_size - 1) // batch_size):
        batch = torch.stack([torch.as_tensor(im) for im in
                             images[i * batch_size:(i + 1) * batch_size]])
        p = torch.as_tensor(logits_fn(batch.to(torch.float32)),
                            device=device).to(F64)
        ones = torch.ones(p.shape[0], dtype=F64, device=device)
        if (p < 0).any() or not torch.allclose(p.sum(-1), ones, atol=1e-3):
            p = torch.exp(p - p.amax(-1, keepdim=True))
            p = p / p.sum(-1, keepdim=True)
        preds.append(p)
    return inception_score_from_probs(torch.cat(preds, 0), splits)
