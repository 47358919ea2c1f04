"""Published peaks of the cards the benchmark knows, by the name
`torch.cuda.get_device_name()` gives: NVIDIA's data sheet for the H100 SXM
(dense rates, no sparsity, at the full 700 W power limit). A card that is
not listed has no peak, and no share of a peak is reported for it."""
from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "float32": 67e12,          # FLOP/s outside the tensor cores
        "tf32": 495e12,
        "bfloat16": 989e12,
        "int8": 1979e12,           # OP/s
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak(kind: str, what: str) -> Optional[float]:
    return PEAKS.get(kind, {}).get(what)
