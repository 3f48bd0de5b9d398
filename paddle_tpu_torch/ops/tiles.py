"""Constants of the ragged geometry, kept equal to the JAX package's.

The ragged serving step packs queries into q-blocks whose height the
reference takes from the TPU's tiling (``paddle_tpu/ops/pallas_tiles.py``
:52-53 and :143-146).  The port keeps the same numbers so that its
segment descriptors, token budget and block tables match the
reference's exactly.
"""
from __future__ import annotations

__all__ = ["NEG_INF", "STAT_LANES", "min_rows"]

#: the masked-score value of every softmax in the reference
NEG_INF = -1e30
#: the reference's per-row stat lane width; also the least q-block height
STAT_LANES = 8


def min_rows(dtype) -> int:
    """Minimum rows of a tile of ``dtype`` in the reference's tiling: 8
    for 4-byte types, 16 for 2-byte, 32 for 1-byte."""
    return {1: 32, 2: 16}.get(dtype.itemsize, 8)
