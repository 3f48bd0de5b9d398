"""Dtype names <-> torch dtypes.

Port of ``paddle_tpu/core/dtypes.py``: the reference wraps numpy dtypes
in Paddle ``DType`` objects; the port uses ``torch.dtype`` itself and
keeps only the name mapping, so a configuration written with the
reference's names ("float32", "bfloat16", "paddle.float32") means the
same here.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_torch_dtype", "dtype_name"]

_BY_NAME = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}
_NAME_OF = {v: k for k, v in _BY_NAME.items()}


def to_torch_dtype(d) -> torch.dtype:
    """A torch dtype from a torch dtype, a name ("float32",
    "paddle.bfloat16") or a numpy dtype."""
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        name = d.removeprefix("paddle.").removeprefix("torch.")
        if name in _BY_NAME:
            return _BY_NAME[name]
        d = np.dtype(name)
    name = np.dtype(d).name
    if name not in _BY_NAME:
        raise TypeError(f"unsupported dtype {d!r}")
    return _BY_NAME[name]


def dtype_name(d) -> str:
    """The reference's name of a dtype ("float32", "bfloat16", ...)."""
    return _NAME_OF[to_torch_dtype(d)]

