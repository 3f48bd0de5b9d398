"""Dtype names and device resolution."""
from .dtypes import dtype_name, to_torch_dtype
from .place import resolve_device

__all__ = ["dtype_name", "to_torch_dtype", "resolve_device"]
