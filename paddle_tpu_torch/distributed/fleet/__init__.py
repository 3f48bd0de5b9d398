"""``paddle.distributed.fleet``: activation recompute."""
from .recompute import recompute

__all__ = ["recompute"]
