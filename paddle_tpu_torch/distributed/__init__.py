"""Distributed training pieces of the port: ``fleet.recompute`` and the
dropless MoE routing of ``auto_parallel.moe_dispatch``."""
from . import auto_parallel, fleet

__all__ = ["auto_parallel", "fleet"]
