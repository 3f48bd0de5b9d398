"""``paddle.distributed.auto_parallel`` of the port: dropless MoE routing
(`moe_dispatch`)."""
from . import moe_dispatch

__all__ = ["moe_dispatch"]
