"""Distributed training pieces of the port: ``fleet.recompute``."""
