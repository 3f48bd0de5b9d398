"""Inference: the serving engine."""
