"""Optimizers of the training path: SGD, Adam, AdamW."""
from .optimizer import SGD, Adam, AdamW, Optimizer

__all__ = ["Optimizer", "SGD", "Adam", "AdamW"]
