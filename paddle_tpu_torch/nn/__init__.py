"""Layers, functionals and gradient clipping of the GPT path."""
from . import functional
from .clip import ClipGradByGlobalNorm
from .layers import Dropout, Embedding, LayerList, LayerNorm, Linear

__all__ = ["functional", "ClipGradByGlobalNorm", "Dropout", "Embedding",
           "LayerList", "LayerNorm", "Linear"]
