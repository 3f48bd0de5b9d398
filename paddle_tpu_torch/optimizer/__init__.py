"""Optimizers (``optimizer.py``, ``extra.py``) and learning-rate
schedulers (``lr``)."""
from . import lr
from .extra import ASGD, LBFGS, NAdam, RAdam, Rprop
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        Momentum, Optimizer, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Rprop", "ASGD",
           "NAdam", "RAdam", "LBFGS"]
