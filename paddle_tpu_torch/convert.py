"""Carry the JAX model's weights over to the port.

``load_reference_state`` takes the reference model's ``state_dict()`` as
numpy arrays keyed by the reference's names (``gpt.wte.weight``,
``llama.layers.0.self_attn.q_proj.weight``, ...; what ``{k: v.numpy()
for k, v in model.state_dict().items()}`` gives on the JAX side) and
copies them into the port's parameters and persistent buffers of the same
names (LLaMA's rope tables ``llama.rope_cos``/``llama.rope_sin`` are
such buffers).  The layouts are the same (Linear weights ``[in, out]``),
so nothing is transposed.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_reference_state"]


def load_reference_state(model, params):
    """Copy ``params`` (name -> array) into ``model``'s parameters and
    persistent buffers in place, cast to each one's dtype on its device.
    Buffers are copied, not checked: the rope tables the reference holds
    (f32, or bf16 after its ``astype``) overwrite the port's own, which
    are built from the same f64 numbers.  Shapes must match exactly; a
    missing or an extra key raises ``KeyError``.  Returns ``model``."""
    own = model.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f"reference state does not match the model: "
                       f"missing {missing}, unexpected {extra}")
    arrays = {name: np.asarray(params[name]) for name in own}
    for name, arr in arrays.items():
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: reference shape {tuple(arr.shape)} "
                             f"!= {tuple(own[name].shape)}")
    with torch.no_grad():
        for name, arr in arrays.items():
            if arr.dtype.name == "bfloat16":    # ml_dtypes, not torch
                arr = arr.astype(np.float32)
            own[name].copy_(torch.tensor(arr))
    return model
