"""What every vision model's constructor does: resolve the device, make
the generator, refuse ``pretrained=True`` and name the parameters."""
from __future__ import annotations

import torch

from ...core import resolve_device, to_torch_dtype


def layer_kwargs(device, dtype, generator):
    """``dict(device=, dtype=, generator=)`` for the layers: ``device``
    resolved (the card when None), ``generator`` seeded with 0 on it when
    None."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return dict(device=device, dtype=to_torch_dtype(dtype),
                generator=generator)


def no_pretrained(pretrained):
    if pretrained:
        raise NotImplementedError(
            "pretrained=True: pretrained weights are not ported and nothing "
            "is downloaded; load a reference state with "
            "load_reference_state instead")


def name_parameters(model):
    """Each parameter's structured name as ``.param_name`` (a tensor's
    ``.name`` is torch's own), which the optimizers read."""
    for name, p in model.named_parameters():
        p.param_name = name
    return model
