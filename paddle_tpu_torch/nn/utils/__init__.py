"""Gradient clipping, parameter vectors and weight reparametrisations:
port of ``paddle_tpu/nn/utils/__init__.py``.

* ``clip_grad_norm_`` (:15-35) scales every gradient in place by
  ``min(max_norm / (total + 1e-6), 1)``, ``total`` the ``norm_type``-norm
  of all of them together (the largest magnitude for ``inf``), and
  returns ``total``; ``clip_grad_value_`` (:38-46) clamps them in place.
* ``parameters_to_vector`` / ``vector_to_parameters`` (:49-61).
* ``weight_norm`` (:63-98) replaces ``weight`` by the parameters
  ``weight_g`` (the norm over every dim but ``dim``) and ``weight_v``,
  and a forward pre-hook sets ``weight = weight_v / |weight_v| *
  weight_g`` before each forward; ``remove_weight_norm`` (:101-115) folds
  them back into one parameter, normalising over dim 0 whatever ``dim``
  was (the reference's quirk, kept).
* ``spectral_norm`` (:118-132) adds a ``SpectralNorm`` sublayer
  ``weight_sn`` (the port's, with its power-iteration buffers) and a
  forward pre-hook that sets ``weight`` to the registered parameter over
  its largest singular value; ``weight`` stays the parameter in the
  ``state_dict``.

The hooks set the computed weight as a plain attribute of the layer, which
``forward`` then reads in place of the parameter (``Linear``, the
convolutions).
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["clip_grad_norm_", "clip_grad_value_", "parameters_to_vector",
           "vector_to_parameters", "weight_norm", "remove_weight_norm",
           "spectral_norm"]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients of ``parameters`` so that their joint
    ``norm_type``-norm is at most ``max_norm``; returns that norm (0-d,
    on the gradients' device) from before the scaling."""
    if torch.is_tensor(parameters):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros([])
    with torch.no_grad():
        if norm_type == float("inf"):
            total = torch.stack([g.abs().max() for g in grads]).max()
        else:
            total = sum((g.abs() ** norm_type).sum() for g in grads) \
                ** (1.0 / norm_type)
        coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
        for g in grads:
            g.mul_(coef.to(g.dtype))
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp every gradient of ``parameters`` to ``[-clip_value,
    clip_value]`` in place."""
    if torch.is_tensor(parameters):
        parameters = [parameters]
    with torch.no_grad():
        for p in parameters:
            if p.grad is not None:
                p.grad.clamp_(-clip_value, clip_value)


def parameters_to_vector(parameters, name=None):
    return torch.cat([p.reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of ``vec`` into ``parameters`` in place."""
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.copy_(vec[offset:offset + n].reshape(p.shape))
            offset += n


def _norm_except(v, dim):
    axes = [i for i in range(v.dim()) if i != dim]
    return torch.sqrt((v * v).sum(dim=axes, keepdim=True))


def _weight_from(g, v, dim):
    shape = [1] * v.dim()
    shape[dim] = g.numel()
    return v / _norm_except(v, dim) * g.reshape(shape)


def weight_norm(layer, name="weight", dim=0):
    """``layer``'s ``name`` reparametrised as ``g * v / |v|`` over every
    dim but ``dim``; returns ``layer``."""
    if dim is None:
        raise NotImplementedError("weight_norm over the whole tensor "
                                  "(dim=None) is not ported yet")
    w = getattr(layer, name)
    with torch.no_grad():
        g = _norm_except(w, dim).reshape(w.shape[dim])
    del layer._parameters[name]
    layer.register_parameter(name + "_g", nn.Parameter(g))
    layer.register_parameter(name + "_v", nn.Parameter(w.detach().clone()))

    def hook(mod, inputs):
        object.__setattr__(mod, name, _weight_from(
            getattr(mod, name + "_g"), getattr(mod, name + "_v"), dim))

    hook(layer, ())
    layer._wn_hook = layer.register_forward_pre_hook(hook)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``name + "_g"`` and ``name + "_v"`` back into one parameter,
    normalising over dim 0 as the reference does; returns ``layer``."""
    g = getattr(layer, name + "_g")
    v = getattr(layer, name + "_v")
    with torch.no_grad():
        w = _weight_from(g, v, 0)
    if hasattr(layer, "_wn_hook"):
        layer._wn_hook.remove()
        del layer._wn_hook
    del layer._parameters[name + "_g"]
    del layer._parameters[name + "_v"]
    layer.__dict__.pop(name, None)
    layer.register_parameter(name, nn.Parameter(w))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None, generator=None):
    """``layer``'s ``name`` divided by its largest singular value at each
    forward, through a ``SpectralNorm`` sublayer ``name + "_sn"`` whose
    power-iteration vectors are drawn from ``generator``; returns
    ``layer``."""
    from ..layer.norm import SpectralNorm
    w = getattr(layer, name)
    sn = SpectralNorm(tuple(w.shape), dim or 0, n_power_iterations, eps,
                      dtype=w.dtype, device=w.device, generator=generator)
    layer.add_module(name + "_sn", sn)

    def hook(mod, inputs):
        object.__setattr__(mod, name, sn(mod._parameters[name]))

    layer.register_forward_pre_hook(hook)
    return layer
