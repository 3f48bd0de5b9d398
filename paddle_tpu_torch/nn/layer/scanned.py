"""``scan_layer_stack``: port of ``paddle_tpu/nn/layer/scanned.py:27``.

The reference runs N structurally identical layers as one ``lax.scan``
over their stacked weights, an XLA compile-time lever: the program stays
one layer long whatever the depth.  Its value is the unrolled stack's,
and under ``remat`` each layer is recomputed in the backward.  PyTorch
runs eagerly and compiles nothing, so the port runs the same stack as a
loop over the layers, each through ``distributed.fleet.recompute`` when
``remat`` is set.
"""
from __future__ import annotations

__all__ = ["scan_layer_stack"]


def scan_layer_stack(layers, x, remat=False):
    """``x`` through each of ``layers`` in turn (called with ``x``
    alone); with ``remat`` each layer keeps only its input for the
    backward, which runs it again."""
    layers = list(layers)
    if len({len(list(layer.parameters())) for layer in layers}) > 1:
        raise ValueError("scan_layer_stack: layers differ in param count")
    if remat and len(layers) > 1:
        from ...distributed.fleet.recompute import recompute
        for layer in layers:
            x = recompute(layer, x)
        return x
    for layer in layers:
        x = layer(x)
    return x
