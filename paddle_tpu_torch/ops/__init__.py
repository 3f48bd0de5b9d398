"""The port's kernels: hand-written CUDA for Hopper, each with a plain
PyTorch version beside it.

=====================  ======================================  =========================
wrapper                CUDA source                             replaces (TPU kernel)
=====================  ======================================  =========================
fused_layer_norm       csrc/layer_norm.cu                      pallas_kernels.py:522
fused_linear_act       csrc/matmul_epilogue.cu                 pallas_fused.py:266
ragged_paged_attention csrc/ragged_attention.cu                pallas_ragged.py:115/189
=====================  ======================================  =========================

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches its kernel (built at first use by `cuda_lib`) or raises.
Each wrapper counts its launches in a ``launches`` attribute.
"""
from .layer_norm import fused_layer_norm, layer_norm_ref
from .matmul_epilogue import (ACTIVATIONS, fused_linear_act,
                              linear_act_ref)
from .ragged import (ragged_attention_ref, ragged_paged_attention,
                     ragged_q_block, ragged_segments)

__all__ = ["fused_layer_norm", "layer_norm_ref", "ACTIVATIONS",
           "fused_linear_act", "linear_act_ref", "ragged_attention_ref",
           "ragged_paged_attention", "ragged_q_block", "ragged_segments",
           "KERNELS"]

#: every kernel wrapper of the serving path, by kernel name
KERNELS = {
    "ragged_attention": ragged_paged_attention,
    "layer_norm": fused_layer_norm,
    "matmul_epilogue": fused_linear_act,
}
