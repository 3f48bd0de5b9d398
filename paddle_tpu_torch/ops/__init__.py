"""The port's kernels: hand-written CUDA for Hopper, each with a plain
PyTorch version beside it.

=============================  ===================  ========================
wrapper                        csrc/ source         replaces (TPU kernel)
=============================  ===================  ========================
ragged_paged_attention         ragged_attention.cu  pallas_ragged.py:115/189
fused_layer_norm               layer_norm.cu        pallas_kernels.py:522
fused_linear_act               matmul_epilogue.cu   pallas_fused.py:266
fused_layer_norm_bwd           layer_norm.cu        pallas_kernels.py:536
fused_linear_act_bwd           matmul_epilogue.cu   pallas_fused.py:278
softmax_xent_fwd               softmax_xent.cu      pallas_kernels.py:759
softmax_xent_bwd               softmax_xent.cu      pallas_kernels.py:802
fused_flash_attention_fwd      flash_attention.cu   pallas_kernels.py:78
fused_flash_attention_bwd_dq   flash_attention.cu   pallas_kernels.py:128
fused_flash_attention_bwd_dkv  flash_attention.cu   pallas_kernels.py:170
fused_rms_norm                 rms_norm.cu          pallas_kernels.py:648
fused_rms_norm_bwd             rms_norm.cu          pallas_kernels.py:658
ragged_paged_attention_int8    ragged_attention.cu  pallas_ragged.py:197
fused_linear_act_int8          matmul_epilogue.cu   pallas_fused.py:406
fused_layer_norm_residual      layer_norm.cu        pallas_fused.py:101
fused_grouped_linear_act       grouped_matmul.cu    pallas_grouped.py:85
fused_grouped_dw               grouped_matmul.cu    pallas_grouped.py:133
fused_lora_segment_epilogue    lora_sgmv.cu         pallas_grouped.py:355
paged_attention                paged_attention.cu   pallas_kernels.py:898
=============================  ===================  ========================

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches its kernel (built at first use by `cuda_lib`) or raises.
Each wrapper counts its launches in a ``launches`` attribute.
`layer_norm`, `layer_norm_residual`, `rms_norm`, `linear_act`,
`fused_softmax_cross_entropy`, `flash_attention`, `grouped_linear_act`
and `lora_segment_epilogue` are the differentiable entry points:
``torch.autograd.Function``s whose backward is the backward kernel (for
the residual layer norm, the layer-norm backward on the saved sum; for
flash attention, the dq and the dk/dv kernels; for the grouped matmul,
the forward kernel on the transposed weights for dx and the dw kernel;
for the LoRA epilogue, the grouped forward and dw kernels over the
adapter stacks).  `paged_attention` serves decoding only.
"""
from .flash_attention import (flash_attention, flash_attention_bwd_ref,
                              flash_attention_ref, flash_bwd_stats,
                              fused_flash_attention_bwd_dkv,
                              fused_flash_attention_bwd_dq,
                              fused_flash_attention_fwd)
from .grouped import (fused_grouped_dw, fused_grouped_linear_act,
                      group_segments, grouped_block_rows, grouped_dw_ref,
                      grouped_dw_slices, grouped_layout, grouped_linear_act,
                      grouped_linear_act_ref, num_group_blocks)
from .layer_norm import (fused_layer_norm, fused_layer_norm_bwd,
                         fused_layer_norm_residual, layer_norm,
                         layer_norm_bwd_ref, layer_norm_ref,
                         layer_norm_residual, layer_norm_residual_ref)
from .lora import (fused_lora_segment_epilogue, lora_rank_pad,
                   lora_segment_epilogue, lora_segment_epilogue_ref)
from .matmul_epilogue import (ACTIVATIONS, fused_linear_act,
                              fused_linear_act_bwd, fused_linear_act_int8,
                              linear_act, linear_act_bwd_ref,
                              linear_act_int8_ref, linear_act_ref)
from .rms_norm import (fused_rms_norm, fused_rms_norm_bwd, rms_norm,
                       rms_norm_bwd_ref, rms_norm_ref)
from .paged import MAX_HEAD_DIM, paged_attention, paged_attention_ref
from .ragged import (KV_SCALE_LANES, ragged_attention_ref,
                     ragged_paged_attention, ragged_paged_attention_int8,
                     ragged_q_block, ragged_segments)
from .softmax_xent import (fused_softmax_cross_entropy, softmax_xent_bwd,
                           softmax_xent_bwd_ref, softmax_xent_fwd,
                           softmax_xent_fwd_ref)

__all__ = ["fused_layer_norm", "fused_layer_norm_bwd", "layer_norm",
           "layer_norm_bwd_ref", "layer_norm_ref", "ACTIVATIONS",
           "fused_linear_act", "fused_linear_act_bwd", "linear_act",
           "linear_act_bwd_ref", "linear_act_ref", "ragged_attention_ref",
           "ragged_paged_attention", "ragged_q_block", "ragged_segments",
           "fused_softmax_cross_entropy", "softmax_xent_bwd",
           "softmax_xent_bwd_ref", "softmax_xent_fwd",
           "softmax_xent_fwd_ref", "flash_attention",
           "flash_attention_bwd_ref", "flash_attention_ref",
           "flash_bwd_stats", "fused_flash_attention_bwd_dkv",
           "fused_flash_attention_bwd_dq", "fused_flash_attention_fwd",
           "fused_rms_norm", "fused_rms_norm_bwd", "rms_norm",
           "rms_norm_bwd_ref", "rms_norm_ref", "fused_linear_act_int8",
           "linear_act_int8_ref", "KV_SCALE_LANES",
           "ragged_paged_attention_int8", "fused_layer_norm_residual",
           "layer_norm_residual", "layer_norm_residual_ref",
           "fused_grouped_dw", "fused_grouped_linear_act", "group_segments",
           "grouped_block_rows", "grouped_dw_ref", "grouped_dw_slices",
           "grouped_layout", "grouped_linear_act", "grouped_linear_act_ref",
           "num_group_blocks",
           "fused_lora_segment_epilogue", "lora_rank_pad",
           "lora_segment_epilogue", "lora_segment_epilogue_ref",
           "MAX_HEAD_DIM", "paged_attention", "paged_attention_ref",
           "KERNELS"]

#: every kernel wrapper of the serving, training, LLaMA, int8 serving,
#: BERT/ERNIE, MoE, multi-LoRA and paged decode paths, by kernel name
KERNELS = {
    "ragged_attention": ragged_paged_attention,
    "layer_norm": fused_layer_norm,
    "matmul_epilogue": fused_linear_act,
    "layer_norm_bwd": fused_layer_norm_bwd,
    "matmul_epilogue_bwd": fused_linear_act_bwd,
    "softmax_xent_fwd": softmax_xent_fwd,
    "softmax_xent_bwd": softmax_xent_bwd,
    "flash_attention_fwd": fused_flash_attention_fwd,
    "flash_attention_bwd_dq": fused_flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": fused_flash_attention_bwd_dkv,
    "rms_norm": fused_rms_norm,
    "rms_norm_bwd": fused_rms_norm_bwd,
    "ragged_attention_int8": ragged_paged_attention_int8,
    "matmul_epilogue_int8": fused_linear_act_int8,
    "layer_norm_residual": fused_layer_norm_residual,
    "grouped_matmul": fused_grouped_linear_act,
    "grouped_matmul_dw": fused_grouped_dw,
    "lora_sgmv": fused_lora_segment_epilogue,
    "paged_attention": paged_attention,
}
