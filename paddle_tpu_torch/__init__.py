"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package serves
and trains the same GPT, MoE-GPT, LLaMA, BERT and ERNIE models on an
NVIDIA H100 through kernels written by hand in CUDA C++ for Hopper
(``csrc/``), each with a plain PyTorch version that the CPU runs.  It imports torch and numpy,
never JAX and never ``paddle_tpu``.  Entry points run on the CUDA device
unless the caller passes ``device="cpu"``.

Ported so far (see ``ops`` for the kernels):

* serving: ``models.gpt`` through ``inference.serving.GenerationEngine``,
  with ragged paged attention, layer norm and the matmul epilogue;
* training: ``GPTPretrainingCriterion``, ``amp.auto_cast`` (bf16, O1
  and O2), ``amp.decorate``, ``amp.GradScaler``, ``amp.debugging``, the
  14 optimizers of ``optimizer`` (multi-tensor updates), the 17
  schedulers of ``optimizer.lr``, ``regularizer.{L1Decay, L2Decay}`` and
  the three clips of ``nn``, with the backward kernels of layer norm and
  the matmul epilogue and the softmax cross-entropy kernels, forward and
  backward;
* flash attention: GPT's dense attention (``use_flash_attention=True``,
  the default) through the flash-attention kernels, forward, dq and
  dk/dv; ``use_recompute=True`` through ``distributed.fleet.recompute``;
  and ``GPTForCausalLM.generate`` over the dense KV cache
  (``models.generation``);
* LLaMA: ``models.llama`` (RMSNorm, rotary embeddings, grouped-query
  attention, SwiGLU; the ``LLAMA_7B`` preset), trained with recompute
  and served by ``LlamaForCausalLM.generate`` over the dense KV cache,
  with the RMS-norm kernels forward and backward;
* int8 serving: ``quantization.convert_to_int8`` (weight-only int8
  Linears through the int8 matmul-epilogue kernel) and the int8 paged
  KV cache (per-slot scales, the int8 ragged-attention kernel), both
  selected by ``GenerationEngine(weight_dtype="int8",
  kv_cache_dtype="int8")``;
* BERT and ERNIE: ``models.bert`` (``BertForMaskedLM``, trained with
  attention and hidden dropout) and ``models.ernie`` (``ErnieModel`` with
  its tanh pooler, the MLM and sequence-classification heads), whose
  post-norm layers add the residual inside the fused residual layer-norm
  kernel, and whose attention runs the flash kernels without causality
  in eval (with dropout, the composite);
* MoE-GPT: ``models.moe_gpt`` (dropless top-k routing,
  ``distributed.auto_parallel.moe_dispatch``; stacked experts through the
  grouped-matmul kernels, forward and weight gradient), served by the
  ``GenerationEngine`` and trained with ``MoEGPTPretrainingCriterion``'s
  load-balance term;
* multi-LoRA: ``inference.serving.lora`` (``convert_to_lora`` for
  fine-tuning, merge and unmerge, the paged adapter store) with the
  segmented SGMV epilogue kernel, whose backward runs the grouped-matmul
  kernels; ``GenerationEngine.enable_lora`` serves many adapters and
  base-model rows in one step;
* the paged decode view: ``inference.serving.PagedCacheView`` in its
  prefill and decode modes, decode through the paged-attention kernel;
* vision: ``vision.models`` (LeNet, the ResNet family with ResNeXt and
  the wide variants, VGG, MobileNetV2) on ``nn``'s convolutions, pools,
  batch norms, ``ReLU``/``ReLU6``, ``Flatten`` and ``Sequential``
  (``nn.layer``), their functionals (``nn.functional.{conv, pooling,
  norm, activation}``: cuDNN convolutions and batch norm, as the
  reference leaves them to XLA) and ``nn.initializer``; trained with the
  softmax cross-entropy kernels on their logits;
* execution tiers: ``jit.to_static`` captures a step into a CUDA graph
  per call signature and replays it (``jit.trace``), with the
  optimizers' learning rate and step count on the device and the
  in-flight window of ``core.pipeline``; the serving engine's unified
  ragged step runs through it, as the reference's does.
"""
from . import (amp, distributed, jit, nn, optimizer, quantization,
               regularizer, vision)
from .convert import load_reference_state
from .models.bert import BertConfig, BertForMaskedLM
from .models.ernie import (ErnieConfig, ErnieForMaskedLM,
                           ErnieForSequenceClassification)
from .models.gpt import (GPT_1P3B, GPTConfig, GPTForCausalLM,
                         GPTPretrainingCriterion)
from .models.llama import LLAMA_7B, LlamaConfig, LlamaForCausalLM
from .models.moe_gpt import (MoEGPTConfig, MoEGPTForCausalLM,
                             MoEGPTPretrainingCriterion)
from .inference.serving import (GenerationEngine, PagedCacheView,
                                convert_to_lora, merge_lora, unmerge_lora)

__all__ = ["amp", "distributed", "jit", "nn", "optimizer", "quantization",
           "regularizer", "vision",
           "load_reference_state", "BertConfig", "BertForMaskedLM",
           "ErnieConfig", "ErnieForMaskedLM",
           "ErnieForSequenceClassification", "GPT_1P3B",
           "GPTConfig", "GPTForCausalLM", "GPTPretrainingCriterion",
           "LLAMA_7B", "LlamaConfig", "LlamaForCausalLM", "MoEGPTConfig",
           "MoEGPTForCausalLM", "MoEGPTPretrainingCriterion",
           "GenerationEngine", "PagedCacheView", "convert_to_lora",
           "merge_lora", "unmerge_lora"]
