"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package serves
the same GPT model on an NVIDIA H100 through kernels written by hand in
CUDA C++ for Hopper (``csrc/``), each with a plain PyTorch version that
the CPU runs.  It imports torch and numpy, never JAX and never
``paddle_tpu``.  Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.

Ported so far: the serving path (``models.gpt`` through
``inference.serving.GenerationEngine``) and its three kernels, ragged
paged attention, layer norm and the matmul epilogue (see ``ops``).
"""
from .convert import load_reference_state
from .models.gpt import GPT_1P3B, GPTConfig, GPTForCausalLM
from .inference.serving import GenerationEngine

__all__ = ["load_reference_state", "GPT_1P3B", "GPTConfig",
           "GPTForCausalLM", "GenerationEngine"]
