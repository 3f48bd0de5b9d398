"""The port stands alone: no JAX, no paddle_tpu, and no silent CPU runs.

``paddle_tpu_torch`` imports torch and numpy only.  A fresh interpreter
that imports every one of its modules must find neither ``jax`` nor
``paddle_tpu`` in ``sys.modules``, and no source file of the package may
import either.  Its entry points default to the CUDA device: on a host
without one they raise instead of running on the CPU.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference.serving import PagedKVCache

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "paddle_tpu_torch"
TINY = pt.GPTConfig(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                    num_attention_heads=2, max_position_embeddings=32)
TINY_LLAMA = pt.LlamaConfig(vocab_size=64, hidden_size=16,
                            num_hidden_layers=1, num_attention_heads=2,
                            num_key_value_heads=1, intermediate_size=32,
                            max_position_embeddings=32)
TINY_BERT = dict(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                 num_attention_heads=2, intermediate_size=32,
                 max_position_embeddings=32)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_pulls_in_no_jax_and_no_reference():
    mods = list(_modules())
    for m in ("inference.serving.engine", "core.random", "amp",
              "optimizer.optimizer", "nn.clip", "ops.softmax_xent",
              "ops.flash_attention", "distributed.fleet.recompute",
              "models.generation", "models.llama", "ops.rms_norm",
              "quantization", "models.bert", "models.ernie",
              "models.moe_gpt", "ops.grouped",
              "distributed.auto_parallel.moe_dispatch", "ops.lora",
              "ops.paged", "inference.serving.lora", "nn.functional.conv",
              "nn.functional.pooling", "nn.functional.norm",
              "nn.initializer", "nn.layer.conv", "vision.models.resnet",
              "vision.models.mobilenet", "vision.models.small_nets",
              "vision.models.densenet_googlenet", "vision.ops",
              "nn.layer.norm", "nn.layer.activation_pool"):
        assert f"paddle_tpu_torch.{m}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'"
            " or m.startswith('jax.') or m == 'paddle_tpu'"
            " or m.startswith('paddle_tpu.'))\n"
            "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|paddle_tpu)\b(?!_torch)"
    r"|from\s+(jax|paddle_tpu)\b(?!_torch))", re.M)


def test_sources_import_no_jax_and_no_reference():
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        for m in _FORBIDDEN.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(ROOT)}: {m.group(0)}")
    assert not offenders, offenders
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from paddle_tpu.ops import pallas_kernels")
    assert not _FORBIDDEN.search("from paddle_tpu_torch import ops")


def test_entry_points_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.GPTForCausalLM(TINY)
    model = pt.GPTForCausalLM(TINY, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.GenerationEngine(model, num_blocks=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(1, 2, 8, num_blocks=8)
    with pytest.raises(RuntimeError):
        pt.GPTForCausalLM(TINY, device="cuda:0")
    with pytest.raises(RuntimeError, match="unsupported device"):
        pt.GenerationEngine(model, num_blocks=8, device="meta")


def test_llama_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.LlamaForCausalLM(TINY_LLAMA)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.LlamaForCausalLM(TINY_LLAMA, device="gpu", dtype="bfloat16")
    weight = pt.LlamaForCausalLM(TINY_LLAMA, device="cpu").lm_head.weight
    assert weight.device.type == "cpu" and weight.dtype == torch.float32
    with pytest.raises(RuntimeError, match="rms norm"):
        pt.ops.rms_norm(torch.zeros(2, 16, device="meta"),
                        torch.ones(16, device="meta"))


def test_bert_and_ernie_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    for make in (lambda **kw: pt.BertForMaskedLM(
                     pt.BertConfig(**TINY_BERT), **kw),
                 lambda **kw: pt.ErnieForMaskedLM(
                     pt.ErnieConfig(**TINY_BERT), **kw),
                 lambda **kw: pt.ErnieForSequenceClassification(
                     pt.ErnieConfig(**TINY_BERT), **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        with pytest.raises(RuntimeError, match="CUDA"):
            make(device="gpu", dtype="bfloat16")
        model = make(device="cpu")
        assert model.device.type == "cpu" and model.dtype == torch.float32
    meta = torch.zeros(2, 16, device="meta")
    with pytest.raises(RuntimeError, match="layer norm residual"):
        pt.ops.layer_norm_residual(meta, meta, torch.ones(16, device="meta"),
                                   torch.zeros(16, device="meta"))


def test_moe_gpt_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = pt.MoEGPTConfig(**dict(vars(TINY), num_experts=4, top_k=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.MoEGPTForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.MoEGPTForCausalLM(cfg, device="gpu", dtype="bfloat16")
    model = pt.MoEGPTForCausalLM(cfg, device="cpu")
    assert model.device.type == "cpu" and model.dtype == torch.float32
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.GenerationEngine(model, num_blocks=8)
    meta = torch.zeros(16, 8, device="meta")
    gid = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="grouped matmul"):
        pt.ops.fused_grouped_linear_act(meta, torch.zeros(
            2, 8, 4, device="meta"), None, gid)
    with pytest.raises(RuntimeError, match="grouped dw"):
        pt.ops.fused_grouped_dw(meta, meta, gid, 2)


def test_kernel_wrappers_take_the_plain_version_only_on_cpu():
    x = torch.randn(4, 8)
    out, mu, rstd = pt.ops.fused_layer_norm(x, torch.ones(8), torch.zeros(8))
    assert out.device.type == "cpu" and mu.shape == (4,)
    before = {k: f.launches for k, f in pt.ops.KERNELS.items()}
    pt.ops.fused_linear_act(x, torch.ones(8, 3), torch.zeros(3), "relu")
    pt.ops.fused_linear_act_bwd(x, x, "gelu")
    pt.ops.softmax_xent_fwd(x, torch.zeros(4, dtype=torch.int64))
    xr = x.clone().requires_grad_()
    pt.ops.rms_norm(xr, torch.ones(8)).sum().backward()
    pt.ops.layer_norm_residual(xr, x, torch.ones(8),
                               torch.zeros(8)).sum().backward()
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    pt.ops.flash_attention(q, q, q, causal=True).sum().backward()
    codes = torch.ones(8, 3, dtype=torch.int8)
    pt.ops.fused_linear_act_int8(x, codes, torch.ones(3), torch.zeros(3))
    gid = torch.tensor([0, 2], dtype=torch.int32)
    w3 = torch.randn(2, 8, 3, requires_grad=True)
    pt.ops.grouped_linear_act(x.repeat(4, 1), w3, block_group=gid,
                              act="gelu").sum().backward()
    ints = [torch.ones(1, 1, dtype=torch.int32),
            torch.full((1,), 8, dtype=torch.int32)] + [
        torch.tensor([v], dtype=torch.int32) for v in (0, 0, 8)]
    pool = torch.ones(2, 2, 16, 8, dtype=torch.int8)
    scales = torch.ones(2, 16, 1)
    pt.ops.ragged_paged_attention(torch.randn(8, 2, 8), pool, pool, *ints,
                                  block_q=8, k_scales=scales,
                                  v_scales=scales)
    a3 = torch.randn(2, 8, 8, requires_grad=True)
    pt.ops.lora_segment_epilogue(x.repeat(4, 1)[:, :3], x.repeat(4, 1), a3,
                                 torch.randn(2, 8, 3), block_adapter=gid,
                                 act="silu").sum().backward()
    pt.ops.paged_attention(torch.randn(1, 1, 2, 8), pool.float(),
                           pool.float(), ints[0], ints[1])
    after = {k: f.launches for k, f in pt.ops.KERNELS.items()}
    assert after == before, "a CPU call is not a kernel launch"


def test_dense_flash_attention_raises_off_the_cpu():
    # the functional routes to the flash kernel's wrapper, which has no
    # kernel for any device but the card and runs its plain version only
    # on the CPU
    q = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(RuntimeError, match="flash attention"):
        pt.nn.functional.scaled_dot_product_attention(q, q, q,
                                                      is_causal=True)


def test_lora_and_paged_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from paddle_tpu_torch.inference.serving import LoRAAdapterStore
    sites = [("blk.fc1", 16, 32)]
    with pytest.raises(RuntimeError, match="CUDA"):
        LoRAAdapterStore(sites, rank=4)
    store = LoRAAdapterStore(sites, rank=4, device="cpu")
    assert store.pair("blk.fc1")[0].device.type == "cpu"
    meta = torch.zeros(16, 8, device="meta")
    gid = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="lora epilogue"):
        pt.ops.fused_lora_segment_epilogue(
            meta, meta, torch.zeros(1, 8, 8, device="meta"),
            torch.zeros(1, 8, 8, device="meta"), gid)
    q = torch.zeros(1, 1, 2, 8, device="meta")
    with pytest.raises(RuntimeError, match="paged attention"):
        pt.ops.paged_attention(q, torch.zeros(2, 2, 8, 8, device="meta"),
                               torch.zeros(2, 2, 8, 8, device="meta"),
                               torch.zeros(1, 1, dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32))
