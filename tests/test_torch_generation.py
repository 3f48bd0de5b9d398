"""``generate()`` in the port vs the JAX reference, from the same weights.

The reference's tiny GPT (vocab 256, hidden 64, 2 layers, 4 heads) is
built from a seed in eval mode and its weights go to the port through
``convert.load_reference_state``.  Both decode the same prompt ids with
their dense KV caches (prefill, then one token a step; the port's
attention is its plain flash version, the reference's its composite on
the CPU).  Their logits agree to about 1e-6, and both choose tokens on
the host with the same numpy code (``_sample_logits``, numpy's
``default_rng(seed)``), so greedy and seeded sampled tokens must be
identical.  The limits (``max_length``, the position table, eos/pad)
follow ``tests/test_models.py``'s generate cases.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.generation import generate as ref_generate
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT

import paddle_tpu_torch as pt
from paddle_tpu_torch.models.generation import generate

TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64)


def _pair(seed=21, **over):
    cfg = dict(TINY, **over)
    paddle.seed(seed)
    ref = RefGPT(RefConfig(**cfg))
    ref.eval()
    port = pt.GPTForCausalLM(pt.GPTConfig(**cfg), device="cpu").eval()
    pt.load_reference_state(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    return ref, port


@pytest.fixture(scope="module")
def models():
    return _pair()


def _ids(b=2, s=7, seed=3, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _both(models, ids, **kw):
    ref, port = models
    want = np.asarray(ref_generate(ref, ids, **kw).numpy())
    got = port.generate(torch.from_numpy(ids), **kw)
    assert got.dtype == torch.int64
    return want, got.numpy()


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=12),
    dict(max_new_tokens=10, do_sample=True, seed=5),
    dict(max_new_tokens=10, do_sample=True, top_k=10, temperature=0.8,
         seed=0),
    dict(max_new_tokens=10, do_sample=True, top_p=0.9, seed=7),
    dict(max_new_tokens=10, do_sample=True, top_k=20, top_p=0.7,
         temperature=1.3, seed=11),
], ids=["greedy", "sample", "top_k", "top_p", "top_k_top_p"])
def test_tokens_match_reference(models, kw):
    ids = _ids()
    want, got = _both(models, ids, **kw)
    assert got.shape == (2, 7 + kw["max_new_tokens"])
    np.testing.assert_array_equal(got[:, :7], ids)
    np.testing.assert_array_equal(got, want)


def test_max_length_and_position_table():
    ref, port = _pair(seed=7, vocab_size=32, hidden_size=16,
                      num_hidden_layers=1, num_attention_heads=2,
                      max_position_embeddings=8)
    ids = _ids(1, 6, seed=3, vocab=32)
    for kw, width in ((dict(max_new_tokens=50), 8),
                      (dict(max_new_tokens=1, do_sample=True, top_k=1000,
                            seed=0), 7),
                      (dict(max_length=7, max_new_tokens=50), 7)):
        want, got = _both((ref, port), ids, **kw)
        assert got.shape == (1, width), kw
        np.testing.assert_array_equal(got, want)
    assert port.generate(torch.from_numpy(ids[0]),
                         max_new_tokens=1).shape == (1, 7)


def test_eos_and_pad_match_reference(models):
    ids = _ids(3, 5, seed=9)
    greedy = _both(models, ids, max_new_tokens=8)[1]
    eos = int(greedy[0, 5 + 2])        # row 0 stops at its third token
    for pad in (None, 0):
        want, got = _both(models, ids, max_new_tokens=8, eos_token_id=eos,
                          pad_token_id=pad)
        np.testing.assert_array_equal(got, want)
        row = got[0, 5:]
        stop = int(np.argmax(row == eos))
        fill = eos if pad is None else pad
        assert (row[stop + 1:] == fill).all()


def test_dense_cache_logits_match_full_forward(models):
    _, port = models
    ids = _ids(2, 13, seed=4)
    with torch.no_grad():
        full = port(torch.from_numpy(ids))
        logits, cache = port(torch.from_numpy(ids[:, :9]), use_cache=True)
        steps = [logits]
        for t in range(9, 13):
            logits, cache = port(torch.from_numpy(ids[:, t:t + 1]),
                                 cache=cache, use_cache=True)
            steps.append(logits)
    assert len(cache) == 2 and cache[0][0].shape == (2, 13, 4, 16)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               atol=1e-4, rtol=1e-4)


def test_generate_function_and_model_without_cache(models):
    _, port = models
    ids = _ids()
    a = generate(port, ids, max_new_tokens=4)
    b = port.generate(torch.from_numpy(ids), max_new_tokens=4)
    assert torch.equal(a, b)

    class NoCache(torch.nn.Module):
        """A model whose forward takes no cache: every step reruns the
        whole sequence."""

        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, input_ids):
            return self.inner(input_ids)

    assert torch.equal(generate(NoCache(port), ids, max_new_tokens=4), a)
