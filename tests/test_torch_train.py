"""GPT training in the port vs the JAX reference, from the same weights.

The reference's tiny GPT (vocab 256, hidden 64, 2 layers, 4 heads,
``use_flash_attention=False``, and with flash attention and recompute
on) is built from a seed and its weights go to the port through
``convert.load_reference_state``.  Both then train
eagerly on the same ids and labels (made with numpy, one label set to
the ignore index): ``GPTPretrainingCriterion``, ``loss.backward()``, an
optimizer step with ``ClipGradByGlobalNorm(1.0)``, ``clear_grad()``.
The reference runs its XLA composites on the CPU (its Pallas gate is
closed here), the port its plain kernel versions with their plain
backwards.

Tolerances:
* f32: the loss of each step, every parameter gradient of step 1 and
  every parameter after 3 steps within 1e-4 abs + 1e-4 rel (ROADMAP's
  cross-framework f32 gate);
* bf16 under ``auto_cast(bf16, O1)`` on both sides: the loss within
  1e-3 relative, every gradient within 5e-2 of that gradient's largest
  magnitude.  The two frameworks round bf16 at different places (the
  reference's composites round after the GEMM, the bias add and the
  activation in turn; the port's epilogue rounds once), which moves each
  element by a few bf16 ulps; the bound is ~3x the largest deviation
  seen.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import \
    GPTPretrainingCriterion as RefCriterion

import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import ClipGradByGlobalNorm

TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            use_flash_attention=False)
ATOL = RTOL = 1e-4


def _pair(seed=11, **over):
    cfg = dict(TINY, **over)
    paddle.seed(seed)
    ref = RefGPT(RefConfig(**cfg))
    port = pt.GPTForCausalLM(pt.GPTConfig(**cfg), device="cpu")
    pt.load_reference_state(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    return ref, port


def _batch(seed=0, b=2, s=24):
    ids = np.random.default_rng(seed).integers(0, 256, (b, s))
    labels = ids.copy()
    labels[0, 5] = -100                       # the criterion's ignore index
    return ids, labels


def _optimizers(ref, port, kind, **kw):
    ref_cls = {"adamw": paddle.optimizer.AdamW, "adam": paddle.optimizer.Adam,
               "sgd": paddle.optimizer.SGD}[kind]
    port_cls = {"adamw": pt.optimizer.AdamW, "adam": pt.optimizer.Adam,
                "sgd": pt.optimizer.SGD}[kind]
    ref_kw, port_kw = dict(kw), dict(kw)
    fun = kw.pop("decay_fun", None)
    if fun is not None:
        # the reference names parameters generically: map its names to
        # the structured names the port's parameters carry
        by_ref = {p.name: n for n, p in ref.named_parameters()}
        ref_kw["apply_decay_param_fun"] = lambda name: fun(by_ref[name])
        port_kw["apply_decay_param_fun"] = fun
        del ref_kw["decay_fun"], port_kw["decay_fun"]
    return (ref_cls(parameters=ref.parameters(),
                    grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0), **ref_kw),
            port_cls(parameters=port.parameters(),
                     grad_clip=ClipGradByGlobalNorm(1.0), **port_kw))


def _train(ref, port, ref_opt, port_opt, steps, amp=False, batch=None):
    """Run ``steps`` steps on both; return the losses and the gradients of
    the first step by structured name."""
    ids, labels = _batch() if batch is None else batch
    ref_crit, port_crit = RefCriterion(), pt.GPTPretrainingCriterion()
    losses, grads = [], None
    for step in range(steps):
        if amp:
            with paddle.amp.auto_cast(dtype="bfloat16", level="O1"):
                rl = ref_crit(ref(paddle.to_tensor(ids)),
                              paddle.to_tensor(labels))
            with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
                pl = port_crit(port(torch.from_numpy(ids)),
                               torch.from_numpy(labels))
        else:
            rl = ref_crit(ref(paddle.to_tensor(ids)),
                          paddle.to_tensor(labels))
            pl = port_crit(port(torch.from_numpy(ids)),
                           torch.from_numpy(labels))
        rl.backward()
        pl.backward()
        losses.append((float(rl.numpy()), float(pl.detach())))
        if step == 0:
            grads = {n: (np.asarray(p.grad.numpy(), np.float32),
                         dict(port.named_parameters())[n].grad.numpy().copy())
                     for n, p in ref.named_parameters()}
        ref_opt.step()
        port_opt.step()
        ref_opt.clear_grad()
        port_opt.clear_grad()
    return losses, grads


def _assert_params_close(ref, port):
    got = dict(port.named_parameters())
    for name, p in ref.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(), p.numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def _check_adamw_f32(**over):
    """3 AdamW steps on both: each loss, every step-1 gradient and every
    parameter after the steps within the f32 gate."""
    ref, port = _pair(**over)
    ref_opt, port_opt = _optimizers(ref, port, "adamw", learning_rate=1e-4,
                                    weight_decay=0.01)
    losses, grads = _train(ref, port, ref_opt, port_opt, steps=3)
    for want, got in losses:
        assert abs(got - want) <= ATOL + RTOL * abs(want)
    assert losses[-1][1] < losses[0][1]
    assert len(grads) == len(list(port.parameters()))
    for name, (want, got) in grads.items():
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    _assert_params_close(ref, port)


def test_adamw_f32_loss_grads_and_params_match_reference():
    _check_adamw_f32()


@pytest.mark.parametrize("over", [
    dict(use_flash_attention=True),
    dict(use_flash_attention=True, use_recompute=True)],
    ids=["flash", "flash_recompute"])
def test_flash_training_matches_reference(over):
    """The same 3 AdamW steps with flash attention, and with flash
    attention and recompute, on both sides."""
    _check_adamw_f32(**over)


@pytest.mark.parametrize("kind,kw", [
    ("adam", dict(learning_rate=1e-4, weight_decay=0.01)),
    ("adamw", dict(learning_rate=1e-4, weight_decay=0.1,
                   decay_fun=lambda n: not n.endswith("bias")
                   and "ln_" not in n)),
    ("sgd", dict(learning_rate=1e-2, weight_decay=0.01)),
], ids=["adam_coupled_decay", "adamw_decay_mask", "sgd"])
def test_optimizer_variants_match_reference(kind, kw):
    ref, port = _pair(seed=12)
    ref_opt, port_opt = _optimizers(ref, port, kind, **kw)
    _train(ref, port, ref_opt, port_opt, steps=3)
    _assert_params_close(ref, port)


def test_bf16_o1_loss_and_grads_match_reference():
    ref, port = _pair()
    ref_opt, port_opt = _optimizers(ref, port, "adamw", learning_rate=1e-4)
    losses, grads = _train(ref, port, ref_opt, port_opt, steps=1, amp=True)
    (want, got), = losses
    assert abs(got - want) <= 1e-3 * abs(want)
    for name, (want, got) in grads.items():
        assert got.dtype == np.float32, name      # f32 master weights
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=5e-2 * scale, rtol=0,
                                   err_msg=name)


def test_amp_o1_casts_by_the_reference_lists():
    x = torch.randn(3, 4)
    w = torch.randn(4, 5)
    with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
        assert pt.nn.functional.linear(x, w).dtype == torch.bfloat16
        h = pt.nn.functional.layer_norm(x.bfloat16(), 4, torch.ones(4),
                                        torch.zeros(4))
        assert h.dtype == torch.float32
        assert pt.nn.functional.embedding(
            torch.tensor([1]), w).dtype == torch.float32
        with pt.amp.auto_cast(dtype="bfloat16",
                              custom_black_list=["linear"]):
            assert pt.nn.functional.linear(x, w).dtype == torch.float32
    assert pt.nn.functional.linear(x, w).dtype == torch.float32
    with pytest.raises(NotImplementedError):
        with pt.amp.auto_cast(level="O2"):
            pass
    with pytest.raises(NotImplementedError):
        pt.amp.decorate(None, level="O2")


def test_dropout_draws_from_the_models_generator():
    cfg = pt.GPTConfig(**dict(TINY, hidden_dropout_prob=0.5))
    ids = torch.from_numpy(_batch()[0])
    runs = []
    for _ in range(2):
        model = pt.GPTForCausalLM(cfg, device="cpu", seed=4)
        torch.manual_seed(0)                  # the global RNG plays no part
        torch.rand(7)
        runs.append((model(ids), model(ids)))
    (a1, a2), (b1, b2) = runs
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert not torch.equal(a1, a2), "each call draws new masks"
    x = torch.ones(1000)
    y = pt.nn.functional.dropout(x, 0.25, generator=torch.Generator()
                                 .manual_seed(1))
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert 650 < int(kept.sum()) < 850
    model = pt.GPTForCausalLM(cfg, device="cpu", seed=4).eval()
    assert torch.equal(model(ids), model(ids)), "eval mode drops nothing"


def test_clip_by_global_norm_is_paddles_rule():
    a = torch.nn.Parameter(torch.zeros(3))
    b = torch.nn.Parameter(torch.zeros(4))
    a.grad = torch.tensor([3.0, 0.0, 0.0])
    b.grad = torch.tensor([0.0, 4.0, 0.0, 0.0])      # global norm 5
    ClipGradByGlobalNorm(1.0)([a, b])
    torch.testing.assert_close(a.grad, torch.tensor([0.6, 0.0, 0.0]))
    torch.testing.assert_close(b.grad, torch.tensor([0.0, 0.8, 0.0, 0.0]))
    ClipGradByGlobalNorm(10.0)([a, b])                # within bounds: x1
    torch.testing.assert_close(a.grad, torch.tensor([0.6, 0.0, 0.0]))


def test_training_options_not_ported_raise():
    _, port = _pair()
    with pytest.raises(NotImplementedError):
        pt.optimizer.AdamW(learning_rate=lambda: 1e-3,
                           parameters=port.parameters())
    with pytest.raises(NotImplementedError):
        pt.optimizer.SGD(parameters=[{"params": list(port.parameters())}])
    with pytest.raises(NotImplementedError):
        pt.nn.functional.cross_entropy(torch.zeros(2, 3),
                                       torch.zeros(2, 3), soft_label=True)
    with pytest.raises(NotImplementedError):
        pt.GPTForCausalLM(pt.GPTConfig(**dict(TINY, use_scan_layers=True)),
                          device="cpu")
    pt.GPTForCausalLM(pt.GPTConfig(**dict(TINY, use_recompute=True)),
                      device="cpu")
    assert port.training, "a model starts in training mode"


def _grads_after_step(cfg, amp=False, seed=4):
    """One forward inside ``auto_cast`` (if ``amp``) and a backward outside
    it, as a training loop runs them; returns the loss, the gradients and
    the output of a second forward (which draws the next dropout masks)."""
    model = pt.GPTForCausalLM(pt.GPTConfig(**cfg), device="cpu", seed=seed)
    ids, labels = (torch.from_numpy(a) for a in _batch())
    crit = pt.GPTPretrainingCriterion()
    if amp:
        with pt.amp.auto_cast(dtype="bfloat16", level="O1"):
            loss = crit(model(ids), labels)
    else:
        loss = crit(model(ids), labels)
    loss.backward()
    with torch.no_grad():
        after = model(ids)
    return (float(loss.detach()),
            {n: p.grad.clone() for n, p in model.named_parameters()}, after)


@pytest.mark.parametrize("what", ["bf16_o1", "dropout"])
def test_recompute_replays_the_forward_exactly(what):
    """Recompute replays each block's forward inside ``backward()``: under
    bf16 O1 (the ``auto_cast`` block has closed by then, so the replay must
    re-enter the forward's AMP state) and with dropout (the masks come from
    the model's own generator, which the replay must rewind and then put
    back).  Either way the gradients equal those without recompute, and
    the draws after the step do too."""
    cfg = dict(TINY, use_flash_attention=True)
    if what == "dropout":
        cfg["hidden_dropout_prob"] = 0.2
    amp = what == "bf16_o1"
    loss, grads, after = _grads_after_step(cfg, amp)
    loss_r, grads_r, after_r = _grads_after_step(
        dict(cfg, use_recompute=True), amp)
    assert loss_r == loss
    for name, g in grads.items():
        assert torch.equal(grads_r[name], g), name
    assert torch.equal(after_r, after)


def test_flash_recompute_step_at_the_entry_shape_matches_reference():
    """One AdamW step at ``__graft_entry__.entry()``'s shape (vocab 4096,
    hidden 512, 4 layers, 8 heads, B=2, S=256), f32, flash attention and
    recompute on both sides: the loss, every gradient and every parameter
    after the step within the f32 gate."""
    entry = dict(vocab_size=4096, hidden_size=512, num_hidden_layers=4,
                 num_attention_heads=8, max_position_embeddings=512,
                 use_flash_attention=True, use_recompute=True)
    paddle.seed(13)
    ref = RefGPT(RefConfig(**entry))
    port = pt.GPTForCausalLM(pt.GPTConfig(**entry), device="cpu")
    pt.load_reference_state(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    ids = np.random.default_rng(1).integers(0, 4096, (2, 256))
    ref_opt, port_opt = _optimizers(ref, port, "adamw", learning_rate=1e-4,
                                    weight_decay=0.01)
    losses, grads = _train(ref, port, ref_opt, port_opt, steps=1,
                           batch=(ids, ids))
    (want, got), = losses
    assert abs(got - want) <= ATOL + RTOL * abs(want)
    for name, (want, got) in grads.items():
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    _assert_params_close(ref, port)
