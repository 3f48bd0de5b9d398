"""Losses on ``torch.Tensor``: port of ``paddle_tpu/nn/functional/loss.py``
(every function of its ``__all__``).

``cross_entropy`` (:38) keeps the reference's routing: hard labels go
through the softmax cross-entropy kernels (rows 8a/8b: the plain version
on CPU tensors, the CUDA kernels on the card), the other forms through
its composite; ``softmax_with_cross_entropy`` (:125) calls it, so its
hard labels take the kernels too.  The rest the reference leaves to
XLA, and the port computes in plain PyTorch, formula for formula, with
the reference's argument names, defaults, reductions and normalisations:
``nll_loss``'s mean divides by the weight of the non-ignored targets
(at least 1e-12), ``kl_div`` takes ``"batchmean"``, ``ctc_loss``
normalises the log-softmax of its ``[T, B, C]`` input itself, its mean
divides each loss by its label length, and ``norm_by_times`` scales the
gradient by 1/T and leaves the value; ``dice_loss``, ``npair_loss`` and
``log_loss`` take no reduction; ``hsigmoid_loss`` returns ``[N, 1]``.
Each casts its inputs through ``amp.cast_inputs`` under the name the
reference dispatches (``bce_loss``, ``kldiv_loss``, ``smooth_l1``, ...;
``cross_entropy``, ``multi_margin_loss`` and ``hsigmoid_loss`` are on
O1's black list).
"""
from __future__ import annotations

import math

import torch

from ... import amp
from ... import ops
from .activation import softmax as _softmax

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "mse_loss", "l1_loss",
    "nll_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "smooth_l1_loss", "kl_div", "margin_ranking_loss", "hinge_embedding_loss",
    "cosine_embedding_loss", "triplet_margin_loss", "log_loss",
    "square_error_cost", "sigmoid_focal_loss", "dice_loss", "npair_loss",
    "poisson_nll_loss", "multi_label_soft_margin_loss", "soft_margin_loss",
    "ctc_loss", "multi_margin_loss", "triplet_margin_with_distance_loss",
    "hsigmoid_loss", "huber_loss", "gaussian_nll_loss",
]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _cross_entropy_composite(logits, label, weight, ignore_index, reduction,
                             soft_label, axis, use_softmax, smooth):
    """The reference's composite (loss.py:74-120): log-softmax in f32 for
    bf16/f16 logits (or the log of probabilities, ``use_softmax=False``),
    soft labels (smoothed towards uniform) or hard labels (the smoothed
    loss mixing in the mean negative log-probability, class weights, the
    ignore index zeroing a row), and the reduction: ``"mean"`` divides by
    the number (or the weight sum) of valid labels, at least 1."""
    if use_softmax:
        x = logits.float() if logits.dtype in (torch.bfloat16,
                                               torch.float16) else logits
        logp = torch.log_softmax(x, dim=axis)
    else:
        logp = torch.log(torch.clamp_min(logits, 1e-30))
    n_classes = logits.shape[axis]
    valid = None
    if soft_label:
        lab = label
        if smooth > 0:
            lab = lab * (1 - smooth) + smooth / n_classes
        loss = -(lab * logp).sum(dim=axis)
    else:
        lab = label
        if lab.dim() == logits.dim() and lab.shape[axis] == 1:
            lab = lab.squeeze(axis)
        valid = lab != ignore_index
        safe = torch.where(valid, lab, 0)
        loss = -torch.take_along_dim(logp, safe.unsqueeze(axis),
                                     dim=axis).squeeze(axis)
        if smooth > 0:
            loss = (1 - smooth) * loss + smooth * -logp.mean(dim=axis)
        if weight is not None:
            loss = loss * weight[safe]
        loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        if valid is None:
            return loss.mean()
        if weight is not None:
            denom = torch.where(valid, weight[safe], 0.0).sum()
        else:
            denom = valid.sum().to(loss.dtype)
        return loss.sum() / denom.clamp_min(1.0)
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross-entropy, routed as the reference routes it
    (loss.py:38-121): hard labels over the last dim of f32, bf16 or f16
    logits (at most 128K classes) without class weights or smoothing go
    through the softmax cross-entropy kernels (rows 8a/8b), as the
    reference's fused path does: labels equal to ``ignore_index`` are
    relabelled to -1 (zero loss and gradient), and ``"mean"`` divides the
    sum by the number of valid labels (at least 1).  Soft labels, class
    weights, label smoothing, ``use_softmax=False`` and other axes take
    the reference's composite."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    input, label, weight = amp.cast_inputs("cross_entropy", input, label,
                                           weight)
    axis = int(axis)
    fused = (not soft_label and weight is None and label_smoothing == 0.0
             and use_softmax and axis in (-1, input.dim() - 1)
             and input.shape[-1] <= 128 * 1024
             and input.dtype in (torch.float32, torch.bfloat16,
                                 torch.float16))
    if not fused:
        return _cross_entropy_composite(
            input, label, weight, int(ignore_index), reduction,
            bool(soft_label), axis, bool(use_softmax),
            float(label_smoothing))
    lab = label
    if lab.dim() == input.dim() and lab.shape[-1] == 1:
        lab = lab.squeeze(-1)
    valid = lab != ignore_index
    loss = ops.fused_softmax_cross_entropy(
        input, torch.where(valid, lab, -1).to(torch.int64))
    if reduction == "mean":
        return loss.sum() / valid.sum().to(loss.dtype).clamp_min(1.0)
    if reduction == "sum":
        return loss.sum()
    return loss


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """`cross_entropy` unreduced, with the class axis kept as size 1 (as
    Paddle returns it); with ``return_softmax`` also ``softmax(logits)``
    over ``axis``.  ``numeric_stable_mode`` is accepted and not read, as
    in the reference."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = loss.unsqueeze(axis if axis >= 0 else loss.dim() + 1 + axis)
    if return_softmax:
        return loss, _softmax(logits, axis=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    input, label = amp.cast_inputs("mse_loss", input, label)
    return _reduce(torch.square(input - label), reduction)


def square_error_cost(input, label):
    """``(input - label)^2``, unreduced."""
    input, label = amp.cast_inputs("square_error_cost", input, label)
    return torch.square(input - label)


def l1_loss(input, label, reduction="mean", name=None):
    input, label = amp.cast_inputs("l1_loss", input, label)
    return _reduce((input - label).abs(), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``-input[i, label[i]]`` over ``[N, C]`` log-probabilities, times the
    class weight; ignored targets give 0.  ``"mean"`` divides the sum by
    the summed weight (or count) of the non-ignored targets, at least
    1e-12."""
    input, label, weight = amp.cast_inputs("nll_loss", input, label,
                                           weight)
    valid = label != ignore_index
    safe = torch.where(valid, label, 0)
    loss = -torch.take_along_dim(input, safe[:, None], dim=1)[:, 0]
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        denom = (weight[safe] * valid).sum() if weight is not None \
            else valid.sum().to(loss.dtype)
        return loss.sum() / denom.clamp_min(1e-12)
    if reduction == "sum":
        return loss.sum()
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """``-(y log p + (1 - y) log(1 - p))`` with ``p`` clipped to
    ``[1e-12, 1 - 1e-12]`` (in f32 the upper clip is 1)."""
    input, label, weight = amp.cast_inputs("bce_loss", input, label, weight)
    p = torch.clamp(input, 1e-12, 1.0 - 1e-12)
    loss = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """``max(z, 0) - z y + log1p(exp(-|z|))``; with ``pos_weight``,
    ``-(pos_weight y log sigmoid(z) + (1 - y) log sigmoid(-z))``; times
    ``weight``."""
    logit, label, weight, pos_weight = amp.cast_inputs(
        "bce_logits", logit, label, weight, pos_weight)
    z, y = logit, label
    loss = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    if pos_weight is not None:
        loss = -(pos_weight * y * torch.nn.functional.logsigmoid(z)
                 + (1 - y) * torch.nn.functional.logsigmoid(-z))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """``0.5 d^2 / delta`` where ``|d| < delta``, else ``|d| - delta /
    2``."""
    input, label = amp.cast_inputs("smooth_l1", input, label)
    d = input - label
    ad = d.abs()
    delta = float(delta)
    return _reduce(torch.where(ad < delta, 0.5 * d * d / delta,
                               ad - 0.5 * delta), reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    """``y (log y - input)`` (``log y`` of ``max(y, 1e-30)``), or with
    ``log_target`` ``exp(y) (y - input)``; ``"batchmean"`` divides the
    sum by the batch."""
    input, label = amp.cast_inputs("kldiv_loss", input, label)
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(torch.clamp_min(label, 1e-30)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    input, other, label = amp.cast_inputs("margin_ranking_loss", input,
                                          other, label)
    return _reduce(torch.clamp_min(-label * (input - other) + float(margin),
                                   0.0), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    """``x`` where the label is 1, else ``max(margin - x, 0)``."""
    input, label = amp.cast_inputs("hinge_embedding_loss", input, label)
    return _reduce(torch.where(label == 1, input,
                               torch.clamp_min(float(margin) - input, 0.0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    """``1 - cos`` where the label is 1, else ``max(cos - margin, 0)``,
    the cosine over the last dim with its norms' product at least
    1e-12."""
    input1, input2, label = amp.cast_inputs("cosine_embedding_loss", input1,
                                            input2, label)
    cos = (input1 * input2).sum(-1) / torch.clamp_min(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), 1e-12)
    loss = torch.where(label == 1, 1 - cos,
                       torch.clamp_min(cos - float(margin), 0.0))
    return _reduce(loss, reduction)


def _triplet_dist(u, v, p, eps):
    return torch.pow(torch.pow((u - v).abs() + eps, p).sum(-1), 1.0 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    """``max(d(a, p) - d(a, n) + margin, 0)`` with ``d(u, v) = (sum (|u -
    v| + epsilon)^p)^(1/p)`` over the last dim; ``swap`` takes the
    smaller of ``d(a, n)`` and ``d(p, n)``."""
    input, positive, negative = amp.cast_inputs(
        "triplet_margin_loss", input, positive, negative)
    p, eps = float(p), float(epsilon)
    d_ap = _triplet_dist(input, positive, p, eps)
    d_an = _triplet_dist(input, negative, p, eps)
    if swap:
        d_an = torch.minimum(d_an, _triplet_dist(positive, negative, p, eps))
    return _reduce(torch.clamp_min(d_ap - d_an + float(margin), 0.0),
                   reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    """``-y log(p + eps) - (1 - y) log(1 - p + eps)``, unreduced."""
    input, label = amp.cast_inputs("log_loss", input, label)
    eps = float(epsilon)
    return -label * torch.log(input + eps) \
        - (1 - label) * torch.log(1 - input + eps)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    """``a_t (1 - p_t)^gamma ce`` (the logits' stable binary cross-entropy
    ``ce``), divided by ``normalizer`` when given; summed by default."""
    logit, label, normalizer = amp.cast_inputs("sigmoid_focal_loss", logit,
                                               label, normalizer)
    z, y = logit, label
    p = torch.sigmoid(z)
    ce = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * torch.pow(1 - p_t, float(gamma)) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``mean(1 - (2 |p y| + eps) / (|p| + |y| + eps))`` over the batch,
    ``y`` the one-hot of ``label[..., 0]`` over the last dim and the sums
    over every other dim."""
    input, label = amp.cast_inputs("dice_loss", input, label)
    y1 = torch.nn.functional.one_hot(label[..., 0].long(),
                                     input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * y1).sum(dims)
    union = input.sum(dims) + y1.sum(dims)
    eps = float(epsilon)
    return (1 - (2 * inter + eps) / (union + eps)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """The cross-entropy of ``anchor @ positive^T`` against the
    row-normalised same-label matrix, plus ``l2_reg / 4`` times the mean
    squared norms of both."""
    anchor, positive, labels = amp.cast_inputs("npair_loss", anchor,
                                               positive, labels)
    sim = anchor @ positive.T
    y = labels.reshape(-1, 1)
    same = (y == y.T).to(sim.dtype)
    same = same / same.sum(1, keepdim=True)
    xent = -(same * torch.log_softmax(sim, dim=1)).sum(1).mean()
    reg = float(l2_reg) * 0.25 * ((anchor * anchor).sum(1).mean()
                                  + (positive * positive).sum(1).mean())
    return xent + reg


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    """``exp(x) - y x`` (``log_input``) or ``x - y log(x + eps)``; with
    ``full`` Stirling's term where ``y > 1``."""
    input, label = amp.cast_inputs("poisson_nll_loss", input, label)
    x, y, eps = input, label, float(epsilon)
    loss = torch.exp(x) - y * x if log_input else x - y * torch.log(x + eps)
    if full:
        stirling = y * torch.log(y + eps) - y \
            + 0.5 * torch.log(2 * math.pi * (y + eps))
        loss = loss + torch.where(y > 1, stirling, 0.0)
    return _reduce(loss, reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    input, label, weight = amp.cast_inputs("multi_label_soft_margin_loss",
                                           input, label, weight)
    loss = -(label * torch.nn.functional.logsigmoid(input)
             + (1 - label) * torch.nn.functional.logsigmoid(-input))
    loss = loss.mean(-1)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    """``log1p(exp(-y x))``."""
    input, label = amp.cast_inputs("soft_margin_loss", input, label)
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over ``[T, B, C]`` logits (normalised here by a log-softmax)
    and ``[B, S]`` labels: the reference's forward recursion over the
    blank-extended labels, step by step, each sequence's state frozen past
    its input length.  ``"mean"`` averages each loss divided by its label
    length (at least 1); ``norm_by_times`` leaves the value and scales
    the gradient by ``1 / input_length``."""
    (log_probs,) = amp.cast_inputs("ctc_loss", log_probs)
    lp = torch.log_softmax(log_probs, dim=-1)
    T, B, _ = lp.shape
    lab = labels.long()
    in_len, lab_len = input_lengths.long(), label_lengths.long()
    S = lab.shape[1]
    ext = torch.full((B, 2 * S + 1), int(blank), dtype=torch.long,
                     device=lp.device)
    ext[:, 1::2] = lab
    neg_inf = torch.tensor(-1e30, dtype=lp.dtype, device=lp.device)
    alpha = neg_inf.expand(B, 2 * S + 1).clone()
    alpha[:, 0] = lp[0, :, int(blank)]
    alpha[:, 1] = lp[0].gather(1, ext[:, 1:2])[:, 0]
    same2 = torch.cat([torch.ones(B, 2, dtype=torch.bool, device=lp.device),
                       ext[:, 2:] == ext[:, :-2]], dim=1)
    for t in range(1, T):
        shift1 = torch.cat([neg_inf.expand(B, 1), alpha[:, :-1]], dim=1)
        shift2 = torch.cat([neg_inf.expand(B, 2), alpha[:, :-2]], dim=1)
        a = torch.logaddexp(alpha, shift1)
        a = torch.where(same2, a, torch.logaddexp(a, shift2))
        new = a + lp[t].gather(1, ext)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    ext_len = 2 * lab_len + 1
    ll = torch.logaddexp(alpha.gather(1, (ext_len - 1)[:, None])[:, 0],
                         alpha.gather(1, (ext_len - 2)[:, None])[:, 0])
    loss = -ll
    if norm_by_times:
        t = torch.clamp_min(in_len.to(loss.dtype), 1.0)
        loss = (loss - loss / t).detach() + loss / t
    if reduction == "mean":
        return (loss / torch.clamp_min(lab_len, 1)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    """``0.5 d^2`` where ``|d| <= delta``, else ``delta (|d| - delta /
    2)``."""
    input, label = amp.cast_inputs("huber_loss", input, label)
    d = input - label
    ad = d.abs()
    delta = float(delta)
    return _reduce(torch.where(ad <= delta, 0.5 * d * d,
                               delta * (ad - 0.5 * delta)), reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    """``0.5 (log var + (y - mu)^2 / var)``, ``var`` at least
    ``epsilon``; ``full`` adds ``0.5 log(2 pi)``."""
    input, label, variance = amp.cast_inputs("gaussian_nll_loss", input,
                                             label, variance)
    var = torch.clamp_min(variance, float(epsilon))
    out = 0.5 * (torch.log(var) + torch.square(label - input) / var)
    if full:
        out = out + 0.5 * math.log(2 * math.pi)
    return _reduce(out, reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    """``sum over j != y of max(margin - x_y + x_j, 0)^p / C`` (times the
    target's class weight)."""
    input, label, weight = amp.cast_inputs("multi_margin_loss", input,
                                           label, weight)
    c = input.shape[1]
    if label.dim() == 2 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    label = label.long()
    x_y = input.gather(1, label[:, None])
    viol = torch.clamp_min(float(margin) - x_y + input, 0.0) ** int(p)
    if weight is not None:
        viol = viol * weight[label][:, None]
    mask = torch.arange(c, device=input.device)[None, :] != label[:, None]
    return _reduce(torch.where(mask, viol, 0.0).sum(1) / c, reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """`triplet_margin_loss` with ``distance_function(u, v)`` in place of
    the p-norm (the p-norm when None)."""
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    d_ap = distance_function(input, positive)
    d_an = distance_function(input, negative)
    if swap:
        d_an = torch.minimum(d_an, distance_function(positive, negative))
    viol = torch.maximum(d_ap - d_an + margin, torch.zeros_like(d_ap))
    return _reduce(viol, reduction)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree: leaf
    ``l`` is heap node ``l + num_classes``, its path visits the parents
    ``idx // 2`` with codes ``idx % 2``, internal node ``n`` uses
    ``weight[n - 1]`` (and ``bias[n - 1]``); a custom tree comes as
    ``path_table`` / ``path_code`` ([N, steps], -1 padding).  Returns
    ``-sum log sigmoid(sign * logit)`` as ``[N, 1]``, the logits in f32.
    ``is_sparse`` is accepted and runs dense, as in the reference."""
    input, label, weight, bias = amp.cast_inputs("hsigmoid_loss", input,
                                                 label, weight, bias)
    depth = max(1, int(math.ceil(math.log2(max(num_classes, 2)))) + 1)
    lab = label
    if lab.dim() == 2 and lab.shape[-1] == 1:
        lab = lab.squeeze(-1)
    lab = lab.long()
    if path_table is not None and path_code is not None:
        nodes = path_table.long()
        codes = path_code.float()
        valid = nodes >= 0
        nodes = nodes.clamp_min(0)
    else:
        idx = lab + int(num_classes)
        parents, bits = [], []
        for _ in range(depth):
            parent = idx // 2
            parents.append(parent)
            bits.append((idx % 2).float())
            idx = parent
        nodes = torch.stack(parents, 1)
        codes = torch.stack(bits, 1)
        valid = nodes >= 1
        nodes = nodes.clamp_min(1) - 1
    logits = torch.einsum("nd,nsd->ns", input.float(), weight[nodes].float())
    if bias is not None:
        logits = logits + (bias[nodes][..., 0] if bias.dim() == 2
                           else bias[nodes])
    logp = torch.nn.functional.logsigmoid((1.0 - 2.0 * codes) * logits)
    return -torch.where(valid, logp, 0.0).sum(1, keepdim=True)
