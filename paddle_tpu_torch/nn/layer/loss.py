"""Loss layers: port of ``paddle_tpu/nn/layer/loss.py`` (every class of
its ``__all__``), each calling its functional in ``nn.functional.loss``
with the arguments it keeps.  As in the reference, a class weight is an
attribute, not a parameter or buffer, so only ``HSigmoidLoss`` has state
(``weight`` [rows, feature_size], Xavier-normal, and ``bias`` [rows, 1],
zeros; rows = num_classes - 1, or num_classes with ``is_custom``), and
``_simple_loss``'s layers keep only the keywords the reference keeps
(``delta``, ``log_target``)."""
from __future__ import annotations

import torch
from torch import nn

from ...core import resolve_device
from .. import functional as F
from .. import initializer as I

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss",
           "MarginRankingLoss", "CTCLoss", "HingeEmbeddingLoss",
           "CosineEmbeddingLoss", "TripletMarginLoss", "PoissonNLLLoss",
           "MultiLabelSoftMarginLoss", "SoftMarginLoss",
           "HuberLoss", "GaussianNLLLoss",
           "MultiMarginLoss", "TripletMarginWithDistanceLoss",
           "HSigmoidLoss"]


class CrossEntropyLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(
            input, label, weight=self.weight,
            ignore_index=self.ignore_index, reduction=self.reduction,
            soft_label=self.soft_label, axis=self.axis,
            use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)


def _simple_loss(name, fn, *extra):
    """A layer calling ``fn(input, label, reduction=, **kw)``, ``kw`` the
    keywords named in ``extra`` (others are dropped, as in the
    reference)."""
    class _Loss(nn.Module):
        def __init__(self, reduction="mean", **kwargs):
            super().__init__()
            self.reduction = reduction
            self.kwargs = {k: v for k, v in kwargs.items() if k in extra}

        def forward(self, input, label):
            return fn(input, label, reduction=self.reduction, **self.kwargs)

    _Loss.__name__ = _Loss.__qualname__ = name
    return _Loss


MSELoss = _simple_loss("MSELoss", F.mse_loss)
L1Loss = _simple_loss("L1Loss", F.l1_loss)
SmoothL1Loss = _simple_loss("SmoothL1Loss", F.smooth_l1_loss, "delta")
KLDivLoss = _simple_loss("KLDivLoss", F.kl_div, "log_target")
SoftMarginLoss = _simple_loss("SoftMarginLoss", F.soft_margin_loss)


class NLLLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(nn.Module):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(nn.Module):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class MarginRankingLoss(nn.Module):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class CTCLoss(nn.Module):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class HingeEmbeddingLoss(nn.Module):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(nn.Module):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(nn.Module):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (margin, p, epsilon, swap)
        self.reduction = reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative,
                                     *self.args, reduction=self.reduction)


class PoissonNLLLoss(nn.Module):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (log_input, full, epsilon)
        self.reduction = reduction

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, *self.args,
                                  reduction=self.reduction)


class MultiLabelSoftMarginLoss(nn.Module):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class HuberLoss(nn.Module):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        return F.huber_loss(input, label, self.delta, self.reduction)


class GaussianNLLLoss(nn.Module):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__()
        self.full, self.epsilon = full, epsilon
        self.reduction = reduction

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, self.full,
                                   self.epsilon, self.reduction)


class MultiMarginLoss(nn.Module):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self.p, self.margin = p, margin
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, self.p, self.margin,
                                   self.weight, self.reduction)


class TripletMarginWithDistanceLoss(nn.Module):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.distance_function = distance_function
        self.margin, self.swap = margin, swap
        self.reduction = reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(
            input, positive, negative, self.distance_function,
            self.margin, self.swap, self.reduction)


class HSigmoidLoss(nn.Module):
    """`F.hsigmoid_loss` over the layer's internal-node ``weight`` and
    ``bias`` (none with ``bias_attr=False``); a custom tree comes with
    each call's ``path_table`` / ``path_code``."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        if weight_attr is not None or bias_attr not in (None, False):
            raise NotImplementedError("HSigmoidLoss: weight_attr and "
                                      "bias_attr other than bias_attr=False "
                                      "are not ported yet")
        device = resolve_device(device)
        self.num_classes = num_classes
        self.is_custom = is_custom
        rows = num_classes if is_custom else num_classes - 1
        self.weight = nn.Parameter(torch.empty(rows, feature_size,
                                               device=device, dtype=dtype))
        I.XavierNormal()(self.weight, generator)
        self.bias = None
        if bias_attr is not False:
            self.bias = nn.Parameter(torch.zeros(rows, 1, device=device,
                                                 dtype=dtype))

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table, path_code)
