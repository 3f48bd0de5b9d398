"""Weight-only int8 for serving: per-channel quantization, ``convert_to_int8``
and the accuracy gates.

Port of ``paddle_tpu/quantization/__init__.py:96-180`` (``Q_INT8_MAX``,
``quantize_weight_int8``, ``convert_to_int8``, ``logits_cosine``,
``greedy_match_ratio``).  A converted ``nn.Linear`` holds its weight as
two persistent buffers, ``weight_q`` (int8 ``[in, out]``) and
``weight_scale`` (f32 ``[out]``), under the reference's state-dict names
and dtypes, and runs through the int8 matmul-epilogue kernel
(``F.linear_act_int8``).

The reference reports degenerate channels through its
``analysis.diagnostics``, which is not ported; `QuantReport` keeps the
same finding (code ``TPU404``, the number of bad channels, the site).
QAT, PTQ and the fake-quant ops are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

__all__ = ["Q_INT8_MAX", "QuantFinding", "QuantReport",
           "quantize_weight_int8", "convert_to_int8", "logits_cosine",
           "greedy_match_ratio"]

Q_INT8_MAX = 127.0


@dataclass
class QuantFinding:
    """One degenerate-channel finding: the reference's TPU404."""
    code: str
    message: str
    site: str
    bad_channels: int
    channels: list = field(default_factory=list)   # the first 16


class QuantReport:
    """The findings of one `convert_to_int8` (or `quantize_weight_int8`)
    call, in order."""

    def __init__(self, label=""):
        self.label = label
        self.findings = []

    def add(self, finding):
        self.findings.append(finding)

    def __iter__(self):
        return iter(self.findings)

    def __len__(self):
        return len(self.findings)

    def by_code(self, code):
        return [f for f in self.findings if f.code == code]


def quantize_weight_int8(w, axis=-1, report=None):
    """Symmetric per-channel int8 quantization of ``w``, computed in f32.

    Returns ``(w_q, scale)``: int8 codes of ``w``'s shape and the f32
    scale of each channel along ``axis``, so that ``w ≈ w_q * scale``.
    A channel whose abs-max is zero or not finite gets scale 1.0 (it
    dequantizes to zeros) and a ``TPU404`` finding on ``report``.  Codes
    round half to even, as the reference's do."""
    v = w.detach().float()
    ax = axis % v.dim()
    red = tuple(i for i in range(v.dim()) if i != ax)
    amax = v.abs().amax(dim=red) if red else v.abs()
    bad = ~torch.isfinite(amax) | (amax <= 0.0)
    n_bad = int(bad.sum())
    if n_bad and report is not None:
        report.add(QuantFinding(
            "TPU404",
            f"{n_bad} of {amax.numel()} channels along axis {ax} have zero "
            "or nonfinite abs-max; their scale is clamped to 1.0 and the "
            "channel dequantizes to zeros",
            site=f"quantize_weight_int8[shape={tuple(v.shape)}]",
            bad_channels=n_bad,
            channels=torch.nonzero(bad).flatten()[:16].tolist()))
    scale = torch.where(bad, torch.ones_like(amax), amax / Q_INT8_MAX)
    bshape = [1] * v.dim()
    bshape[ax] = -1
    q = torch.clamp(torch.round(v / scale.reshape(bshape)), -Q_INT8_MAX,
                    Q_INT8_MAX).to(torch.int8)
    return q, scale


def convert_to_int8(model, report=None):
    """Convert every port ``nn.Linear`` under ``model`` that still has a
    ``weight`` parameter to int8 weight-only execution, in place: the
    weight is dropped and replaced by the persistent buffers ``weight_q``
    (int8 ``[in, out]``) and ``weight_scale`` (f32 ``[out]``, one per
    output channel).  Layers already converted are left as they are.
    Returns the `QuantReport` of degenerate channels."""
    from ..nn.layers import Linear
    if report is None:
        report = QuantReport(label="convert_to_int8")
    for layer in model.modules():
        if not isinstance(layer, Linear) or "weight" not in layer._parameters:
            continue
        w_q, scale = quantize_weight_int8(layer.weight, axis=1,
                                          report=report)
        del layer.weight
        layer.register_buffer("weight_q", w_q, persistent=True)
        layer.register_buffer("weight_scale", scale, persistent=True)
    return report


def logits_cosine(a, b):
    """Cosine similarity of two logits tensors, flattened, in f32."""
    av = a.detach().reshape(-1).float()
    bv = b.detach().reshape(-1).float().to(av.device)
    denom = torch.linalg.vector_norm(av) * torch.linalg.vector_norm(bv) \
        + 1e-12
    return float(torch.dot(av, bv) / denom)


def greedy_match_ratio(ref, hyp):
    """Position-wise token agreement of two lists of greedy sequences; a
    length mismatch counts as mismatched positions."""
    match = total = 0
    for a, b in zip(ref, hyp):
        total += max(len(a), len(b))
        match += sum(1 for x, y in zip(a, b) if x == y)
    return match / max(total, 1)
