"""paddle.vision.ops: the detection operators.

Port of ``paddle_tpu/vision/ops.py:35-448``: ``box_iou``, ``nms``,
``roi_align``, ``roi_pool``, ``box_coder``, ``yolo_box``,
``deform_conv2d`` and the layers ``RoIAlign``, ``RoIPool`` and
``DeformConv2D``.  The reference composes them from ``jnp`` gathers and
arithmetic, which XLA compiles; the port composes them from torch's, and
copies the reference's arithmetic rather than torchvision's semantics:

* Bilinear sampling (:99-118) takes the four corners ``floor(y)``,
  ``floor(y) + 1`` (and the same in x), each index clipped into the map,
  weighted by the distances, and zeroes a sample only outside ``(-1, H)
  x (-1, W)``.  The port gathers each sample's channel vector from the
  features laid out ``[N, H, W, C]``.
* ``roi_align`` (:121-167) averages ``ratio x ratio`` samples a bin
  (``ratio`` 2 when ``sampling_ratio <= 0``), shifting the boxes by half
  a pixel when ``aligned``, and takes each box's image from
  ``boxes_num``.  ``roi_pool`` (:170-209) rounds the scaled boxes and
  takes the largest of 4 x 4 bilinear samples a bin.  Both are trained
  through: their backward is autograd's of the gathers.
* ``yolo_box`` (:276-326) zeroes the boxes and scores of cells under
  ``conf_thresh`` instead of dropping them; ``iou_aware`` raises.
* ``deform_conv2d`` (:329-392) reads its offsets as ``[n, kh*kw, 2, oh,
  ow]`` (y first) and its mask as ``[n, kh*kw, oh, ow]`` (v2; v1 without
  one), samples the input at each tap's offset position and multiplies
  the columns by the weight with ``torch.matmul``; ``groups`` or
  ``deformable_groups`` over 1 raise, as there.
* ``nms`` (:49-96) runs on the host in the reference (its output's size
  depends on the data).  The port computes the IoU of every pair of
  boxes in f64 on the boxes' device (an N x N matrix, the reference's
  arithmetic pair for pair), copies it to the host once and sweeps it
  greedily there, in the order of numpy's ``argsort(-scores)`` as the
  reference does, per category when ``category_idxs`` is given; the kept
  indices, at most ``top_k``, return to the boxes' device.

Each op casts its floating inputs by the AMP rule under its reference
name (none is on an O1 list).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import amp
from ..core import resolve_device, to_torch_dtype
from ..nn import initializer as I

__all__ = ["nms", "roi_align", "roi_pool", "box_coder", "yolo_box",
           "deform_conv2d", "RoIAlign", "RoIPool", "DeformConv2D",
           "box_iou"]


def _pairwise_iou(a, b):
    """The reference's IoU of every box of ``a`` [N, 4] with every box of
    ``b`` [M, 4] (xyxy): [N, M]."""
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp_min(area1[:, None] + area2[None] - inter,
                                   1e-10)


def box_iou(boxes1, boxes2):
    """Pairwise IoU [N, M] of xyxy boxes; differentiable."""
    boxes1, boxes2 = amp.cast_inputs("box_iou", boxes1, boxes2)
    return _pairwise_iou(boxes1, boxes2)


def nms_iou(boxes):
    """The IoU matrix of ``nms``: every pair of ``boxes`` in f64 on their
    device."""
    b = boxes.detach().double()
    return _pairwise_iou(b, b)


def nms_sweep(iou, iou_threshold, scores=None, category_idxs=None,
              categories=None, top_k=None):
    """The reference's greedy sweep on the host, over the IoU matrix
    ``iou`` and ``scores`` / ``category_idxs`` as numpy arrays: the kept
    indices as a list."""
    def greedy(idxs):
        sub = iou[np.ix_(idxs, idxs)]
        order = np.argsort(-scores[idxs]) if scores is not None \
            else np.arange(len(idxs))
        alive = np.ones(len(idxs), bool)
        keep = []
        for oi, i in enumerate(order):
            if not alive[i]:
                continue
            keep.append(int(idxs[i]))
            rest = order[oi + 1:]
            alive[rest[sub[i, rest] > iou_threshold]] = False
        return keep

    n = iou.shape[0]
    if category_idxs is None:
        keep = greedy(np.arange(n))
    else:
        keep = []
        for c in (categories if categories is not None
                  else np.unique(category_idxs)):
            idxs = np.nonzero(category_idxs == c)[0]
            if len(idxs):
                keep.extend(greedy(idxs))
        if scores is not None:
            keep = sorted(keep, key=lambda i: -scores[i])
    if top_k is not None:
        keep = keep[:int(top_k)]
    return keep


def _host(t, f64=False):
    """``t`` (a tensor or an array) as a numpy array, in f64 if asked."""
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64) if f64 else np.asarray(t)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy non-maximum suppression: the kept indices (int64, on the
    boxes' device), highest score first."""
    if boxes.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=boxes.device)
    iou = nms_iou(boxes).cpu().numpy()
    keep = nms_sweep(iou, iou_threshold, _host(scores, True),
                     _host(category_idxs), categories, top_k)
    return torch.tensor(keep, dtype=torch.int64, device=boxes.device)


def _rois_images(boxes_num, n, rois):
    return torch.repeat_interleave(
        torch.arange(n, device=rois.device),
        boxes_num.to(rois.device, torch.int64), output_size=rois.shape[0])


def _bilinear(feats, img, ys, xs):
    """``feats`` [N, H, W, C] sampled at ``ys`` [R, P, 1] x ``xs`` [R, 1,
    Q] in image ``img`` [R] of each row: [R, P, Q, C], zero outside (-1,
    H) x (-1, W)."""
    H, W = feats.shape[1:3]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    y1, x1 = y0 + 1, x0 + 1
    wy1, wx1 = ys - y0, xs - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    img = img.reshape((-1,) + (1,) * (ys.dim() - 1))

    def at(yy, xx):
        yi = torch.clamp(yy, 0, H - 1).long()
        xi = torch.clamp(xx, 0, W - 1).long()
        return feats[img, yi, xi]

    valid = ((ys > -1) & (ys < H) & (xs > -1) & (xs < W)).to(feats.dtype)
    val = (at(y0, x0) * (wy0 * wx0)[..., None]
           + at(y0, x1) * (wy0 * wx1)[..., None]
           + at(y1, x0) * (wy1 * wx0)[..., None]
           + at(y1, x1) * (wy1 * wx1)[..., None])
    return val * valid[..., None]


def _bin_samples(x, boxes, boxes_num, ph, pw, ratio, x1, y1, bin_h, bin_w):
    """Every box's ``ratio x ratio`` samples a bin: [R, ph, ratio, pw,
    ratio, C]."""
    iy = (torch.arange(ratio, device=x.device, dtype=x1.dtype) + 0.5) / ratio
    gy = (torch.arange(ph, device=x.device, dtype=x1.dtype)[:, None]
          + iy).reshape(-1)
    gx = (torch.arange(pw, device=x.device, dtype=x1.dtype)[:, None]
          + iy).reshape(-1)
    ys = y1[:, None] + gy * bin_h[:, None]
    xs = x1[:, None] + gx * bin_w[:, None]
    img = _rois_images(boxes_num, x.shape[0], boxes)
    vals = _bilinear(x.permute(0, 2, 3, 1), img, ys[:, :, None],
                     xs[:, None, :])
    return vals.reshape(boxes.shape[0], ph, ratio, pw, ratio, -1)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign over NCHW features: boxes [R, 4] xyxy in image
    coordinates, ``boxes_num`` [N] boxes an image in order; [R, C, ph,
    pw]."""
    x, boxes = amp.cast_inputs("roi_align", x, boxes)
    ph, pw = _pair(output_size)
    ratio = 2 if sampling_ratio <= 0 else int(sampling_ratio)
    off = 0.5 if aligned else 0.0
    x1, y1, x2, y2 = (boxes[:, i] * spatial_scale - off for i in range(4))
    rw, rh = x2 - x1, y2 - y1
    if not aligned:
        rw, rh = torch.clamp_min(rw, 1.0), torch.clamp_min(rh, 1.0)
    vals = _bin_samples(x, boxes, boxes_num, ph, pw, ratio, x1, y1, rh / ph,
                        rw / pw)
    return vals.mean((2, 4)).permute(0, 3, 1, 2)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """RoIPool: the largest of 4 x 4 bilinear samples in each bin of the
    rounded box; [R, C, ph, pw]."""
    x, boxes = amp.cast_inputs("roi_pool", x, boxes)
    ph, pw = _pair(output_size)
    x1, y1, x2, y2 = (torch.round(boxes[:, i] * spatial_scale)
                      for i in range(4))
    rw = torch.clamp_min(x2 - x1 + 1, 1.0)
    rh = torch.clamp_min(y2 - y1 + 1, 1.0)
    vals = _bin_samples(x, boxes, boxes_num, ph, pw, 4, x1, y1, rh / ph,
                        rw / pw)
    return vals.amax((2, 4)).permute(0, 3, 1, 2)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """Encode targets [T, 4] against priors [P, 4] into [T, P, 4], or
    decode deltas [N, M, 4] whose dim ``axis`` runs over the priors."""
    if prior_box_var is None:
        var = torch.ones(4, dtype=torch.float32, device=prior_box.device)
    elif isinstance(prior_box_var, torch.Tensor):
        var = prior_box_var
    else:
        var = torch.tensor(np.asarray(prior_box_var, np.float32),
                           device=prior_box.device)
    prior, tbox, var = amp.cast_inputs("box_coder", prior_box, target_box,
                                       var)
    norm = 0.0 if box_normalized else 1.0
    pw = prior[:, 2] - prior[:, 0] + norm
    phh = prior[:, 3] - prior[:, 1] + norm
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + phh * 0.5
    if var.dim() == 1:
        var = var.expand(prior.shape)
    if code_type == "encode_center_size":
        tw = tbox[:, 2] - tbox[:, 0] + norm
        th = tbox[:, 3] - tbox[:, 1] + norm
        tcx = tbox[:, 0] + tw * 0.5
        tcy = tbox[:, 1] + th * 0.5
        return torch.stack([
            (tcx[:, None] - pcx[None]) / pw[None] / var[None, :, 0],
            (tcy[:, None] - pcy[None]) / phh[None] / var[None, :, 1],
            torch.log(tw[:, None] / pw[None]) / var[None, :, 2],
            torch.log(th[:, None] / phh[None]) / var[None, :, 3],
        ], -1)
    d = tbox
    if d.shape[axis] != prior.shape[0]:
        raise ValueError(
            f"box_coder decode: target_box dim {axis} ({d.shape[axis]}) "
            f"must equal the prior count ({prior.shape[0]}); use axis=1 "
            f"when priors vary along the second dim")
    if axis == 1:
        pcx, pcy, pw_, ph_, v = pcx[None], pcy[None], pw[None], phh[None], \
            var[None]
    else:
        pcx, pcy = pcx[:, None], pcy[:, None]
        pw_, ph_, v = pw[:, None], phh[:, None], var[:, None]
    cx = v[..., 0] * d[..., 0] * pw_ + pcx
    cy = v[..., 1] * d[..., 1] * ph_ + pcy
    w = torch.exp(v[..., 2] * d[..., 2]) * pw_
    h = torch.exp(v[..., 3] * d[..., 3]) * ph_
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2 - norm,
                        cy + h / 2 - norm], -1)


def yolo_box(x, img_size, anchors, class_num, conf_thresh, downsample_ratio,
             clip_bbox=True, name=None, scale_x_y=1.0, iou_aware=False,
             iou_aware_factor=0.5):
    """Decode a YOLOv3 head [N, AN * (5 + C), H, W] into boxes [N, AN * H *
    W, 4] and scores [N, AN * H * W, C], both zero where the objectness is
    under ``conf_thresh``."""
    if iou_aware:
        raise NotImplementedError(
            "yolo_box: the iou_aware head layout ([N, AN*(6+C), H, W]) is "
            "not supported, as in the reference")
    (x,) = amp.cast_inputs("yolo_box", x)
    an = len(anchors) // 2
    n, _, h, w = x.shape
    a = x.reshape(n, an, 5 + class_num, h, w)
    gx = torch.arange(w, dtype=torch.float32, device=x.device)
    gy = torch.arange(h, dtype=torch.float32, device=x.device)
    anc = torch.tensor(anchors, dtype=torch.float32,
                       device=x.device).reshape(an, 2)
    bias = 0.5 * (scale_x_y - 1)
    cx = (torch.sigmoid(a[:, :, 0]) * scale_x_y - bias + gx) / w
    cy = (torch.sigmoid(a[:, :, 1]) * scale_x_y - bias + gy[:, None]) / h
    bw = torch.exp(a[:, :, 2]) * anc[None, :, 0, None, None] \
        / (w * downsample_ratio)
    bh = torch.exp(a[:, :, 3]) * anc[None, :, 1, None, None] \
        / (h * downsample_ratio)
    conf = torch.sigmoid(a[:, :, 4])
    probs = torch.sigmoid(a[:, :, 5:]) * conf[:, :, None]
    size = img_size.to(x.device, torch.float32)
    ih, iw = size[:, 0, None, None, None], size[:, 1, None, None, None]
    x1, y1 = (cx - bw / 2) * iw, (cy - bh / 2) * ih
    x2, y2 = (cx + bw / 2) * iw, (cy + bh / 2) * ih
    if clip_bbox:
        x1, y1 = torch.clamp_min(x1, 0), torch.clamp_min(y1, 0)
        x2, y2 = torch.minimum(x2, iw - 1), torch.minimum(y2, ih - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1).reshape(n, -1, 4)
    scores = probs.movedim(2, -1).reshape(n, -1, class_num)
    keep = (conf.reshape(n, -1, 1) >= conf_thresh).to(boxes.dtype)
    return boxes * keep, scores * keep


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution, v1 (``mask`` None) or v2: each tap sampled
    at its offset position, then one product with the weight."""
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    if deformable_groups != 1 or groups != 1:
        raise NotImplementedError(
            "deform_conv2d: deformable_groups/groups > 1 not supported, as "
            "in the reference")
    x, offset, weight, bias, mask = amp.cast_inputs(
        "deform_conv2d", x, offset, weight, bias, mask)
    n, cin, H, W = x.shape
    cout, _, kh, kw = weight.shape
    oh = (H + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
    ow = (W + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1

    def grid(size, st, pad, k, dil):
        return (torch.arange(size, device=x.device) * st - pad)[:, None] \
            + torch.arange(k, device=x.device) * dil
    base_y = grid(oh, s[0], p[0], kh, d[0])[:, None, :, None]
    base_x = grid(ow, s[1], p[1], kw, d[1])[None, :, None, :]
    off = offset.reshape(n, kh * kw, 2, oh, ow).movedim(1, -1)
    ys = base_y + off[:, 0].reshape(n, oh, ow, kh, kw)
    xs = base_x + off[:, 1].reshape(n, oh, ow, kh, kw)
    img = torch.arange(n, device=x.device)
    # [n, oh * ow * kh * kw, 1] x [.., 1]: one sample a tap and pixel
    vals = _bilinear(x.permute(0, 2, 3, 1), img, ys.reshape(n, -1, 1),
                     xs.reshape(n, -1, 1))
    vals = vals.reshape(n, oh, ow, kh * kw, cin)
    if mask is not None:
        vals = vals * mask.reshape(n, kh * kw, oh, ow).permute(
            0, 2, 3, 1)[..., None]
    cols = vals.reshape(n, oh, ow, kh * kw * cin)
    out = torch.matmul(cols, weight.permute(0, 2, 3, 1).reshape(
        cout, -1).T).permute(0, 3, 1, 2)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


class RoIAlign(nn.Module):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


class RoIPool(nn.Module):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


class DeformConv2D(nn.Module):
    """``weight`` [out, in / groups, kh, kw] (Xavier-normal) and ``bias``
    [out] (zeros; ``bias_attr=False`` drops it), under the reference's
    names."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, *, device,
                 dtype=torch.float32, generator=None):
        super().__init__()
        if weight_attr is not None or bias_attr not in (None, False):
            raise NotImplementedError("weight_attr and bias_attr other than "
                                      "bias_attr=False are not ported yet")
        kh, kw = _pair(kernel_size)
        opts = dict(device=resolve_device(device),
                    dtype=to_torch_dtype(dtype))
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels // groups, kh, kw), **opts))
        I.XavierNormal()(self.weight, generator)
        self.bias = None if bias_attr is False \
            else nn.Parameter(torch.zeros(out_channels, **opts))
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.deformable_groups = deformable_groups
        self.groups = groups

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, self.stride,
                             self.padding, self.dilation,
                             self.deformable_groups, self.groups, mask)
