"""Dropless MoE token routing.

Port of ``paddle_tpu/distributed/auto_parallel/moe_dispatch.py``
(:56-115).  Every (token, expert) assignment gets a row of a
block-aligned grouped buffer, each expert owns whole ``block_rows``-row
runs (`ops.grouped.group_segments`), and nothing is dropped: load
imbalance costs padding, not quality.

  * `dropless_plan`     -- top-k assignments -> (row of each assignment,
    the kernel's block descriptor, per-expert counts);
  * `dropless_dispatch` -- scatter tokens into the grouped buffer;
  * `dropless_combine`  -- gather the expert outputs back and take the
    weighted sum of each token's k choices.

All three run on the tensors' device without a host synchronisation, so
the serving step can feed them tokens that are still on the device:
counts by ``scatter_add_`` into a fixed ``[E]``, no ``bincount``,
``nonzero``, ``.item()`` or boolean indexing.  The stable argsort gives
the tokens of one expert their arrival order, as the reference's does.

The expert-parallel ring (``ring_all_to_all_local``,
``measured_ep_dispatch``) is not ported yet: the port has no ``ep``
mesh axis.
"""
from __future__ import annotations

import torch

from ...ops.grouped import group_segments, num_group_blocks

__all__ = ["dropless_combine", "dropless_dispatch", "dropless_plan",
           "expert_imbalance", "measured_ep_dispatch",
           "ring_all_to_all_local"]


def dropless_plan(topk_idx, num_experts, block_rows, num_blocks=None):
    """Plan the grouped layout of top-k assignments ``topk_idx`` [N, k].

    Returns ``(rows, block_group, counts)``, all int32: the grouped-buffer
    row of flat assignment ``n * k + j`` (rows are unique), the block
    descriptor ([num_blocks], ``num_experts`` = null block; ``num_blocks``
    defaults to `num_group_blocks(N * k, num_experts, block_rows)`), and
    the tokens per expert."""
    N, k = topk_idx.shape
    T = N * k
    dev = topk_idx.device
    e_flat = topk_idx.reshape(-1).long()
    counts = torch.zeros(num_experts, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, e_flat, torch.ones_like(e_flat))
    if num_blocks is None:
        num_blocks = num_group_blocks(T, num_experts, block_rows)
    gid, offsets = group_segments(counts, block_rows, num_blocks)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    csum = torch.cumsum(counts, 0) - counts                 # exclusive
    rank = torch.arange(T, device=dev) - csum[e_sorted]
    rows = torch.empty(T, dtype=torch.int64, device=dev)
    rows[order] = offsets.long()[e_sorted] + rank
    return rows.to(torch.int32), gid, counts.to(torch.int32)


def dropless_dispatch(x, rows, top_k, padded_rows):
    """Scatter tokens ``x`` [N, D] into the ``[padded_rows, D]`` grouped
    buffer: assignment ``n * k + j`` lands at ``rows[n * k + j]``;
    padding rows stay zero (the grouped kernel's contract)."""
    xr = x.repeat_interleave(top_k, dim=0)                  # [N*k, D]
    buf = torch.zeros(padded_rows, x.shape[1], dtype=x.dtype,
                      device=x.device)
    return buf.index_copy(0, rows.long(), xr)


def dropless_combine(y_rows, rows, topk_val):
    """``y[n] = sum_j topk_val[n, j] * y_rows[rows[n*k + j]]``, summed in
    f32 and cast to the buffer's type."""
    N, k = topk_val.shape
    g = y_rows[rows.long()].reshape(N, k, y_rows.shape[-1])
    return torch.einsum("nk,nkd->nd", topk_val.float(),
                        g.float()).to(y_rows.dtype)


def expert_imbalance(counts):
    """Load-imbalance gauge: ``max(counts) / mean(counts)`` (1.0 =
    perfectly balanced), a 0-d f32 tensor."""
    c = torch.as_tensor(counts).float()
    return c.max() / c.mean().clamp_min(1.0)


def ring_all_to_all_local(*args, **kwargs):
    raise NotImplementedError(
        "ring_all_to_all_local (expert-parallel all-to-all) is not ported "
        "yet")


def measured_ep_dispatch(*args, **kwargs):
    raise NotImplementedError(
        "measured_ep_dispatch (the host-driven ep ring) is not ported yet")
