"""Grouped-expert matmul: ``act(x_blk @ w[e] + b[e])`` for every expert in
one pass over a block-aligned grouped buffer, and its gradient.

Port of ``paddle_tpu/ops/pallas_grouped.py`` (``grouped_linear_act``
:268, ``_grouped_2d`` :199-247), whose bodies ``_gmm_fwd_kernel`` (:85)
and ``_gmm_dw_kernel`` (:133) become
``paddle_tpu_torch/csrc/grouped_matmul.cu``, and of the segment
descriptors ``num_group_blocks``/``group_segments``
(``paddle_tpu/ops/pallas_tiles.py:221-256``) and
``grouped_block_rows``/``grouped_layout`` (pallas_grouped.py:67-82).

Layout (unchanged from the reference)::

    x            [R, K]      R = num_blocks * block_rows, padding rows zero
    w            [E, K, N]   stacked expert weights
    b            [E, N]
    block_group  [num_blocks] int32, nondecreasing; E marks a null block

Every block belongs wholly to one expert.  `grouped_linear_act` is the
differentiable entry point: its forward is the forward kernel
(`fused_grouped_linear_act`); its backward computes ``dz = g * act'(z)``
in f32 in plain torch (the reference does it in XLA), ``dx`` with the
forward kernel reading the weights transposed in place, ``dw`` with the
dw kernel (`fused_grouped_dw`) and ``db`` as a per-expert sum in plain
torch.  No weight is copied: the kernels take the null expert and the
transposed layout themselves, where the reference appends a zero expert
and pads N on every call (``_stacked_pad``).  The layout and routing
functions run on the device with no host synchronisation.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .matmul_epilogue import ACTIVATIONS, act_f32, act_grad_f32
from .tiles import min_rows

__all__ = ["num_group_blocks", "group_segments", "grouped_block_rows",
           "grouped_layout", "grouped_linear_act_ref", "grouped_dw_ref",
           "fused_grouped_linear_act", "fused_grouped_dw",
           "grouped_dw_slices", "grouped_linear_act"]


def num_group_blocks(total_rows, num_groups, block_rows):
    """Static upper bound on the ``block_rows``-row blocks that cover
    ``total_rows`` rows split into ``num_groups`` block-aligned groups:
    each group wastes less than one block, so cdiv(total) + groups."""
    return -(-int(total_rows) // int(block_rows)) + int(num_groups)


def group_segments(group_sizes, block_rows, num_blocks):
    """Block-aligned segment descriptors for per-group row counts
    ``group_sizes`` [G] (a tensor; on the device is fine).  Returns
    ``(block_group, group_row_offsets)``, both int32: the group owning
    each of ``num_blocks`` blocks (``G`` past the last group's blocks),
    and each group's first padded row."""
    gs = group_sizes.to(torch.int64)
    nblk = (gs + block_rows - 1) // block_rows
    ends = torch.cumsum(nblk, 0)
    starts = ends - nblk
    i = torch.arange(num_blocks, dtype=torch.int64, device=gs.device)
    # block i belongs to the group whose [start, end) holds it: the count
    # of ends <= i; empty groups never claim a block
    gid = torch.searchsorted(ends, i, right=True)
    return gid.to(torch.int32), (starts * block_rows).to(torch.int32)


def grouped_block_rows(tokens, num_experts, dtype) -> int:
    """Rows per grouped block: the expected per-expert load rounded up to
    the dtype's row multiple (8 f32, 16 bf16), at most 128."""
    per = -(-max(int(tokens), 1) // max(int(num_experts), 1))
    m = min_rows(dtype)
    return min(128, -(-per // m) * m)


def grouped_layout(tokens, num_experts, dtype):
    """``(block_rows, num_blocks, rows)``: the static grouped layout for
    ``tokens`` dispatched rows over ``num_experts`` experts."""
    bm = grouped_block_rows(tokens, num_experts, dtype)
    nb = num_group_blocks(tokens, num_experts, bm)
    return bm, nb, nb * bm


def _check_act(act):
    if act not in ACTIVATIONS:
        raise ValueError(f"act must be one of {ACTIVATIONS}, got {act!r}")


def _check_layout(x, w, b, block_group, transpose_w=False):
    """The reference's ``_check_layout`` (pallas_grouped.py:250-265).
    Returns ``(E, K, N, block_rows)``."""
    if x.dim() != 2 or w.dim() != 3 or block_group.dim() != 1:
        raise ValueError(f"grouped matmul: x [R, K], w [E, K, N] and "
                         f"block_group [blocks], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(block_group.shape)}")
    E = w.shape[0]
    if transpose_w:
        N, K = w.shape[1:]
    else:
        K, N = w.shape[1:]
    R, nb = x.shape[0], block_group.shape[0]
    if x.shape[1] != K:
        raise ValueError(f"x K={x.shape[1]} vs w K={K}")
    if nb == 0 or R % nb:
        raise ValueError(
            f"{R} grouped rows not divisible by {nb} block descriptors")
    bm = R // nb
    if bm % min_rows(x.dtype):
        raise ValueError(f"block_rows {bm} is not a {x.dtype} row multiple "
                         f"({min_rows(x.dtype)})")
    if b is not None and tuple(b.shape) != (E, N):
        raise ValueError(f"b shape {tuple(b.shape)} != ({E}, {N})")
    return E, K, N, bm


def _grouped_ref(x, w, b, gid, act, transpose_w):
    """(out, z) of the plain grouped product: per block, the full-K f32
    dot against its expert's weight (zero for a null block), the bias in
    f32, the activation in f32, one cast to ``x``'s type."""
    E = w.shape[0]
    nb = gid.shape[0]
    bm = x.shape[0] // nb
    g = gid.long()
    real = (g >= 0) & (g < E)
    e = torch.where(real, g, torch.zeros_like(g))
    wg = w[e].float()                                  # [nb, K, N]
    if transpose_w:
        wg = wg.transpose(1, 2)
    wg = wg * real[:, None, None]
    z = torch.bmm(x.reshape(nb, bm, -1).float(), wg)
    if b is not None:
        z = z + (b[e].float() * real[:, None])[:, None, :]
    z = z.reshape(nb * bm, -1)
    return act_f32(z, act).to(x.dtype), z.to(x.dtype)


def grouped_linear_act_ref(x, w, b=None, *, block_group, act="none"):
    """Plain ``act(x_blk @ w[e] + b[e])`` (the reference's
    ``grouped_linear_act_ref``, pallas_grouped.py:290-316): the same
    per-block full-K f32 dots batched over blocks, the bias in f32, the
    activation, one cast.  Block id ``E`` is the null expert, whose
    weight and bias are zero."""
    _check_act(act)
    _check_layout(x, w, b, block_group)
    return _grouped_ref(x, w, b, block_group, act, False)[0]


def grouped_dw_ref(x, dz, block_group, num_experts):
    """Plain weight gradient: ``dw[e]``, the f32 sum over expert ``e``'s
    blocks of ``x_blk^T @ dz_blk``, cast to ``x``'s type; exactly 0 for
    an expert that owns no block.  ``x`` [R, K], ``dz`` [R, N]."""
    nb = block_group.shape[0]
    bm = x.shape[0] // nb
    K, N = x.shape[1], dz.shape[1]
    per_block = torch.bmm(x.reshape(nb, bm, K).float().transpose(1, 2),
                          dz.reshape(nb, bm, N).float())   # [nb, K, N]
    dw = torch.zeros(num_experts + 1, K, N, dtype=torch.float32,
                     device=x.device)
    dw.index_add_(0, block_group.long(), per_block)
    return dw[:num_experts].to(x.dtype)


def _device_check(what, device, tensors):
    if device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {device}")
    for name, t in tensors:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def fused_grouped_linear_act(x, w, b, block_group, act="none",
                             return_z=False, transpose_w=False):
    """``act(x_blk @ w[e] + b[e])`` over the grouped rows: x ``[R, K]``,
    w ``[E, K, N]`` (with ``transpose_w``, ``[E, N, K]``: the product
    reads it transposed, as the backward's dx needs), b ``[E, N]`` or
    None (no bias), block_group ``[R / block_rows]`` int32, in any order.
    With ``return_z`` also the pre-activation (the training path saves
    it).  Null blocks give zeros."""
    _check_act(act)
    E, K, N, bm = _check_layout(x, w, b, block_group, transpose_w)
    if x.device.type == "cpu":
        out, z = _grouped_ref(x, w, b, block_group, act, transpose_w)
        return (out, z) if return_z else out
    _device_check("grouped matmul", x.device,
                  (("x", x), ("w", w), ("b", b),
                   ("block_group", block_group)))
    code = cuda_lib.dtype_code(x.dtype)
    for name, t in (("w", w), ("b", b)):
        if t is not None and t.dtype != x.dtype:
            raise ValueError(f"grouped matmul: {name} is {t.dtype}, x is "
                             f"{x.dtype}")
    if block_group.dtype != torch.int32:
        raise ValueError(f"grouped matmul: block_group must be int32, got "
                         f"{block_group.dtype}")
    R = x.shape[0]
    out = torch.empty(R, N, dtype=x.dtype, device=x.device)
    z = torch.empty_like(out) if return_z else None
    if R and N:
        rc = cuda_lib.library().ptt_grouped_matmul_fwd(
            x.data_ptr(), w.data_ptr(),
            b.data_ptr() if b is not None else None, block_group.data_ptr(),
            out.data_ptr(), z.data_ptr() if z is not None else None, R, K,
            N, E, bm, int(transpose_w), ACTIVATIONS.index(act), code,
            x.device.index, cuda_lib.stream_handle(x.device))
        cuda_lib.check(rc, "grouped_matmul")
        fused_grouped_linear_act.launches += 1
    return (out, z) if return_z else out


def grouped_dw_slices(x, dz, num_experts):
    """Row slices the dw kernel splits each expert's rows into for x
    ``[R, K]``, dz ``[R, N]`` on x's card: enough for two blocks an SM
    where the output tiles alone would not fill the card, each slice a
    few hundred rows; 1 on the CPU."""
    if x.device.type != "cuda":
        return 1
    return cuda_lib.library().ptt_grouped_matmul_dw_slices(
        x.shape[0], x.shape[1], dz.shape[1], num_experts,
        cuda_lib.dtype_code(x.dtype), x.device.index)


def fused_grouped_dw(x, dz, block_group, num_experts):
    """``dw[e] = sum over expert e's blocks of x_blk^T @ dz_blk`` in f32,
    ``[E, K, N]`` in ``x``'s type; exact zeros for an expert with no block.

    ``block_group`` must be nondecreasing (each expert's blocks one run,
    null blocks last), as `group_segments` builds it: the kernel finds an
    expert's run by binary search.  A caller that groups rows by another
    key (LoRA's backward groups blocks by adapter) sorts its blocks by
    that key first.  Where the output tiles alone would not fill the
    card, each expert's rows split into `grouped_dw_slices` slices whose
    f32 partials (a scratch allocated here) a second launch sums in a
    fixed order: one call, counted once."""
    nb = block_group.shape[0]
    if x.dim() != 2 or dz.dim() != 2 or x.shape[0] != dz.shape[0] \
            or nb == 0 or x.shape[0] % nb:
        raise ValueError(f"grouped dw: x [R, K] and dz [R, N] over "
                         f"{nb} blocks, got {tuple(x.shape)}, "
                         f"{tuple(dz.shape)}")
    if x.device.type == "cpu":
        return grouped_dw_ref(x, dz, block_group, num_experts)
    _device_check("grouped dw", x.device,
                  (("x", x), ("dz", dz), ("block_group", block_group)))
    code = cuda_lib.dtype_code(x.dtype)
    if dz.dtype != x.dtype or block_group.dtype != torch.int32:
        raise ValueError(f"grouped dw: dz must be {x.dtype} and block_group "
                         f"int32, got {dz.dtype} and {block_group.dtype}")
    R, K = x.shape
    N = dz.shape[1]
    dw = torch.empty(num_experts, K, N, dtype=x.dtype, device=x.device)
    if dw.numel():
        S = grouped_dw_slices(x, dz, num_experts)
        part = torch.empty(S, num_experts, K, N, dtype=torch.float32,
                           device=x.device) if S > 1 else None
        rc = cuda_lib.library().ptt_grouped_matmul_dw(
            x.data_ptr(), dz.data_ptr(), block_group.data_ptr(),
            dw.data_ptr(), part.data_ptr() if part is not None else None,
            R, K, N, num_experts, R // nb, S, code, x.device.index,
            cuda_lib.stream_handle(x.device))
        cuda_lib.check(rc, "grouped_matmul_dw")
        fused_grouped_dw.launches += 1
    return dw


class _GroupedLinearAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, block_group, act):
        out, z = fused_grouped_linear_act(x, w, b, block_group, act,
                                          return_z=True)
        ctx.act = act
        ctx.save_for_backward(x, w, block_group, z)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, gid, z = ctx.saved_tensors
        E, N = w.shape[0], w.shape[2]
        nb = gid.shape[0]
        # the epilogue's backward, elementwise in f32 (as the reference
        # does in XLA) on the saved pre-activation
        dz32 = g.float() * act_grad_f32(z.float(), ctx.act)
        dz = dz32.to(x.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # the forward kernel over dz, reading w[e] as [N, K]
            dx = fused_grouped_linear_act(dz, w, None, gid, "none",
                                          transpose_w=True)
        if ctx.needs_input_grad[1]:
            dw = fused_grouped_dw(x, dz, gid, E)
        if ctx.needs_input_grad[2]:
            # per-block sums, then each expert's blocks: a fixed order
            per_block = dz32.reshape(nb, -1, N).sum(dim=1)         # [nb, N]
            owner = gid.long()[None, :] == torch.arange(
                E, device=gid.device)[:, None]                     # [E, nb]
            db = (per_block[None] * owner[:, :, None]).sum(dim=1).to(
                x.dtype)
        return dx, dw, db, None, None


def grouped_linear_act(x, w, b=None, *, block_group, act="none"):
    """Differentiable ``act(x_blk @ w[e] + b[e])`` over block-aligned
    grouped rows (the reference's ``grouped_linear_act``,
    pallas_grouped.py:268): x ``[R, K]`` (padding rows zero), w ``[E, K,
    N]``, b ``[E, N]`` or None, ``block_group`` from `group_segments`.
    Padding rows' outputs are meaningless: callers gather only the
    dispatched rows back.  Without autograd it is one forward call that
    saves nothing."""
    _check_act(act)
    _check_layout(x, w, b, block_group)
    if b is None:
        b = torch.zeros(w.shape[0], w.shape[2], dtype=x.dtype,
                        device=x.device)
    b = b.to(x.dtype)
    gid = block_group.to(torch.int32)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return _GroupedLinearAct.apply(x, w, b, gid, act)
    return fused_grouped_linear_act(x, w, b, gid, act)


#: kernel launches since the last reset (chip_smoke.py reads them)
fused_grouped_linear_act.launches = 0
fused_grouped_dw.launches = 0
