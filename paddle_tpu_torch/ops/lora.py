"""Segmented LoRA SGMV epilogue: ``act(z + (x_blk @ A[a]) @ B[a])`` per row
block, every block with its own adapter, and its gradient.

Port of ``paddle_tpu/ops/pallas_grouped.py:319-561``: ``lora_rank_pad``
(:346), ``lora_segment_epilogue`` (:514) with its custom-vjp
(``_lora_2d_fwd``/``_lora_2d_bwd``, :409-486) and the plain
``lora_segment_epilogue_ref`` (:535).  The Pallas body
``_lora_fwd_kernel`` (:355) becomes ``paddle_tpu_torch/csrc/lora_sgmv.cu``.

Layout (unchanged from the reference)::

    z              [R, N]     the base pre-activation x @ W + b
    x              [R, K]     R = num_blocks * block_rows
    a_stack        [L, K, r]  packed adapter A factors
    b_stack        [L, r, N]  packed B factors, alpha / r folded in
    block_adapter  [num_blocks] int32; L marks a null block

A null block adds nothing: its rows come out as ``act(z)`` exactly.
`lora_segment_epilogue` is the differentiable entry point.  Its forward
is the kernel (`fused_lora_segment_epilogue`), which also saves the
pre-activation sum ``s``.  Its backward is the reference's: ``ds =
g * act'(s)`` in f32 elementwise, ``dz = ds``, ``u = ds @ B[a]^T`` and
``dx = u @ A[a]^T`` through the grouped forward kernel reading the
factors transposed in place, ``t = x @ A[a]`` recomputed through the same
kernel, and ``dA = x^T @ u``, ``dB = t^T @ ds`` through the grouped dw
kernel after a stable sort of the blocks by adapter id (that kernel finds
each group's run of blocks by binary search, so ids must be
nondecreasing).  Adapters that own no block get exact zeros.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  The kernel has four routes (`mma_route`): bf16 with 16-byte
rows on the tensor cores, f32, f16 (f32's CUDA-core kernel on f16 rows),
and bf16 rows off 16 bytes element by element; the wrapper counts its
launches by route (``mma_launches``, ``f32_launches``, ``f16_launches``,
``elementwise_launches``).  With ``act="none"`` out
equals s bit for bit, so the kernel writes s alone and the wrapper
returns it as both (on the CPU too).
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .grouped import fused_grouped_dw, fused_grouped_linear_act
from .matmul_epilogue import ACTIVATIONS, act_f32, act_grad_f32
from .tiles import min_rows

__all__ = ["lora_rank_pad", "lora_segment_epilogue_ref",
           "fused_lora_segment_epilogue", "lora_segment_epilogue",
           "mma_route", "MMA_MAX_RANK"]

#: the widest rank the tensor-core route takes (``csrc/lora_sgmv.cu``
#: ``kMaxRank``: t's accumulators for 16 rows, r / 2 a lane)
MMA_MAX_RANK = 128
#: entries of t, block_rows x r, that the kernel takes: the f32 and
#: element-wise route keeps at most 8 of them a thread of 256 in
#: registers; the tensor-core route holds t [block_rows, r] f32 in shared
#: memory (8 KB at the limit), computed 16 rows at a time
_MAX_T_ENTRIES = 2048


def lora_rank_pad(rank, dtype) -> int:
    """Packed adapter rank: ``rank`` rounded up to the dtype's row
    multiple (8 for f32, 16 for bf16), the width every adapter of a store
    is packed at; the zero tail contributes exact zeros."""
    m = min_rows(dtype)
    return -(-max(int(rank), 1) // m) * m


def _check_act(act):
    if act not in ACTIVATIONS:
        raise ValueError(f"act must be one of {ACTIVATIONS}, got {act!r}")


def _check_layout(z, x, a, b, block_adapter):
    """The reference's ``_check_lora_layout`` (pallas_grouped.py:489-511).
    Returns ``(L, K, r, N, block_rows)``."""
    if z.dim() != 2 or x.dim() != 2 or a.dim() != 3 or b.dim() != 3 \
            or block_adapter.dim() != 1:
        raise ValueError(
            f"lora epilogue: z [R, N], x [R, K], a_stack [L, K, r], b_stack "
            f"[L, r, N], block_adapter [blocks], got {tuple(z.shape)}, "
            f"{tuple(x.shape)}, {tuple(a.shape)}, {tuple(b.shape)}, "
            f"{tuple(block_adapter.shape)}")
    L, K, r = a.shape
    R, nb = x.shape[0], block_adapter.shape[0]
    if x.shape[1] != K:
        raise ValueError(f"x K={x.shape[1]} vs a_stack K={K}")
    if tuple(b.shape[:2]) != (L, r):
        raise ValueError(
            f"b_stack leading dims {tuple(b.shape[:2])} != ({L}, {r})")
    N = b.shape[2]
    if tuple(z.shape) != (R, N):
        raise ValueError(f"z shape {tuple(z.shape)} != ({R}, {N})")
    if nb == 0 or R % nb:
        raise ValueError(f"{R} rows not divisible by {nb} block descriptors")
    bm = R // nb
    if bm % min_rows(x.dtype):
        raise ValueError(f"block_rows {bm} is not a {x.dtype} row multiple "
                         f"({min_rows(x.dtype)})")
    return L, K, r, N, bm


def mma_route(K, N, r, *tensors):
    """Whether the kernel on these tensors (z, x, a_stack, b_stack, out or
    None, s) takes the tensor-core route: the kernel's rule
    (``ptt_lora_sgmv_mma_route``), bf16 with K, N and r multiples of 8
    (16-byte rows), r at most `MMA_MAX_RANK`, every pointer 16-byte
    aligned; else f32 or the element-wise route."""
    return (tensors[1].dtype == torch.bfloat16 and K > 0 and K % 8 == 0
            and N % 8 == 0 and 0 < r <= MMA_MAX_RANK and r % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors
                    if t is not None))


def _sgmv_ref(z, x, a, b, aid, act):
    """(out, s) of the plain epilogue: per block, the full-K f32 dot of
    its rows with its adapter's A, the f32 expansion through B (both zero
    for a null block), the add to z in f32, the activation in f32, one
    cast each to ``x``'s type."""
    L, K, r = a.shape
    N = b.shape[2]
    nb = aid.shape[0]
    bm = x.shape[0] // nb
    g = aid.long()
    real = (g >= 0) & (g < L)
    idx = torch.where(real, g, torch.zeros_like(g))
    ag = a[idx].float() * real[:, None, None]                  # [nb, K, r]
    bg = b[idx].float() * real[:, None, None]                  # [nb, r, N]
    t = torch.bmm(x.reshape(nb, bm, K).float(), ag)            # [nb, bm, r]
    d = torch.bmm(t, bg)
    s = (z.reshape(nb, bm, N).float() + d).reshape(nb * bm, N)
    return act_f32(s, act).to(x.dtype), s.to(x.dtype)


def lora_segment_epilogue_ref(z, x, a_stack, b_stack, *, block_adapter,
                              act="none"):
    """Plain ``act(z + (x_blk @ A[a]) @ B[a])`` (the reference's
    ``lora_segment_epilogue_ref``, pallas_grouped.py:535-561): the same
    per-block full-K f32 dots batched over blocks, the add, the
    activation, one cast."""
    _check_act(act)
    _check_layout(z, x, a_stack, b_stack, block_adapter)
    return _sgmv_ref(z, x, a_stack, b_stack, block_adapter, act)[0]


def fused_lora_segment_epilogue(z, x, a_stack, b_stack, block_adapter,
                                act="none"):
    """``(out, s)``: the SGMV epilogue and the saved pre-activation sum
    ``s = z + (x_blk @ A[a]) @ B[a]``, both ``[R, N]`` in ``x``'s type.
    A null block (``block_adapter == L``) gives ``s = z`` and
    ``out = act(z)``.  With ``act="none"`` ``out is s``."""
    _check_act(act)
    L, K, r, N, bm = _check_layout(z, x, a_stack, b_stack, block_adapter)
    if x.device.type == "cpu":
        out, s = _sgmv_ref(z, x, a_stack, b_stack, block_adapter, act)
        return (s, s) if act == "none" else (out, s)
    if x.device.type != "cuda":
        raise RuntimeError(f"lora epilogue: no kernel for device {x.device}")
    for name, t in (("z", z), ("x", x), ("a_stack", a_stack),
                    ("b_stack", b_stack), ("block_adapter", block_adapter)):
        if t.device != x.device:
            raise ValueError(f"lora epilogue: {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"lora epilogue: {name} must be contiguous")
    code = cuda_lib.dtype_code(x.dtype)
    for name, t in (("z", z), ("a_stack", a_stack), ("b_stack", b_stack)):
        if t.dtype != x.dtype:
            raise ValueError(f"lora epilogue: {name} is {t.dtype}, x is "
                             f"{x.dtype}")
    if block_adapter.dtype != torch.int32:
        raise ValueError(f"lora epilogue: block_adapter must be int32, got "
                         f"{block_adapter.dtype}")
    if bm * r > _MAX_T_ENTRIES:
        raise ValueError(f"lora epilogue: block_rows {bm} x rank {r} exceeds "
                         f"the kernel's {_MAX_T_ENTRIES} low-rank entries")
    R = x.shape[0]
    s = torch.empty(R, N, dtype=x.dtype, device=x.device)
    out = s if act == "none" else torch.empty_like(s)
    if R and N:
        wrapper = fused_lora_segment_epilogue
        out_arg = None if out is s else out
        rc = cuda_lib.library().ptt_lora_sgmv_fwd(
            z.data_ptr(), x.data_ptr(), a_stack.data_ptr(),
            b_stack.data_ptr(), block_adapter.data_ptr(),
            None if out_arg is None else out_arg.data_ptr(), s.data_ptr(),
            R, K, N, r, L, bm, ACTIVATIONS.index(act), code, x.device.index,
            cuda_lib.stream_handle(x.device))
        cuda_lib.check(rc, "lora_sgmv")
        wrapper.launches += 1
        if mma_route(K, N, r, z, x, a_stack, b_stack, out_arg, s):
            wrapper.mma_launches += 1
        elif x.dtype == torch.float32:
            wrapper.f32_launches += 1
        elif x.dtype == torch.float16:
            wrapper.f16_launches += 1
        else:
            wrapper.elementwise_launches += 1
    return out, s


class _LoraSegmentEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, x, a, b, aid, act):
        out, s = fused_lora_segment_epilogue(z, x, a, b, aid, act)
        ctx.act = act
        ctx.save_for_backward(x, a, b, aid, s)
        return out

    @staticmethod
    def backward(ctx, g):
        x, a, b, aid, s = ctx.saved_tensors
        L = a.shape[0]
        nb = aid.shape[0]
        # the epilogue's backward, elementwise in f32 on the saved sum
        ds32 = g.float() * act_grad_f32(s.float(), ctx.act)
        ds = ds32.to(x.dtype)
        dz = ds if ctx.needs_input_grad[0] else None   # the base path's
        dx = da = db = None
        need_a, need_b = ctx.needs_input_grad[2], ctx.needs_input_grad[3]
        # u = ds @ B[a]^T: the grouped forward kernel reading B[a] [r, N]
        # transposed in place; null blocks give zeros
        u = fused_grouped_linear_act(ds, b, None, aid, "none",
                                     transpose_w=True)
        if ctx.needs_input_grad[1]:
            dx = fused_grouped_linear_act(u, a, None, aid, "none",
                                          transpose_w=True)
        if need_a or need_b:
            # the dw kernel needs each adapter's blocks in one run:
            # stable-sort the blocks by adapter id (null blocks last)
            order = torch.sort(aid.long(), stable=True).indices
            sgid = aid[order].contiguous()

            def by_adapter(v):
                return v.reshape(nb, -1, v.shape[1])[order].reshape(
                    v.shape).contiguous()
            # an adapter that owns no block gets exact zeros from the dw
            # kernel (and its plain version)
            if need_a:
                da = fused_grouped_dw(by_adapter(x), by_adapter(u), sgid, L)
            if need_b:
                # t = x @ A[a] recomputed rather than saved
                t = fused_grouped_linear_act(x, a, None, aid, "none")
                db = fused_grouped_dw(by_adapter(t), by_adapter(ds), sgid, L)
        return dz, dx, da, db, None, None


def lora_segment_epilogue(z, x, a_stack, b_stack, *, block_adapter,
                          act="none"):
    """Differentiable ``act(z + (x_blk @ A[a]) @ B[a])`` over block-aligned
    rows (the reference's ``lora_segment_epilogue``, pallas_grouped.py:514),
    in z, x and both adapter stacks; ``block_adapter`` int32, ``L`` for a
    null block.  Without autograd it is one forward call that saves
    nothing."""
    _check_act(act)
    _check_layout(z, x, a_stack, b_stack, block_adapter)
    aid = block_adapter.to(torch.int32).contiguous()
    z, x = z.contiguous(), x.contiguous()
    a_stack, b_stack = a_stack.contiguous(), b_stack.contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (z, x, a_stack, b_stack)):
        return _LoraSegmentEpilogue.apply(z, x, a_stack, b_stack, aid, act)
    return fused_lora_segment_epilogue(z, x, a_stack, b_stack, aid, act)[0]


#: kernel launches since the last reset (chip_smoke.py reads them), and
#: the same by route
fused_lora_segment_epilogue.launches = 0
fused_lora_segment_epilogue.mma_launches = 0
fused_lora_segment_epilogue.f32_launches = 0
fused_lora_segment_epilogue.f16_launches = 0
fused_lora_segment_epilogue.elementwise_launches = 0
