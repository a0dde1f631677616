"""Flash attention for training: plain PyTorch versions, the Hopper
kernels' wrappers, and the differentiable op (counterpart of
``ray_tpu/ops/flash_attention.py``).

Layout: q ``[B, Sq, H, D]``, k/v ``[B, Sk, KVH, D]`` with KVH dividing H
(grouped-query attention: query head h reads kv head h // (H // KVH), no
repeat). Causal masking is top-left: query i sees key j iff j <= i, both
counted from 0, also when Sq != Sk. The log-sum-exp ``lse`` is
``[B, H, Sq]`` in f32.

``flash_attention`` dispatches on the device of its inputs. CPU tensors
run the plain versions (``flash_forward_reference``,
``flash_backward_reference``); CUDA tensors launch the hand-written
kernels of ``csrc/flash_attention.cu`` or raise: there is no fallback
from the card to the plain versions, nor from one kernel to another. In
bf16 all three kernels (forward, dq, dkv) run on tensor cores
(``mma.sync`` with ``ldmatrix``, operands staged by ``cp.async``; the
forward rounds the unnormalised p to bf16 before P.V, as the reference
does); in f32 they run on CUDA cores, so f32 stays f32 (no TF32). The
source's header says why. The forward is the dispatcher-
visible op ``torch.ops.ray_tpu_torch.flash_fwd`` returning ``(out,
lse)``, with its backward registered on it, so a selective-checkpoint
policy can keep its outputs (``models/llama.py``'s ``save_attn``), as the
reference's ``checkpoint_name`` tags do.

Launch counters, one per kernel (CPU calls do not count):
``flash_fwd_kernel.launches``, ``flash_dq_kernel.launches``,
``flash_dkv_kernel.launches``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and what chip_smoke holds the kernels to)
# ---------------------------------------------------------------------------

def _round(x, dtype):
    """x (f32) rounded to ``dtype`` and back: the reference's
    ``.astype(dtype)`` before a product, kept in f32 for the product."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _scores(q, k, causal: bool, scale: float):
    """f32 scores [B, KVH, G, Sq, Sk], masked to NEG_INF where not kept."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if causal:
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(keep, s, NEG_INF)
    return s


def _attend(p, v, q):
    """softmax weights [B, KVH, G, Sq, Sk] (f32) @ v -> [B, Sq, H, D] in
    q's dtype, p rounded to v's dtype first (reference ``:59``)."""
    b, sq, h, d = q.shape
    out = torch.einsum("bhgqk,bkhd->bqhgd", _round(p, v.dtype), v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def mha_reference(q, k, v, causal: bool = False, scale: float | None = None):
    """Plain softmax attention (the numerical oracle). q [B,Sq,H,D],
    k/v [B,Sk,KVH,D]. Returns [B,Sq,H,D] in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _attend(torch.softmax(_scores(q, k, causal, scale), dim=-1), v, q)


def flash_forward_reference(q, k, v, causal: bool = False,
                            scale: float | None = None):
    """Plain forward: (out [B,Sq,H,D] in q's dtype, lse [B,H,Sq] f32), as
    the reference's ``_fwd`` computes them off the TPU."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, h, _ = q.shape
    s = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1).reshape(b, h, sq)
    return _attend(torch.softmax(s, dim=-1), v, q), lse


def flash_backward_reference(q, k, v, out, lse, g, causal: bool = False,
                             scale: float | None = None, block_k: int = 512):
    """Plain backward (counterpart of ``_bwd_blockwise``): recompute the
    probabilities from the saved lse one block of ``block_k`` keys at a
    time (the last block may be shorter), so live memory is
    O(Sq * block_k). Returns (dq, dk, dv) in the inputs' dtypes.

    ``delta = rowsum(dO * O)`` in f32; ``ds`` is rounded to k's dtype and
    ``p`` to v's before their products, as the Pallas backward kernels
    round them (``:279``, ``:334-340``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    qf = q.reshape(b, sq, kvh, grp, d).float()
    gf = g.reshape(b, sq, kvh, grp, d).float()
    delta = (gf * out.reshape(b, sq, kvh, grp, d).float()).sum(-1)
    delta = delta.permute(0, 2, 3, 1)[..., None]              # [B,KVH,G,Sq,1]
    lse5 = lse.reshape(b, kvh, grp, sq)[..., None]
    q_pos = torch.arange(sq, device=q.device)
    dq = torch.zeros_like(qf)
    dk = torch.empty((b, sk, kvh, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for k0 in range(0, sk, max(1, block_k)):
        kb = k[:, k0:k0 + block_k].float()
        vb = v[:, k0:k0 + block_k].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb) * scale
        if causal:
            k_pos = k0 + torch.arange(kb.shape[1], device=q.device)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
        p = torch.exp(s - lse5)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", gf, vb)
        ds = _round(p * (dp - delta) * scale, k.dtype)
        dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kb)
        dk[:, k0:k0 + block_k] = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
        dv[:, k0:k0 + block_k] = torch.einsum(
            "bhgqk,bqhgd->bkhd", _round(p, v.dtype), gf)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check_kernel_inputs(q, k, v):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash kernels take CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError("q must be [B, Sq, H, D] and k/v [B, Sk, KVH, D] "
                         "of one shape")
    d = q.shape[3]
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"n_heads {q.shape[2]} is not a multiple of "
                         f"n_kv_heads {k.shape[2]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             f"move rows as 16-byte vectors)")


def _sizes(q, k):
    b, sq, h, d = q.shape
    return b, sq, k.shape[1], h, k.shape[2], d


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def flash_fwd_kernel(q, k, v, causal: bool, scale: float):
    """B3 on the card: (out [B,Sq,H,D] in q's dtype, lse [B,H,Sq] f32).
    bf16 runs on tensor cores, f32 on CUDA cores."""
    from . import _build
    _check_kernel_inputs(q, k, v)
    b, sq, sk, h, kvh, d = _sizes(q, k)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:            # an empty grid is not a launch
        return out, lse
    lib = _build.load("flash_attention")
    err = lib.flash_fwd(
        _KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, sq, sk, h, kvh, d, int(causal),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_fwd")
    flash_fwd_kernel.launches += 1
    return out, lse


def _check_rows(q, dout, lse, delta):
    if dout.shape != q.shape or dout.dtype != q.dtype or \
            dout.device != q.device:
        raise ValueError("dout must match q in shape, dtype and device")
    b, sq, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 or \
                t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"[B, H, Sq] tensor on q's device")
    if dout.data_ptr() % 16:
        raise ValueError("dout must be 16-byte aligned")


def flash_dq_kernel(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """B4 on the card: dq [B,Sq,H,D] in q's dtype. dout contiguous;
    lse/delta [B,H,Sq] f32. bf16 runs on tensor cores, f32 on CUDA
    cores; either way each dq element is summed by one thread in a fixed
    order, so two launches give the same bits."""
    from . import _build
    _check_kernel_inputs(q, k, v)
    _check_rows(q, dout, lse, delta)
    b, sq, sk, h, kvh, d = _sizes(q, k)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    lib = _build.load("flash_attention")
    err = lib.flash_dq(
        _KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        b, sq, sk, h, kvh, d, int(causal), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_dq")
    flash_dq_kernel.launches += 1
    return dq


def flash_dkv_kernel(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """B5 on the card: (dk, dv) [B,Sk,KVH,D] in k's dtype, summed over
    the query heads of each kv head inside the kernel (no atomics:
    deterministic). bf16 runs on tensor cores, f32 on CUDA cores."""
    from . import _build
    _check_kernel_inputs(q, k, v)
    _check_rows(q, dout, lse, delta)
    b, sq, sk, h, kvh, d = _sizes(q, k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    lib = _build.load("flash_attention")
    err = lib.flash_dkv(
        _KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, sq, sk, h, kvh, d, int(causal), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_dkv")
    flash_dkv_kernel.launches += 1
    return dk, dv


#: kernel launches since the last reset
flash_fwd_kernel.launches = 0
flash_dq_kernel.launches = 0
flash_dkv_kernel.launches = 0


# ---------------------------------------------------------------------------
# Dispatch by device
# ---------------------------------------------------------------------------

def _device_kind(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return q.device.type


def flash_forward(q, k, v, causal: bool, scale: float):
    """(out, lse): the plain version on CPU tensors, B3 on CUDA tensors."""
    if _device_kind(q) == "cpu":
        return flash_forward_reference(q, k, v, causal, scale)
    return flash_fwd_kernel(q, k, v, causal, scale)


def delta_rows(out, g):
    """delta = rowsum(dO * O) in f32, as [B, H, Sq] (reference ``:380``)."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_backward(q, k, v, out, lse, g, causal: bool, scale: float,
                   block_k: int):
    """(dq, dk, dv): the plain backward on CPU tensors; on CUDA tensors
    delta in PyTorch, then the dq kernel and the dkv kernel, launched on
    the stream current at the call (autograd's)."""
    if _device_kind(q) == "cpu":
        return flash_backward_reference(q, k, v, out, lse, g, causal, scale,
                                        block_k)
    g = g.contiguous()
    delta = delta_rows(out, g)
    dq = flash_dq_kernel(q, k, v, g, lse, delta, causal, scale)
    dk, dv = flash_dkv_kernel(q, k, v, g, lse, delta, causal, scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The differentiable op
# ---------------------------------------------------------------------------

@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float,
                  block_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_forward(q, k, v, causal, scale)


@_flash_fwd_op.register_fake
def _(q, k, v, causal, scale, block_k):
    b, sq, h, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, sq), dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    q, k, v, causal, scale, block_k = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale, ctx.block_k = causal, scale, block_k


def _backward(ctx, g_out, g_lse):
    # lse is a residual for the backward, as in the reference: nothing
    # downstream of flash_attention reads it, so g_lse carries nothing
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_backward(q, k, v, out, lse, g_out, ctx.causal,
                                ctx.scale, ctx.block_k)
    return dq, dk, dv, None, None, None


_flash_fwd_op.register_autograd(_backward, setup_context=_setup_context)

#: the op a selective-checkpoint policy saves (models/llama.py save_attn)
FLASH_FWD_OP = torch.ops.ray_tpu_torch.flash_fwd.default


def flash_attention(q, k, v, causal: bool = False,
                    scale: float | None = None, block_q: int = 512,
                    block_k: int = 512):
    """Fused attention, differentiable in q, k and v. q [B,Sq,H,D];
    k/v [B,Sk,KVH,D] (GQA when KVH < H). Returns [B,Sq,H,D] in q's dtype.

    CPU tensors run the plain versions; CUDA tensors launch the Hopper
    kernels (float32/bfloat16, head_dim 64 or 128, contiguous, 16-byte
    aligned) or raise. ``block_q`` and ``block_k`` are the reference
    config's tile knobs (``LlamaConfig.attn_block_q/k``): the port uses
    ``block_k`` only as the plain backward's key-block size, and neither
    reaches the kernels, whose tiles are fixed for the card."""
    del block_q
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out, _ = _flash_fwd_op(q, k, v, bool(causal), float(scale),
                           int(block_k))
    return out
