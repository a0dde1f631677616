"""Ragged paged attention: ONE op for every paged-KV attention dispatch
(prefill chunks, speculative-verify windows, decode as q_len=1).
Counterpart of ``ray_tpu/ops/ragged_paged_attention.py``.

Row r of a dispatch is a query window at positions
``[starts[r], starts[r] + q_lens[r])`` attending its paged prefix plus
itself causally; the window's own K/V is already in the pages (the model
writes K/V before attention on every path). A key position is kept iff
``k_pos <= q_pos`` and ``k_pos < starts[r] + q_lens[r]``.

``ragged_paged_attention`` dispatches on the device of its inputs:
CPU tensors go to the plain PyTorch version ``ragged_paged_reference``;
CUDA tensors go to the hand-written Hopper kernel
(``csrc/ragged_paged_attention.cu``, replacing the TPU's Pallas
``_ragged_kernel``), or the call raises. There is no fallback from the
card to the plain version. In bf16 the kernel runs on tensor cores
(``mma.sync`` with ``ldmatrix``) and rounds p to bf16 before P.V, as the
Pallas kernel rounds it; in f32 it runs on CUDA cores (no TF32). In both,
K/V are gathered through the block table by ``cp.async``, and at decode
and verify widths (``q_width <= SPLIT_MAX_Q``) each row's keys are cut
into runs of a fixed number of whole pages (``split_pages``), merged in a
second launch in page order; prefill widths run unsplit. Which keys a
split holds depends only on the page index and the page size, so a
row's output has the same bits in any batch, as the Pallas kernel's has.
``ragged_paged_attention.launches`` counts wrapper calls that launched
the kernel (one per call, both passes); a replayed CUDA graph adds the
launches it captured (``llm/graphs.py``).
"""
from __future__ import annotations

import torch

# one split rule for the paged family: B2 cuts a decode row the same way
from .paged_attention import NEG_INF, SPLIT_KEYS, decode_splits, split_pages

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)
#: widest query window the kernel splits; prefill chunks run unsplit
SPLIT_MAX_Q = 32


def ragged_paged_reference(q, k_pages, v_pages, block_tables, starts,
                           q_lens, scale: float | None = None):
    """Plain version (gather, grouped-GQA einsum, no repeat). Same
    contract as the kernel; masks exactly the kernel's live-key
    predicate, so outputs match at every query position i < q_lens[r].

    Values of keys at or past a row's live length are zeroed before the
    weighted sum: their weight is already 0, and zeroing keeps a
    non-finite (stale or poisoned) page named by a table tail from
    turning 0 * inf into NaN."""
    r, qw, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    groups = h // kvh
    max_pages = block_tables.shape[1]
    klen = max_pages * page_size
    if scale is None:
        scale = d ** -0.5
    bt = block_tables.long()
    k = k_pages[bt].reshape(r, klen, kvh, d).float()
    v = v_pages[bt].reshape(r, klen, kvh, d).float()
    qg = q.reshape(r, qw, kvh, groups, d).float()
    s = torch.einsum("rqhgd,rkhd->rhgqk", qg, k) * scale
    dev = q.device
    starts = starts.to(dev).long()
    kv_len = starts + q_lens.to(dev).long()
    k_pos = torch.arange(klen, device=dev)
    q_pos = starts[:, None] + torch.arange(qw, device=dev)[None, :]
    live = k_pos[None, :] < kv_len[:, None]                   # [R, K]
    keep = (k_pos[None, None, :] <= q_pos[:, :, None]) & live[:, None, :]
    s = torch.where(keep[:, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    v = torch.where(live[:, :, None, None], v, 0.0)
    out = torch.einsum("rhgqk,rkhd->rqhgd", w, v)
    return out.reshape(r, qw, h, d).to(q.dtype)


def _check_kernel_inputs(q, k_pages, v_pages, block_tables, starts, q_lens):
    """Raise on anything the CUDA kernel does not take."""
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("starts", starts),
                    ("q_lens", q_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("q, k_pages and v_pages must share one dtype")
    for name, t in (("block_tables", block_tables), ("starts", starts),
                    ("q_lens", q_lens)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("q must be [R, Q, H, D] and k/v pages "
                         "[P, page, KVH, D] of one shape")
    r, _, h, d = q.shape
    kvh = k_pages.shape[2]
    if d not in _KERNEL_HEAD_DIMS or k_pages.shape[3] != d:
        raise ValueError(f"kernel takes head_dim in {_KERNEL_HEAD_DIMS}, "
                         f"got q {d}, pages {k_pages.shape[3]}")
    if h % kvh:
        raise ValueError(f"n_heads {h} is not a multiple of n_kv_heads {kvh}")
    if block_tables.shape[0] != r or starts.shape != (r,) or \
            q_lens.shape != (r,):
        raise ValueError("block_tables [R, max_pages], starts [R] and "
                         "q_lens [R] must match q's R")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("starts", starts),
                    ("q_lens", q_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"moves rows as 16-byte vectors)")


def rows_per_block(n_flat: int) -> int:
    """Flat rows (query positions x the G query heads of a kv head) that
    one bf16 pass-1 block holds, 16 per warp: 1 warp up to 16 (decode), 2
    up to 32 (verify), else 4 (prefill chunks). The kernel is launched
    with this many warps."""
    return 16 if n_flat <= 16 else 32 if n_flat <= 32 else 64


def num_splits(q_width: int, max_pages: int, page_size: int) -> int:
    """Splits of each row's pages for the kernel's pass 1 (both dtypes):
    one for prefill widths (q_width > SPLIT_MAX_Q), else enough runs of
    split_pages(page_size) pages to cover the table. Split s covers the
    pages [s * split_pages, (s + 1) * split_pages): the boundaries do not
    depend on the row count, the longest row or the other rows, and a
    wider table only adds splits that short rows leave empty."""
    if q_width > SPLIT_MAX_Q:
        return 1
    return decode_splits(max_pages, page_size)


def launch_plan(dtype, q_width: int, groups: int, max_pages: int,
                page_size: int) -> tuple:
    """(splits, warps per pass-1 block) the wrapper launches with: the
    split count of num_splits in either dtype; bf16 blocks of
    rows_per_block(q_width * groups) // 16 warps, f32 blocks of one
    layout (the kernel's 4 warps; passed as 1)."""
    warps = rows_per_block(q_width * groups) // 16 \
        if dtype == torch.bfloat16 else 1
    return num_splits(q_width, max_pages, page_size), warps


def _launch_kernel(q, k_pages, v_pages, block_tables, starts, q_lens,
                   scale: float):
    from . import _build
    _check_kernel_inputs(q, k_pages, v_pages, block_tables, starts, q_lens)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _build.load("ragged_paged_attention")
    r, qw, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    splits, warps = launch_plan(q.dtype, qw, h // kvh, max_pages, page_size)
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((r, splits, qw, h, d), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((r, splits, qw, h, 2), dtype=torch.float32,
                              device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.rpa_forward(
        _KERNEL_DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), starts.data_ptr(),
        q_lens.data_ptr(),
        None if part_o is None else part_o.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), out.data_ptr(),
        r, qw, h, kvh, d, page_size, max_pages, splits,
        split_pages(page_size), warps, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: "
                           f"CUDA error {err}")
    ragged_paged_attention.launches += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, block_tables, starts,
                           q_lens, *, scale: float | None = None):
    """q [R, Q, H, D]; k_pages/v_pages [P, page, KVH, D];
    block_tables [R, max_pages] int32 (physical page per logical page);
    starts [R] int32 (position of each row's first query token);
    q_lens [R] int32 (true query tokens this row, <= Q; 0 = padding row).

    Row r's queries sit at positions ``starts[r] + i`` and attend every
    key position ``<= starts[r] + i`` (paged prefix + causal window); the
    window's OWN K/V must already be scattered into the pages. Query
    positions ``i >= q_lens[r]`` produce garbage the caller discards.
    Returns [R, Q, H, D] in q.dtype.

    CPU tensors run the plain version; CUDA tensors launch the Hopper
    kernel (float32/bfloat16, head_dim 64 or 128, contiguous, 16-byte
    aligned) or raise. In bf16 the kernel rounds p to bf16 before P.V (the
    Pallas kernel's rounding); the plain version keeps it in f32.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return ragged_paged_reference(q, k_pages, v_pages, block_tables,
                                      starts, q_lens, scale=scale)
    if q.device.type == "cuda":
        return _launch_kernel(q, k_pages, v_pages, block_tables, starts,
                              q_lens, scale)
    raise ValueError(f"ragged_paged_attention: no kernel for device "
                     f"{q.device}")


#: calls that launched the kernel since the last reset (CPU calls do not
#: count; one per call, whether it ran one pass or two)
ragged_paged_attention.launches = 0


def ragged_decode_attention(q, k_pages, v_pages, block_table, lengths,
                            *, scale: float | None = None):
    """Decode as the q_len=1 case. q [B, H, D]; lengths [B] = tokens in
    cache INCLUDING the current step's (attend positions < length).
    Returns [B, H, D]."""
    lengths = lengths.to(torch.int32)
    out = ragged_paged_attention(
        q[:, None].contiguous(), k_pages, v_pages, block_table,
        torch.clamp(lengths - 1, min=0),
        torch.clamp(lengths, max=1),        # length 0 rows = padding
        scale=scale)
    return out[:, 0]
