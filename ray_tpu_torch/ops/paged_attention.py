"""Paged decode attention (counterpart of ``ray_tpu/ops/paged_attention.py``):
the masking constant and the split rule of the paged family, the plain
decode version, and the decode-only op ``paged_decode_attention``.

``paged_decode_attention`` dispatches on the device of its inputs: CPU
tensors go to the plain PyTorch version ``paged_decode_reference``; CUDA
tensors go to the hand-written Hopper kernel (``csrc/paged_attention.cu``,
replacing the TPU's Pallas ``_paged_decode_kernel``), or the call raises.
There is no fallback from the card to the plain version. The kernel cuts
each row's live keys into splits of ``split_pages(page_size)`` whole
pages, fixed by the page index (``decode_splits`` of them cover the
table), so a row's output has the same bits alone and in any batch, and
at any table width that covers it. Its blocks stream their split's K/V
through a ring of ``cp.async`` stages; the last block of a (row, kv head
tile) to finish merges the splits in split order, in the same launch,
through arrival counters that each call allocates and zeroes for itself.
``paged_decode_attention.launches`` counts calls that launched the
kernel (one per call).

No model path calls this op: the serving engines run decode through the
ragged kernel at q_len 1 (``ragged_paged_attention.ragged_decode_attention``),
as the reference does; this op is its own entry point and B1's decode
equivalence baseline.
"""
from __future__ import annotations

import torch

# one masking constant for the whole paged family; a finite value keeps
# exp(s - m) at exactly 0 for masked keys (−inf would give inf − inf)
NEG_INF = -1e30

#: keys per split of the paged kernels (B1 at decode and verify widths,
#: B2), in whole pages: 8 pages of 16
SPLIT_KEYS = 128

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)
# query heads per block, one per warp (kRows in csrc/paged_attention.cu)
_KERNEL_ROWS = 4


def split_pages(page_size: int) -> int:
    """Whole pages each split covers: SPLIT_KEYS keys, at least one page.
    A function of the page size alone."""
    return max(1, SPLIT_KEYS // page_size)


def decode_splits(max_pages: int, page_size: int) -> int:
    """Splits that cover a table of max_pages pages: split s holds the
    pages [s * split_pages, (s + 1) * split_pages). The count depends on
    the table width and the page size only, never on the batch, the
    lengths or the other rows; a wider table only adds splits that short
    rows leave empty."""
    return max(1, -(-max_pages // split_pages(page_size)))


def paged_decode_reference(q, k_pages, v_pages, block_table, lengths,
                           scale: float | None = None):
    """Plain decode attention. q [B, H, D]; k_pages/v_pages
    [P, page, KVH, D]; block_table [B, max_pages] int; lengths [B] =
    tokens in cache INCLUDING the current step's (attend positions <
    length). Returns [B, H, D] in q.dtype.

    GQA as a grouped einsum (q reshaped [B, KVH, G, D]); no repeat of
    the gathered cache. Values at masked positions are zeroed before the
    weighted sum, so a non-finite page beyond a row's length cannot leak
    through a zero weight."""
    b, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    groups = h // kvh
    max_pages = block_table.shape[1]
    if scale is None:
        scale = d ** -0.5
    bt = block_table.long()
    k = k_pages[bt].reshape(b, max_pages * page_size, kvh, d).float()
    v = v_pages[bt].reshape(b, max_pages * page_size, kvh, d).float()
    qg = q.reshape(b, kvh, groups, d).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k) * scale
    pos = torch.arange(max_pages * page_size, device=q.device)
    live = pos[None, :] < lengths.to(q.device)[:, None]         # [B, K]
    s = torch.where(live[:, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    v = torch.where(live[:, :, None, None], v, 0.0)
    out = torch.einsum("bhgk,bkhd->bhgd", w, v)
    return out.reshape(b, h, d).to(q.dtype)


def _check_kernel_inputs(q, k_pages, v_pages, block_table, lengths):
    """Raise on anything the CUDA kernel does not take."""
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("q, k_pages and v_pages must share one dtype")
    for name, t in (("block_table", block_table), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("q must be [B, H, D] and k/v pages "
                         "[P, page, KVH, D] of one shape")
    b, h, d = q.shape
    kvh = k_pages.shape[2]
    if d not in _KERNEL_HEAD_DIMS or k_pages.shape[3] != d:
        raise ValueError(f"kernel takes head_dim in {_KERNEL_HEAD_DIMS}, "
                         f"got q {d}, pages {k_pages.shape[3]}")
    if h % kvh:
        raise ValueError(f"n_heads {h} is not a multiple of n_kv_heads {kvh}")
    if block_table.dim() != 2 or block_table.shape[0] != b or \
            lengths.shape != (b,):
        raise ValueError("block_table [B, max_pages] and lengths [B] must "
                         "match q's B")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"moves K/V rows as 16-byte vectors)")


def merge_counters(batch: int, n_heads: int, n_kv_heads: int) -> int:
    """Arrival counters one kernel launch needs: one per (row, kv head,
    tile of up to _KERNEL_ROWS query heads of that kv head), the kernel's
    grid without its split axis."""
    return batch * n_kv_heads * -(-(n_heads // n_kv_heads) // _KERNEL_ROWS)


def _launch_kernel(q, k_pages, v_pages, block_table, lengths, scale: float):
    from . import _build
    _check_kernel_inputs(q, k_pages, v_pages, block_table, lengths)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _build.load("paged_attention")
    b, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    max_pages = block_table.shape[1]
    splits = decode_splits(max_pages, page_size)
    part_o = torch.empty((b, splits, h, d), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((b, splits, h, 2), dtype=torch.float32,
                          device=q.device)
    # the merge's arrival counters belong to this call alone (pda_forward
    # zeroes them on the stream first): two launches that may run at once,
    # on two streams or a graph replay beside an eager call, never share
    # them; under capture the graph's pool owns them
    counters = torch.empty(merge_counters(b, h, kvh), dtype=torch.int32,
                           device=q.device)
    err = lib.pda_forward(
        _KERNEL_DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
        part_o.data_ptr(), part_ml.data_ptr(), counters.data_ptr(),
        out.data_ptr(), b, h, kvh, d, page_size, max_pages, splits,
        split_pages(page_size), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {err}")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, block_table, lengths, *,
                           scale: float | None = None):
    """q [B, H, D]; k_pages/v_pages [P, page, KVH, D];
    block_table [B, max_pages] int32 (physical page per logical page);
    lengths [B] int32 (tokens already in cache INCLUDING the current
    step's — attend over positions < length; 0 gives a zero row).
    Returns [B, H, D] in q.dtype.

    CPU tensors run the plain version; CUDA tensors launch the Hopper
    kernel (float32/bfloat16, head_dim 64 or 128, contiguous) or raise.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pages, v_pages, block_table,
                                      lengths, scale=scale)
    if q.device.type == "cuda":
        return _launch_kernel(q, k_pages, v_pages, block_table, lengths,
                              scale)
    raise ValueError(f"paged_decode_attention: no kernel for device "
                     f"{q.device}")


#: kernel launches since the last reset (CPU calls do not count)
paged_decode_attention.launches = 0
