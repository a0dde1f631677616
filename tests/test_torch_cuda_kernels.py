"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test needs an NVIDIA GPU (and nvcc to build the
kernels from ray_tpu_torch/ops/csrc) and skips on a machine without one.
On a GPU machine:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Ragged paged attention, at real query positions only: f32 atol 2e-5
(both sides sum in f32 in different orders); bf16 atol 1e-2 + rtol 2^-7
(both compute in f32 and round the output to bf16, which can land one
bf16 ulp — at most 2^-7 of the value — apart).

Decode-only paged attention (split-KV): the same tolerances as the
ragged kernel, against its plain version and against the ragged kernel
at q_len 1 on rows of length >= 1; rows of length 0 are exactly 0.

Flash forward, dq and dkv: |kernel - plain| <= atol * max|plain| +
rtol * |plain| per tensor, with (atol, rtol) = (1e-5, 1e-4) for f32 and
for lse, and (2^-8, 2^-7) for bf16 outputs (chip_smoke.FLASH_TOL states
why).
"""
import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops.flash_attention import (
    delta_rows, flash_attention, flash_backward_reference, flash_dkv_kernel,
    flash_dq_kernel, flash_forward_reference, flash_fwd_kernel,
)
from ray_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_reference,
)
from ray_tpu_torch.ops.ragged_paged_attention import (
    ragged_decode_attention, ragged_paged_attention, ragged_paged_reference,
)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(atol=2e-5, rtol=0.0),
       torch.bfloat16: dict(atol=1e-2, rtol=2 ** -7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dtype, d, groups, page, device, seed=0):
    """Ragged rows (from-zero window, mid-page verify window, tail-partial
    page, empty row) with table tails naming a NaN page."""
    rng = np.random.RandomState(seed)
    kvh, P, maxp, Q = 2, 40, 8, 9
    h = kvh * groups
    starts = np.asarray([0, 13, 2 * page + 3, 0, 5 * page - 1], np.int32)
    q_lens = np.asarray([9, 5, 3, 0, 1], np.int32)
    bt = np.full((len(starts), maxp), P - 1, np.int32)
    for r, n in enumerate(-(-(starts + q_lens) // page)):
        bt[r, :n] = rng.choice(np.arange(1, P - 1), n, replace=False)
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((len(starts), Q, h, d), generator=g, device=device)
    kp = torch.randn((P, page, kvh, d), generator=g, device=device)
    vp = torch.randn((P, page, kvh, d), generator=g, device=device)
    kp[P - 1] = float("nan")
    vp[P - 1] = float("nan")
    as_t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    return (q.to(dtype), kp.to(dtype), vp.to(dtype), as_t(bt),
            as_t(starts), as_t(q_lens))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("groups,page", [(1, 8), (4, 8), (2, 16), (4, 16)])
def test_kernel_matches_plain_version(cuda, dtype, d, groups, page):
    args = _case(dtype, d, groups, page, cuda)
    got = ragged_paged_attention(*args)
    want = ragged_paged_reference(*args)
    torch.cuda.synchronize()
    for r, n in enumerate(args[5].tolist()):
        if n:
            assert torch.isfinite(got[r, :n]).all()
            torch.testing.assert_close(got[r, :n].float(),
                                       want[r, :n].float(), **TOL[dtype])


def _rpa_case(dtype, d, q_width, groups, page, starts, q_lens, device,
              seed=0, kvh=2):
    """Ragged rows on disjoint live pages; table tails name an all-NaN
    page and the slots past each row's live length in its last live page
    are NaN, so a kernel that reads past a row's keys gives NaN."""
    rng = np.random.RandomState(seed)
    starts = np.asarray(starts, np.int32)
    q_lens = np.asarray(q_lens, np.int32)
    kv_len = starts + q_lens
    n_live = -(-kv_len // page)
    maxp = int(n_live.max()) + 2
    P = int(n_live.sum()) + 2
    dead = P - 1
    ids = iter(rng.permutation(np.arange(1, P - 1)))
    bt = np.full((len(starts), maxp), dead, np.int32)
    for r, n in enumerate(n_live):
        bt[r, :n] = [next(ids) for _ in range(n)]
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((len(starts), q_width, kvh * groups, d), generator=g,
                    device=device).to(dtype)
    kp = torch.randn((P, page, kvh, d), generator=g, device=device).to(dtype)
    vp = torch.randn((P, page, kvh, d), generator=g, device=device).to(dtype)
    for t in (kp, vp):
        t[dead] = float("nan")
        for r, n in enumerate(kv_len):
            if n % page:
                t[bt[r, n // page], n % page:] = float("nan")
    as_t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    return q, kp, vp, as_t(bt), as_t(starts), as_t(q_lens)


def _assert_rpa_matches(args, dtype):
    got = ragged_paged_attention(*args)
    want = ragged_paged_reference(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == args[0].shape
    for r, n in enumerate(args[5].tolist()):
        if n:
            assert torch.isfinite(got[r, :n]).all()
            torch.testing.assert_close(got[r, :n].float(),
                                       want[r, :n].float(), **TOL[dtype])
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("q_width,groups", [
    (15, 1), (16, 1), (17, 1),      # flat rows Q * G: one warp tile and its
    (5, 4), (16, 4), (65, 1),       # edges, 20 = 16 + 4, 64, 65
    (13, 5)])                       # 65 with G 5
def test_ragged_kernel_flat_row_tile_edges(cuda, dtype, d, page, q_width,
                                           groups):
    """The bf16 kernel holds 16 flat rows (query position x query head of
    the group) per warp, 1, 2 or 4 warps a block: every tile edge, with
    q_len < Q, q_len 0, a full row and starts that are not page-aligned."""
    starts = [0, 3, 2 * page + 5, 0, page - 1]
    q_lens = [q_width, max(1, q_width - 2), max(1, q_width // 2), 0,
              q_width]
    args = _rpa_case(dtype, d, q_width, groups, page, starts, q_lens, cuda)
    _assert_rpa_matches(args, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("q_width", [1, 5])
def test_ragged_kernel_long_rows_split_kv(cuda, dtype, d, page, q_width):
    """Rows whose live pages span several splits (and short rows that
    leave later splits empty) at decode and verify widths, in both dtypes
    (f32 splits as bf16 does); NaN table tails and NaN slots past each
    row's keys never reach the output."""
    starts = [4000 - q_width, 1000 - q_width, 517, 33, 0]
    q_lens = [q_width, q_width, q_width, q_width, 0]
    args = _rpa_case(dtype, d, q_width, 4, page, starts, q_lens, cuda,
                     seed=1)
    _assert_rpa_matches(args, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_width,starts,q_lens", [
    (1, [0, 16, 129, 255, 510, 639, 876, 999], [1] * 8),        # decode
    (128, [0, 256, 512, 640], [128, 128, 77, 128]),             # prefill
    (5, [3, 21, 100, 255, 301, 517, 700, 900], [5] * 8),        # verify
], ids=["decode", "prefill", "verify"])
def test_ragged_kernel_at_a_tp2_rank_shape(cuda, dtype, q_width, starts,
                                           q_lens):
    """One tp=2 rank of Llama-3-8B (the shape phase 4k serves at): H 16,
    KVH 4, D 128, page 16, at chip_smoke phase 3's rows."""
    args = _rpa_case(dtype, 128, q_width, 4, 16, starts, q_lens, cuda,
                     kvh=4)
    assert args[0].shape[2] == 16 and args[1].shape[2] == 4
    _assert_rpa_matches(args, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ragged_kernel_split_count_two_to_eight(cuda, dtype):
    """A decode batch of 40 rows of 300-2000 keys: splits of 8 pages
    (128 keys) in either dtype, so each row's live pages are cut in 3 to
    16 pieces, most between two and eight, and the table's 126 pages
    give 16 splits."""
    from ray_tpu_torch.ops.ragged_paged_attention import (launch_plan,
                                                          split_pages)
    rng = np.random.RandomState(5)
    lengths = rng.randint(300, 2000, 40)
    lengths[0] = 2000
    args = _rpa_case(dtype, 128, 1, 4, 16, lengths - 1, np.ones(40), cuda,
                     seed=5)
    assert split_pages(16) == 8
    assert launch_plan(dtype, 1, 4, args[3].shape[1], 16)[0] == 16
    _assert_rpa_matches(args, dtype)


def test_ragged_kernel_one_split_prefill(cuda):
    """Prefill widths run unsplit whatever the batch: pass 1 writes the
    output itself."""
    from ray_tpu_torch.ops.ragged_paged_attention import num_splits
    starts = [0, 37, 256, 0, 500, 16, 3, 130, 64]
    q_lens = [128, 128, 77, 0, 128, 1, 100, 128, 128]
    args = _rpa_case(torch.bfloat16, 128, 128, 4, 16, starts, q_lens, cuda,
                     seed=4)
    assert num_splits(128, args[3].shape[1], 16) == 1
    _assert_rpa_matches(args, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_width", [1, 5, 128])
@pytest.mark.parametrize("width", [4, 16, 64])
def test_ragged_kernel_is_batch_invariant(cuda, dtype, q_width, width):
    """A row called alone and inside batches of 1-8 other rows of mixed
    lengths, at its own table width and at the widest (64 pages), gives
    the same bits: the split boundaries depend on the page index and the
    page size only (decode and verify widths), and prefill widths run
    unsplit. The row fills its table but for 3 keys."""
    page, kvh, groups, d, P = 16, 2, 4, 128, 700
    h = kvh * groups
    rng = np.random.RandomState(width * 1000 + q_width)
    g = torch.Generator(device=cuda).manual_seed(width + q_width)
    kp = torch.randn((P, page, kvh, d), generator=g, device=cuda).to(dtype)
    vp = torch.randn((P, page, kvh, d), generator=g, device=cuda).to(dtype)
    kv_len = width * page - 3
    q_len = min(q_width, kv_len)
    q_row = torch.randn((1, q_width, h, d), generator=g,
                        device=cuda).to(dtype)
    pages_row = rng.choice(np.arange(1, P), width, replace=False)

    def call(n_other, w, at):
        """The row at index ``at`` among n_other rows of random lengths,
        every table w pages wide."""
        n = n_other + 1
        bt = np.zeros((n, w), np.int32)
        starts = np.zeros(n, np.int32)
        q_lens = np.zeros(n, np.int32)
        q = torch.randn((n, q_width, h, d), generator=g,
                        device=cuda).to(dtype)
        for r in range(n):
            if r == at:
                bt[r, :width] = pages_row
                starts[r], q_lens[r] = kv_len - q_len, q_len
                q[r] = q_row[0]
                continue
            keys = int(rng.randint(1, w * page + 1))
            ql = int(rng.randint(0, min(q_width, keys) + 1))
            bt[r, :-(-keys // page)] = rng.choice(np.arange(1, P),
                                                  -(-keys // page))
            starts[r], q_lens[r] = keys - ql, ql
        as_t = lambda a: torch.as_tensor(a, device=cuda)   # noqa: E731
        out = ragged_paged_attention(q, kp, vp, as_t(bt), as_t(starts),
                                     as_t(q_lens))
        return out[at, :q_len]

    alone = call(0, width, 0)
    for w in sorted({width, 64}):
        for n_other in range(1, 9):
            got = call(n_other, w, int(rng.randint(0, n_other + 1)))
            assert torch.equal(got, alone), (w, n_other)


@pytest.mark.parametrize("q_width", [1, 5, 64])
def test_ragged_kernel_is_deterministic(cuda, q_width):
    """Two launches of the bf16 kernel (split or not) give the same bits:
    no atomics on data."""
    starts = [1500, 3, 700, 64]
    args = _rpa_case(torch.bfloat16, 128, q_width, 4, 16, starts,
                     [q_width] * 4, cuda, seed=2)
    a = ragged_paged_attention(*args)
    b = ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_decode_wrapper_and_launch_count(cuda):
    """One launch per call on CUDA tensors, none on CPU tensors; decode
    at q_len=1 matches the plain version."""
    q, kp, vp, bt, _, _ = _case(torch.float32, 128, 4, 16, cuda)
    lengths = torch.tensor([1, 17, 40, 0, 64], dtype=torch.int32,
                           device=cuda)
    before = ragged_paged_attention.launches
    got = ragged_decode_attention(q[:, 0], kp, vp, bt, lengths)
    assert ragged_paged_attention.launches == before + 1
    ragged_decode_attention(q[:, 0].cpu(), kp.cpu(), vp.cpu(), bt.cpu(),
                            lengths.cpu())
    assert ragged_paged_attention.launches == before + 1
    want = ragged_decode_attention(q[:, 0].cpu(), kp.cpu(), vp.cpu(),
                                   bt.cpu(), lengths.cpu())
    torch.testing.assert_close(got[:3].cpu(), want[:3], atol=2e-5, rtol=0)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, kp, vp, bt, st, ql = _case(torch.float32, 64, 2, 8, cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ragged_paged_attention(q.half(), kp.half(), vp.half(), bt, st, ql)
    with pytest.raises(ValueError, match="head_dim"):
        ragged_paged_attention(q[..., :32].contiguous(),
                               kp[..., :32].contiguous(),
                               vp[..., :32].contiguous(), bt, st, ql)
    with pytest.raises(ValueError, match="contiguous"):
        ragged_paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                               kp, vp, bt, st, ql)
    with pytest.raises(ValueError, match="int32"):
        ragged_paged_attention(q, kp, vp, bt.long(), st, ql)
    with pytest.raises(ValueError, match="on cpu"):
        ragged_paged_attention(q, kp, vp, bt.cpu(), st, ql)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(q.numel() + 1, device=cuda)
        ragged_paged_attention(flat[1:].view(q.shape), kp, vp, bt, st, ql)


def test_engine_on_card_matches_engine_on_cpu(cuda):
    """The same small f32 model served through the kernel and through the
    plain version gives the same greedy tokens."""
    from ray_tpu_torch.llm import (PagedEngineConfig, PagedInferenceEngine,
                                   SamplingParams)
    from ray_tpu_torch.models import llama
    mc = llama.llama_tiny(vocab_size=300, dim=256, n_heads=4, n_kv_heads=2,
                          mlp_dim=512, max_seq_len=512)
    params = llama.init(mc, seed=1, device="cpu")
    on_card = {k: ({n: t.to(cuda) for n, t in v.items()}
                   if isinstance(v, dict) else v.to(cuda))
               for k, v in params.items()}
    cfg = PagedEngineConfig(model=mc, max_batch_size=3, page_size=8,
                            num_pages=96, max_pages_per_seq=32,
                            chunk_size=16, decode_window=4)
    prompts = [[3, 4, 5], list(range(40, 90)), list(range(7, 30))]
    sp = SamplingParams(max_tokens=8)
    a = PagedInferenceEngine(cfg, on_card, device=cuda).generate(prompts, sp)
    b = PagedInferenceEngine(cfg, params, device="cpu").generate(prompts, sp)
    assert [x["token_ids"] for x in a] == [x["token_ids"] for x in b]


def _tp2_on(cuda):
    """A tp=2 mesh with both ranks on the one card."""
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    return build_mesh(MeshSpec(tp=2), devices=[dev, dev])


def test_tp2_engine_on_card_matches_engine_on_cpu(cuda):
    """The f32 model above at tp=2 on the card (both ranks on it, the
    kernel at H 2 / KVH 1 per rank) gives the CPU's one-device greedy
    tokens, logprobs within 1e-4, and moves no shard."""
    from ray_tpu_torch.llm import (PagedEngineConfig, PagedInferenceEngine,
                                   SamplingParams)
    from ray_tpu_torch.models import llama
    mc = llama.llama_tiny(vocab_size=300, dim=256, n_heads=4, n_kv_heads=2,
                          mlp_dim=512, max_seq_len=512)
    params = llama.init(mc, seed=1, device="cpu")
    cfg = PagedEngineConfig(model=mc, max_batch_size=3, page_size=8,
                            num_pages=96, max_pages_per_seq=32,
                            chunk_size=16, decode_window=4)
    prompts = [[3, 4, 5], list(range(40, 90)), list(range(7, 30))]
    sp = SamplingParams(max_tokens=8, logprobs=1)
    card = PagedInferenceEngine(dataclasses.replace(cfg, mesh=_tp2_on(cuda)),
                                params, device=cuda)
    before = ragged_paged_attention.launches
    a = card.generate(prompts, sp)
    assert ragged_paged_attention.launches > before
    b = PagedInferenceEngine(cfg, params, device="cpu").generate(prompts, sp)
    assert [x["token_ids"] for x in a] == [x["token_ids"] for x in b]
    for x, y in zip(a, b):
        np.testing.assert_allclose(x["logprobs"], y["logprobs"], atol=1e-4)
    assert card.stats["mesh_reshard_bytes"] == 0


def _bf16_engines(cuda, **kw):
    """A captured and an eager paged engine on one bf16 model (head_dim
    64, GQA 2), same weights and seed; the captured one warmed up."""
    from ray_tpu_torch.llm import PagedEngineConfig, PagedInferenceEngine
    from ray_tpu_torch.models import llama
    mc = llama.llama_tiny(vocab_size=300, dim=256, n_heads=4, n_kv_heads=2,
                          mlp_dim=512, max_seq_len=512, dtype=torch.bfloat16)
    params = llama.init(mc, seed=4, device=cuda)
    cfg = PagedEngineConfig(model=mc, **{
        **dict(max_batch_size=4, page_size=16, num_pages=96,
               max_pages_per_seq=32, chunk_size=32, decode_window=4), **kw})
    captured = PagedInferenceEngine(cfg, params, rng_seed=3, device=cuda)
    eager = PagedInferenceEngine(cfg, params, rng_seed=3, device=cuda)
    eager._eager = True
    captured.warmup(sample_modes=((False, False), (True, True)))
    return captured, eager


FAMILY_RUNS = {
    # long prompts, one token: prefill dispatches only
    "prefill": (dict(), lambda rng: (
        [[int(t) for t in rng.randint(0, 300, n)] for n in (70, 33, 150, 9)],
        [dict(max_tokens=1, logprobs=1), dict(max_tokens=1, temperature=0.9),
         dict(max_tokens=1), dict(max_tokens=1, temperature=1.0, top_k=5)])),
    # greedy, sampled, top-k and logprobs rows decoding together
    "decode": (dict(), lambda rng: (
        [[int(t) for t in rng.randint(0, 300, n)] for n in (5, 40, 17, 60)],
        [dict(max_tokens=14, logprobs=1), dict(max_tokens=14, temperature=0.8),
         dict(max_tokens=14), dict(max_tokens=14, temperature=1.2,
                                   top_k=7)])),
    # greedy rows with drafts of their last tokens: speculative verify
    # dispatches (random weights seldom repeat themselves)
    "verify": (dict(spec_tokens=4, page_buckets="on"), lambda rng: (
        [[7, 8, 9] * 6, [11, 12] * 8],
        [dict(max_tokens=30, logprobs=1), dict(max_tokens=30)])),
}


@pytest.mark.parametrize("family", sorted(FAMILY_RUNS))
def test_captured_dispatch_equals_eager_body(cuda, family):
    """The same traffic through CUDA graphs and through the eager bodies
    on the card gives the same bits: tokens, logprobs, every page from 1
    up, the dispatch counters and the ragged kernel's launches (a replay
    adds the launches its capture made)."""
    _captured_vs_eager(cuda, family)


@pytest.mark.parametrize("family", sorted(FAMILY_RUNS))
def test_tp2_captured_dispatch_equals_eager_body(cuda, family):
    """The same, with both engines on a tp=2 mesh on the one card: each
    program captures both ranks' kernels and the reduce between them."""
    _captured_vs_eager(cuda, family, mesh=_tp2_on(cuda))


def _captured_vs_eager(cuda, family, **extra):
    from ray_tpu_torch.llm import SamplingParams
    kw, make = FAMILY_RUNS[family]
    captured, eager = _bf16_engines(cuda, **kw, **extra)
    prompts, params = make(np.random.RandomState(6))
    sps = [SamplingParams(**p) for p in params]
    if family == "verify":
        for eng in (captured, eager):
            eng._propose_draft = lambda ctx, n, s: [int(t) for t in
                                                    ctx[-s:]]
    runs = []
    for eng in (captured, eager):
        before = ragged_paged_attention.launches
        out = eng.generate(prompts, sps)
        torch.cuda.synchronize()
        runs.append((out, ragged_paged_attention.launches - before))
    (a, la), (b, lb) = runs
    assert [x["token_ids"] for x in a] == [x["token_ids"] for x in b]
    assert [x["logprobs"] for x in a] == [x["logprobs"] for x in b]
    assert captured.stats == eager.stats
    assert la == lb > 0
    key = {"prefill": "prefill_dispatches", "decode": "decode_dispatches",
           "verify": "spec_dispatches"}[family]
    assert captured.stats[key] > 0
    # the traffic ran replays of programs captured at warmup, and only a
    # key warmup does not build (a logprobs mode) was captured lazily
    assert len(captured._graphs) >= len(captured._warmup_keys(
        ((False, False), (True, True))))
    for ca, ea in zip(captured._layers(), eager._layers()):
        assert torch.equal(ca["k"][1:], ea["k"][1:])
        assert torch.equal(ca["v"][1:], ea["v"][1:])


def test_graph_replay_counts_its_kernel_launches(cuda):
    """A replayed decode window of w steps adds n_layers x w launches,
    as the eager body does; capturing adds none. Each row writes and
    reads its own two pages (never written before, so zero in both
    engines), so all three dispatches see the same pages."""
    from ray_tpu_torch.llm.graphs import GraphCache
    captured, eager = _bf16_engines(cuda)
    n_layers, w = captured.cfg.model.n_layers, captured.cfg.decode_window
    mode, width = (True, True, False), captured._page_bucket_ladder()[0]
    bt = np.zeros((4, width), np.int32)
    bt[:, :2] = np.arange(1, 9).reshape(4, 2)
    args = (w, mode, np.asarray([3, 5, 0, 9], np.int32), bt,
            np.asarray([1, 2, 0, 6], np.int32),
            np.asarray([0.0, 1.0, 0.0, 0.5], np.float32),
            np.asarray([0, 4, 0, 0], np.int32))
    tag = ("decode", (w, mode, width))
    assert tag in captured._graphs
    deltas = []
    for eng in (captured, eager, captured):
        before = ragged_paged_attention.launches
        out, _ = eng._decode_window(*args)
        torch.cuda.synchronize()
        deltas.append((ragged_paged_attention.launches - before, out))
    assert [d for d, _ in deltas] == [n_layers * w] * 3
    assert all(np.array_equal(deltas[0][1], o) for _, o in deltas)
    cache = GraphCache(cuda)
    before = ragged_paged_attention.launches
    cache.run(("decode", "new"), lambda *t: captured._decode_body(w, mode,
                                                                  *t),
              list(args[2:]) + [captured._ctr()])
    # the first dispatch at a key runs the body once (its result) and
    # captures it: only the run launched
    assert ragged_paged_attention.launches - before == n_layers * w
    assert len(cache) == 1 and len(cache.capture_s) == 1


def _tenant_engines(cuda, **kw):
    """A captured (warmed up) and an eager LoRA-enabled paged engine on
    _bf16_engines' model, prefix cache off so a repeat recomputes."""
    from ray_tpu_torch.llm import PagedEngineConfig, PagedInferenceEngine
    from ray_tpu_torch.models import llama
    mc = llama.llama_tiny(vocab_size=300, dim=256, n_heads=4, n_kv_heads=2,
                          mlp_dim=512, max_seq_len=512, dtype=torch.bfloat16)
    params = llama.init(mc, seed=4, device=cuda)
    cfg = PagedEngineConfig(model=mc, **{
        **dict(max_batch_size=4, page_size=16, num_pages=96,
               max_pages_per_seq=32, chunk_size=32, decode_window=4,
               max_adapters=3, lora_rank=4), **kw})
    captured = PagedInferenceEngine(cfg, params, rng_seed=3, device=cuda)
    eager = PagedInferenceEngine(cfg, params, rng_seed=3, device=cuda)
    eager._eager = True
    captured.warmup()
    return mc, captured, eager


def test_captured_slot_reload_changes_the_next_replay(cuda):
    """load_adapter_slot after the programs are captured writes the table
    in place: the next replay serves the new adapter (the eager engine's
    tokens with it), not the one the programs were captured beside."""
    from ray_tpu_torch.llm import SamplingParams, lora
    mc, captured, eager = _tenant_engines(cuda, enable_prefix_caching=False)
    ptrs = {k: t.data_ptr() for k, t in captured.lora.tree.items()}
    ad_a = lora.random_adapter(1, mc, rank=4, alpha=64.0,
                               targets=("wq", "wv", "wo", "lm_head"))
    ad_b = lora.random_adapter(2, mc, rank=4, alpha=64.0,
                               targets=("wq", "wv", "wo", "lm_head"))
    prompt = [int(t) for t in np.random.RandomState(2).randint(0, 300, 40)]
    sp = SamplingParams(max_tokens=12, logprobs=1)

    def tenant(eng):
        req = eng.submit(prompt, sp, adapter_slot=1)
        eng.run_until_done([req])
        return req.out_ids, req.out_logps

    n_programs = len(captured._graphs)
    captured.load_adapter_slot(1, ad_a)
    first = tenant(captured)
    captured.load_adapter_slot(1, ad_b)
    eager.load_adapter_slot(1, ad_b)
    second = tenant(captured)
    assert {k: t.data_ptr() for k, t in captured.lora.tree.items()} == ptrs
    assert second == tenant(eager)
    assert second[0] != first[0]
    # the reload replayed programs: only logprob modes were captured new
    assert len(captured._graphs) - n_programs <= 2


def test_captured_import_writes_the_captured_pools(cuda):
    """import_prefill and import_prefix after capture copy pages into the
    pool tensors the programs were captured with: a captured decode
    engine gives the tokens of one engine serving the request whole."""
    from ray_tpu_torch.llm import SamplingParams
    _, captured, eager = _tenant_engines(cuda)
    ptrs = [(c["k"].data_ptr(), c["v"].data_ptr()) for c in captured.caches]
    prompt = [int(t) for t in np.random.RandomState(3).randint(0, 300, 77)]
    sp = SamplingParams(max_tokens=10)
    whole = eager.generate([prompt], sp)[0]["token_ids"]
    req = captured.import_prefill(eager.prefill_export(prompt, sp), sp)
    captured.run_until_done([req])
    assert captured._result(req)["token_ids"] == whole
    hashes = eager.hash_prompt(prompt)
    payload = eager.export_prefix(hashes)
    assert captured.import_prefix(payload) == 0      # already cached
    _, fresh, _ = _tenant_engines(cuda)
    assert fresh.import_prefix(payload) == len(hashes)
    back = fresh.export_prefix(hashes)
    for la, lb in zip(payload["pages"], back["pages"]):
        assert np.array_equal(la["k"], lb["k"])
    assert fresh.generate([prompt], sp)[0]["token_ids"] == whole
    assert [(c["k"].data_ptr(), c["v"].data_ptr())
            for c in captured.caches] == ptrs


# -- decode-only paged attention (split-KV) ---------------------------------

def _decode_case(dtype, d, groups, page, device, lengths, maxp, seed=0):
    """Disjoint live pages per row; table tails name an all-NaN page, and
    every slot past a row's length inside its last live page is NaN."""
    rng = np.random.RandomState(seed)
    kvh = 2
    lengths = np.asarray(lengths, np.int32)
    n_live = -(-lengths // page)
    P = int(n_live.sum()) + 2
    dead = P - 1
    ids = iter(rng.permutation(np.arange(1, P - 1)))
    bt = np.full((len(lengths), maxp), dead, np.int32)
    for r, n in enumerate(n_live):
        bt[r, :n] = [next(ids) for _ in range(n)]
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((len(lengths), kvh * groups, d), generator=g,
                    device=device).to(dtype)
    kp = torch.randn((P, page, kvh, d), generator=g, device=device).to(dtype)
    vp = torch.randn((P, page, kvh, d), generator=g, device=device).to(dtype)
    for t in (kp, vp):
        t[dead] = float("nan")
        for r, n in enumerate(lengths):
            if n % page:
                t[bt[r, n // page], n % page:] = float("nan")
    as_t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    return q, kp, vp, as_t(bt), as_t(lengths)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("groups,page", [(1, 8), (4, 8), (2, 16), (4, 16),
                                         (20, 16)])
@pytest.mark.parametrize("lengths,maxp", [
    ((0, 1, 16, 35, 128), 16),         # empty, one key, page edges, full
    ((1000, 3, 517), 130),             # long rows: many splits
    ((4096,), 520)])                   # one row: splits across the SMs
def test_paged_decode_kernel_matches_plain_and_ragged(cuda, dtype, d,
                                                      groups, page, lengths,
                                                      maxp):
    """B2 against its plain version and B1 at q_len 1 (both given the
    same lengths); NaN table tails and NaN tail slots never reach the
    output, and rows of length 0 are exactly 0. The kernel takes one
    query head per warp, four per row tile: groups 1 and 2 leave warps
    idle, groups 20 spans five row tiles."""
    args = _decode_case(dtype, d, groups, page, cuda, lengths, maxp)
    got = paged_decode_attention(*args)
    want = paged_decode_reference(*args)
    ragged = ragged_decode_attention(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == args[0].shape
    live = args[4] > 0
    assert torch.isfinite(got).all()
    assert not got[~live].any()
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **TOL[dtype])
    torch.testing.assert_close(got[live].float(), ragged[live].float(),
                               **TOL[dtype])


def test_paged_decode_launch_count(cuda):
    """One launch per call on CUDA tensors (both passes), none on CPU
    tensors."""
    args = _decode_case(torch.float32, 128, 4, 16, cuda, (5, 40), 4)
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args)
    assert paged_decode_attention.launches == before + 1
    cpu = paged_decode_attention(*(t.cpu() for t in args))
    assert paged_decode_attention.launches == before + 1
    torch.testing.assert_close(got.cpu(), cpu, atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", [4, 16, 64])
def test_paged_decode_kernel_is_batch_invariant(cuda, dtype, width):
    """A row called alone and inside batches of 1-8 other rows of random
    lengths (0 up to the table), at its own table width and at the widest
    (64 pages), gives the same bits: splits are runs of whole pages fixed
    by the page index, and the merge runs in split order. The row fills
    its table but for 3 keys."""
    page, kvh, groups, d, P = 16, 2, 4, 128, 700
    h = kvh * groups
    rng = np.random.RandomState(width)
    g = torch.Generator(device=cuda).manual_seed(width)
    kp = torch.randn((P, page, kvh, d), generator=g, device=cuda).to(dtype)
    vp = torch.randn((P, page, kvh, d), generator=g, device=cuda).to(dtype)
    length = width * page - 3
    q_row = torch.randn((1, h, d), generator=g, device=cuda).to(dtype)
    pages_row = rng.choice(np.arange(1, P), width, replace=False)

    def call(n_other, w, at):
        """The row at index ``at`` among n_other rows, tables w wide."""
        n = n_other + 1
        bt = np.zeros((n, w), np.int32)
        lengths = np.zeros(n, np.int32)
        q = torch.randn((n, h, d), generator=g, device=cuda).to(dtype)
        for r in range(n):
            if r == at:
                bt[r, :width] = pages_row
                lengths[r] = length
                q[r] = q_row[0]
                continue
            keys = int(rng.randint(0, w * page + 1))
            live = -(-keys // page)
            bt[r, :live] = rng.choice(np.arange(1, P), live)
            lengths[r] = keys
        as_t = lambda a: torch.as_tensor(a, device=cuda)   # noqa: E731
        out = paged_decode_attention(q, kp, vp, as_t(bt), as_t(lengths))
        return out[at]

    alone = call(0, width, 0)
    assert torch.isfinite(alone).all()
    for w in sorted({width, 64}):
        for n_other in range(1, 9):
            got = call(n_other, w, int(rng.randint(0, n_other + 1)))
            assert torch.equal(got, alone), (w, n_other)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_kernel_is_deterministic(cuda, dtype):
    """Two launches give the same bits, whichever block of a row arrives
    last to merge it, and so does a third after a launch on other rows
    (each call zeroes its own arrival counters)."""
    args = _decode_case(dtype, 128, 4, 16, cuda, (4096, 0, 1000, 3, 129),
                        260)
    other = _decode_case(dtype, 128, 4, 16, cuda, (17, 2000), 260, seed=5)
    a = paged_decode_attention(*args)
    b = paged_decode_attention(*args)
    paged_decode_attention(*other)
    c = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_graph_replay_beside_eager_launch(cuda, dtype):
    """B2 captured in a CUDA graph, replayed on one stream while an eager
    B2 on other inputs runs on a second stream, several times: each
    result equals, bit for bit, what its call gives alone. Each call owns
    its merge counters (the graph's come from its pool), so launches that
    overlap cannot count in each other's merge."""
    args_g = _decode_case(dtype, 128, 4, 16, cuda, (4096, 1000, 3, 2049),
                          260)
    args_e = _decode_case(dtype, 128, 4, 16, cuda, (4095, 129, 4096, 1, 700),
                          260, seed=7)
    want_g = paged_decode_attention(*args_g)
    want_e = paged_decode_attention(*args_e)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):   # warm up off the default stream
        paged_decode_attention(*args_g)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_g = paged_decode_attention(*args_g)
    s1, s2 = torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)
    for _ in range(8):
        out_g.zero_()
        s1.wait_stream(torch.cuda.current_stream(cuda))
        s2.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(s1):
            graph.replay()
        with torch.cuda.stream(s2):
            out_e = paged_decode_attention(*args_e)
        torch.cuda.synchronize()
        assert torch.equal(out_g, want_g)
        assert torch.equal(out_e, want_e)


def test_paged_decode_kernel_rejects_what_it_does_not_take(cuda):
    q, kp, vp, bt, ln = _decode_case(torch.float32, 64, 2, 8, cuda,
                                     (3, 9), 4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        paged_decode_attention(q.half(), kp.half(), vp.half(), bt, ln)
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention(q[..., :32].contiguous(),
                               kp[..., :32].contiguous(),
                               vp[..., :32].contiguous(), bt, ln)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                               kp, vp, bt, ln)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q, kp, vp, bt, ln.long())
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(kp.numel() + 1, device=cuda)
        paged_decode_attention(q, flat[1:].view(kp.shape), vp, bt, ln)
    with pytest.raises(ValueError, match="multiple of n_kv_heads"):
        paged_decode_attention(q[:, :3].contiguous(), kp, vp, bt, ln)
    with pytest.raises(ValueError, match="on cpu"):
        paged_decode_attention(q, kp, vp, bt.cpu(), ln)
    with pytest.raises(ValueError, match="match q's B"):
        paged_decode_attention(q, kp, vp, bt, ln[:1].contiguous())


def test_dense_engine_on_card_matches_engine_on_cpu(cuda):
    """The dense-slot engine (prefill through the flash forward kernel)
    on the card and on the CPU gives the same greedy tokens."""
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine, SamplingParams
    from ray_tpu_torch.models import llama
    mc = llama.llama_tiny(vocab_size=300, dim=256, n_heads=4, n_kv_heads=2,
                          mlp_dim=512, max_seq_len=512)
    params = llama.init(mc, seed=1, device="cpu")
    on_card = {k: ({n: t.to(cuda) for n, t in v.items()}
                   if isinstance(v, dict) else v.to(cuda))
               for k, v in params.items()}
    cfg = EngineConfig(model=mc, max_batch_size=2, max_seq_len=128)
    prompts = [[3, 4, 5], list(range(40, 90)), list(range(7, 30))]
    sp = SamplingParams(max_tokens=8)
    a = InferenceEngine(cfg, on_card, device=cuda).generate(prompts, sp)
    b = InferenceEngine(cfg, params, device="cpu").generate(prompts, sp)
    assert [x["token_ids"] for x in a] == [x["token_ids"] for x in b]


def test_llm_server_on_card_matches_server_on_cpu(cuda):
    """LLMServer over chip_smoke's phase-5 model (small, f32): requests
    sent one at a time give the same greedy tokens, responses and
    rtpu_llm_* counters on the card (the ragged kernel) as on the CPU
    (its plain version)."""
    from ray_tpu_torch.llm import LLMConfig, LLMServer, PagedEngineConfig
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.util import metrics
    mc = llama.llama_tiny(vocab_size=512, dim=256, n_heads=2, n_kv_heads=1,
                          mlp_dim=512, n_layers=2, max_seq_len=1024)
    params = llama.init(mc, seed=3, device="cpu")
    on_card = {k: ({n: t.to(cuda) for n, t in v.items()}
                   if isinstance(v, dict) else v.to(cuda))
               for k, v in params.items()}
    cfg = LLMConfig(engine=PagedEngineConfig(
        model=mc, max_batch_size=4, page_size=16, num_pages=128,
        max_pages_per_seq=32, chunk_size=32, decode_window=4))
    rng = np.random.RandomState(9)
    bodies = [{"prompt": [int(t) for t in rng.randint(0, 512, n)],
               "max_tokens": 12, "logprobs": 1} for n in (7, 40, 95, 150)]
    runs = []
    for device, p in ((cuda, on_card), ("cpu", params)):
        metrics._reset_registry()
        srv = LLMServer(cfg, params_ref=p, device=device)
        tokens, result = [], srv.engine._result

        def recording_result(req, result=result, tokens=tokens):
            tokens.append(list(req.out_ids))
            return result(req)
        srv.engine._result = recording_result
        try:
            resps = [srv.completions(dict(b)) for b in bodies]
            srv.check_health()
        finally:
            srv._stop = True
            srv._wake.set()
            srv._thread.join(timeout=60)
        counters = {n: r["series"] for n, r in metrics.local_store().items()
                    if r["kind"] == "counter"}
        runs.append((tokens, resps, counters))
    metrics._reset_registry()
    (tok_a, resp_a, cnt_a), (tok_b, resp_b, cnt_b) = runs
    assert tok_a == tok_b
    assert cnt_a == cnt_b and cnt_a["rtpu_llm_tokens_generated_total"]
    for a, b in zip(resp_a, resp_b):
        la = a["choices"][0].pop("logprobs")
        lb = b["choices"][0].pop("logprobs")
        assert a == b
        np.testing.assert_allclose(la["token_logprobs"], lb["token_logprobs"],
                                   atol=1e-4)


# -- flash attention (training path) ----------------------------------------

FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2 ** -8, 2 ** -7)}


def _flash_case(b, sq, sk, h, kvh, d, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(dtype)
            for s in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d),
                      (b, sq, h, d))]


def _assert_flash_close(got, want, tol):
    atol, rtol = tol
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    bound = atol * w.abs().max() + rtol * w.abs()
    assert ((g - w).abs() <= bound).all(), float((g - w).abs().max())


FLASH_LENGTHS = [
    # ragged lengths, no multiple of a tile
    (100, 100, True), (77, 140, False), (140, 77, True), (130, 130, False),
    # the bf16 dq/dkv tiles' edges: 16 rows per warp, 64-query dq blocks,
    # 64-key dkv blocks and dq key tiles, 32-query dkv tiles; 65 and 129
    # leave a last tile of one row. A query that sees a single key has
    # dq = dk = 0 exactly (p = 1, dp = delta), which both sides reproduce
    # only as rounding noise: Sq = 1 runs unmasked, and no case has Sk = 1.
    (1, 17, False), (1, 129, False), (15, 15, False), (16, 16, True),
    (17, 17, True), (63, 63, True), (64, 64, False), (65, 65, True),
    (129, 129, True),
    # causal with Sq < Sk, and with Sq > Sk (keys no query sees)
    (15, 65, True), (17, 129, True), (16, 64, True),
    (129, 63, True), (65, 16, True), (64, 15, True), (129, 17, False),
    # the f32 dkv kernel's tiles: 64-key blocks, 32-query tiles (31, 33:
    # one row short or over), Sq < Sk and Sq > Sk
    (31, 31, False), (32, 32, True), (33, 33, True), (31, 63, True),
    (33, 65, False), (63, 33, True), (65, 31, False), (97, 129, True),
    # the f32 forward and dq kernels' tiles: 64-query blocks, 64-key tiles
    # through a ring of two (three tiles and more wrap it), rows 16 apart
    # per thread; one row short of and over a tile, Sq < Sk and Sq > Sk
    (63, 127, True), (65, 193, False), (127, 65, True), (193, 191, True),
    (128, 256, False), (191, 129, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("sq,sk,causal", FLASH_LENGTHS)
def test_flash_kernels_match_plain_versions(cuda, dtype, d, groups, sq, sk,
                                            causal):
    """Forward (out, lse), dq and dkv on ragged lengths and on every tile
    edge of the bf16 tensor-core dq/dkv kernels and of the f32 forward,
    dq and dkv kernels, GQA 1 to 8, both head dims and dtypes."""
    q, k, v, dout = _flash_case(2, sq, sk, 2 * groups, 2, d, dtype, cuda)
    scale = d ** -0.5
    out, lse = flash_fwd_kernel(q, k, v, causal, scale)
    w_out, w_lse = flash_forward_reference(q, k, v, causal, scale)
    delta = delta_rows(out, dout)
    dq = flash_dq_kernel(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = flash_dkv_kernel(q, k, v, dout, lse, delta, causal, scale)
    w_dq, w_dk, w_dv = flash_backward_reference(q, k, v, out, lse, dout,
                                                causal, scale, 64)
    torch.cuda.synchronize()
    _assert_flash_close(lse, w_lse, FLASH_TOL[torch.float32])
    for got, want in ((out, w_out), (dq, w_dq), (dk, w_dk), (dv, w_dv)):
        assert got.dtype == dtype
        _assert_flash_close(got, want, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernels_are_deterministic(cuda, dtype):
    """Two launches of the forward, of dq and of dkv on the same inputs
    give bitwise-equal out, lse, dq, dk and dv: each output element is
    summed by one thread in a fixed order (no atomics)."""
    q, k, v, dout = _flash_case(2, 300, 300, 16, 4, 128, dtype, cuda, seed=3)
    scale = 128 ** -0.5
    out, lse = flash_fwd_kernel(q, k, v, True, scale)
    delta = delta_rows(out, dout)
    runs = [(*flash_fwd_kernel(q, k, v, True, scale),
             flash_dq_kernel(q, k, v, dout, lse, delta, True, scale),
             *flash_dkv_kernel(q, k, v, dout, lse, delta, True, scale))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_op_launches_each_kernel_once_per_call(cuda):
    """A forward and backward through flash_attention on CUDA tensors
    launches the forward, dq and dkv kernels once each; the same call
    on CPU tensors launches nothing and gives the same gradients."""
    q, k, v, dout = _flash_case(1, 70, 70, 4, 2, 64, torch.float32, cuda)
    counters = (flash_fwd_kernel, flash_dq_kernel, flash_dkv_kernel)
    before = [f.launches for f in counters]
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    (flash_attention(*ts, True) * dout).sum().backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    cpu = [x.cpu().requires_grad_() for x in (q, k, v)]
    (flash_attention(*cpu, True) * dout.cpu()).sum().backward()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    for a, b in zip(ts, cpu):
        _assert_flash_close(a.grad.cpu(), b.grad, (1e-5, 1e-4))


def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, dout = _flash_case(1, 40, 40, 4, 2, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_fwd_kernel(q.half(), k.half(), v.half(), True, 0.1)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd_kernel(q[..., :32].contiguous(), k[..., :32].contiguous(),
                         v[..., :32].contiguous(), True, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd_kernel(q.transpose(1, 2).contiguous().transpose(1, 2), k,
                         v, True, 0.1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(q.numel() + 1, device=cuda)
        flash_fwd_kernel(flat[1:].view(q.shape), k, v, True, 0.1)
    with pytest.raises(ValueError, match="multiple of n_kv_heads"):
        flash_fwd_kernel(q[:, :, :3].contiguous(), k, v, True, 0.1)
    with pytest.raises(ValueError, match="on cpu"):
        flash_fwd_kernel(q, k.cpu(), v, True, 0.1)
    out, lse = flash_fwd_kernel(q, k, v, True, 0.1)
    delta = delta_rows(out, dout)
    with pytest.raises(ValueError, match="lse"):
        flash_dq_kernel(q, k, v, dout, lse.transpose(1, 2), delta, True, 0.1)
    with pytest.raises(ValueError, match="dout"):
        flash_dkv_kernel(q, k, v, dout.bfloat16(), lse, delta, True, 0.1)
