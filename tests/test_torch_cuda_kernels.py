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
              seed=0):
    """Ragged rows on disjoint live pages; table tails name an all-NaN
    page and the slots past each row's live length in its last live page
    are NaN, so a kernel that reads past a row's keys gives NaN."""
    rng = np.random.RandomState(seed)
    kvh = 2
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
    leave later splits empty) at decode and verify widths; NaN table
    tails and NaN slots past each row's keys never reach the output."""
    starts = [4000 - q_width, 1000 - q_width, 517, 33, 0]
    q_lens = [q_width, q_width, q_width, q_width, 0]
    args = _rpa_case(dtype, d, q_width, 4, page, starts, q_lens, cuda,
                     seed=1)
    _assert_rpa_matches(args, dtype)


def test_ragged_kernel_split_count_two_to_eight(cuda):
    """A decode batch of 40 rows: 80 blocks on a 132-SM card gives 7
    splits, so each row's live pages are cut in 2 to 7 pieces."""
    from ray_tpu_torch.ops.ragged_paged_attention import num_splits
    rng = np.random.RandomState(5)
    lengths = rng.randint(300, 2000, 40)
    lengths[0] = 2000
    args = _rpa_case(torch.bfloat16, 128, 1, 4, 16, lengths - 1,
                     np.ones(40), cuda, seed=5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if sms == 132:
        assert num_splits(40, 1, 8, 2, args[3].shape[1], sms) == 7
    _assert_rpa_matches(args, torch.bfloat16)


def test_ragged_kernel_one_split_prefill(cuda):
    """9 rows x 2 kv heads x 8 tiles of 64 flat rows fill a 132-SM card:
    one split, pass 1 writes the output itself."""
    from ray_tpu_torch.ops.ragged_paged_attention import num_splits
    starts = [0, 37, 256, 0, 500, 16, 3, 130, 64]
    q_lens = [128, 128, 77, 0, 128, 1, 100, 128, 128]
    args = _rpa_case(torch.bfloat16, 128, 128, 4, 16, starts, q_lens, cuda,
                     seed=4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert num_splits(9, 128, 8, 2, args[3].shape[1], sms) == 1 or sms > 144
    _assert_rpa_matches(args, torch.bfloat16)


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
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("sq,sk,causal", FLASH_LENGTHS)
def test_flash_kernels_match_plain_versions(cuda, dtype, d, groups, sq, sk,
                                            causal):
    """Forward (out, lse), dq and dkv on ragged lengths and on every tile
    edge of the bf16 tensor-core dq/dkv kernels, GQA 1 to 8, both head
    dims and dtypes."""
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
    """Two launches of dq and of dkv on the same inputs give bitwise-equal
    dq, dk and dv: each output element is summed by one thread in a fixed
    order (no atomics)."""
    q, k, v, dout = _flash_case(2, 300, 300, 16, 4, 128, dtype, cuda, seed=3)
    scale = 128 ** -0.5
    out, lse = flash_fwd_kernel(q, k, v, True, scale)
    delta = delta_rows(out, dout)
    runs = [(flash_dq_kernel(q, k, v, dout, lse, delta, True, scale),
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
