"""Llama-family transformer, serving subset, in PyTorch (counterpart of
``ray_tpu/models/llama.py``).

Parameters are a plain dict of tensors in the reference layout: layer
weights stacked on a leading ``[n_layers, ...]`` axis, projections stored
``[in, out]`` and applied as ``x @ W``. Numerics follow the reference:
bf16 weights and activations at Llama widths, RMSNorm in f32 then cast
to ``x.dtype`` before the weight, half-split RoPE in f32, f32 logits.

Serving runs over a paged KV cache (``init_paged_cache``): one pool of
``[num_pages, page, KVH, D]`` K and V tensors per layer. Physical page 0
is a write SINK that no sequence owns: idle decode rows and pad pages
dump never-attended writes there. Every paged forward writes the step's
K/V into the pages IN PLACE (``index_put_`` on the persistent pool
tensors, where the reference donated its buffers) and only then runs
attention, which therefore reads pages only: ``ops.ragged_paged_attention``
(the Hopper kernel on CUDA tensors, its plain version on CPU tensors).

The paged forwards also serve a tensor-parallel mesh: given lists of
per-rank shards (params, pools, slot tables) instead of one device's,
they run the Megatron layout described in the tensor-parallel section
below; a one-shard list runs exactly the one-device ops.

Indices are not clamped: a block-table column or page id out of range
raises (on the CPU) or trips a device-side assert (on CUDA) instead of
being clamped into a live page. The engine's table-width rule keeps every
write inside the table, with columns past a row's allocation naming the
sink page.

Several writes of one scatter can land on the same sink slot (idle
decode rows, a chunk's pad pages). Which one wins is unordered on CUDA,
and a dense model never reads the sink from a real row. An MoE layer
does, indirectly: pad rows' tokens are routed beside the real ones and
take expert slots from them, so the sink content they read must be
deterministic. For MoE configs every duplicate of a scatter therefore
writes the value of its last row (``_last_writer``): the CPU's "last
write wins", on the card too, the same bits eager or captured.

Training runs ``apply`` (or ``apply_with_aux``) then
``cross_entropy_loss``: the same layers without a cache, attention
through ``ops.flash_attention`` (the Hopper forward, dq and dkv kernels
on CUDA tensors, the plain versions on CPU tensors), each layer under
``torch.utils.checkpoint`` when ``cfg.remat`` is set. With
``remat_policy="save_attn"`` a selective-checkpoint policy keeps the
flash op's outputs, so the backward recomputes the projections and MLP
but never replays the attention forward.

The dense-slot cached-decode forms serve the dense engine
(``llm/engine.py`` ``InferenceEngine``): ``init_slot_cache`` holds one
``[n_layers, max_batch, max_len, KVH, D]`` K and V tensor with a length
per slot; ``apply_with_kv`` (prefill, attention through
``ops.flash_attention``: the Hopper forward kernel on CUDA tensors)
returns every layer's K/V for seeding a slot; ``decode_batched`` advances
every slot by one token at its own length. ``init_kv_cache`` /
``apply_decode`` are the single-position form. Their writes go into the
cache tensors IN PLACE (the reference returned updated copies), and their
attention is a plain masked softmax over the whole cache, as in the
reference (no Pallas kernel there).

Mixture-of-experts configs (``moe_experts > 0``) replace each layer's
dense SwiGLU with ``_moe_ffn``, in every forward, as the reference does:
an f32 router, top-k experts per token with ties to the lower expert
index, and a GShard dispatch into ``C = max(1, int(capacity·k·T/E))``
slots per expert, where T counts every row of the call, padding
included (so a token's output depends on the rows it is dispatched
with, in the reference too). Dispatch, the three expert products over
``[E, C, ·]`` and the combine are static-shape tensor products with no
host sync, so the paged engine captures them like the rest of a layer.
``apply_with_aux`` returns the mean per-layer Switch load-balance loss;
the cached and paged forwards drop it. The batched multi-LoRA deltas of
the serving forwards are in the LoRA section below.
"""
from __future__ import annotations

import dataclasses
import math

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from ..ops.flash_attention import (
    FLASH_FWD_OP, flash_attention, mha_reference,
)
from ..ops.ragged_paged_attention import (
    ragged_decode_attention, ragged_paged_attention,
)
from ..parallel.sharding import tp_all_reduce


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # training knobs, read by apply: remat checkpoints each layer;
    # "full" recomputes everything in the backward, "save_attn" keeps the
    # flash op's out and lse so attention's forward is not replayed;
    # use_flash=False runs mha_reference instead of flash_attention;
    # attn_block_q/k reach flash_attention (where only the plain
    # backward reads block_k). The serving forwards do not read them.
    remat: bool = True
    remat_policy: str = "save_attn"
    use_flash: bool = True
    attn_block_q: int = 512
    attn_block_k: int = 512
    # mixture-of-experts (0 = dense MLP): experts per layer, experts per
    # token, slots per expert = moe_capacity * k * T / E, and the weight
    # of the load-balance aux loss in a training loss
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity: float = 2.0
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def flops_per_token(self, seq_len: int | None = None) -> float:
        """Approximate training FLOPs/token (fwd+bwd ~ 6*params +
        attention), as the reference counts them."""
        attn = 12 * self.n_layers * self.dim * (seq_len or self.max_seq_len)
        return 6 * self.num_params() + attn

    def num_params(self) -> int:
        d, v = self.dim, self.vocab_size
        if self.moe_experts:
            mlp = (3 * d * self.mlp_dim * self.moe_experts
                   + d * self.moe_experts)                           # + router
        else:
            mlp = 3 * d * self.mlp_dim
        per_layer = (
            d * d + 2 * d * self.n_kv_heads * self.head_dim + d * d  # qkvo
            + mlp                                                    # (swi)glu
            + 2 * d)                                                 # norms
        return v * d + self.n_layers * per_layer + d + d * v


def llama3_8b(**kw) -> LlamaConfig:
    """Llama-3-8B widths (the reference's flagship preset)."""
    return LlamaConfig(**kw)


def llama_tiny(**kw) -> LlamaConfig:
    """CI-scale config: same topology, toy sizes, float32."""
    defaults = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, mlp_dim=128, max_seq_len=128,
                    dtype=torch.float32, remat=False)
    defaults.update(kw)
    return LlamaConfig(**defaults)


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; raises when CUDA is asked for
    and absent (the port never moves to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: ray_tpu_torch runs on the card by "
            "default; pass device='cpu' for the plain PyTorch versions")
    return dev


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def param_shapes(cfg: LlamaConfig) -> dict:
    """Shape of every parameter, in the reference layout (MoE configs:
    ``w_router [L, d, E]`` and the expert weights ``[L, E, ...]``)."""
    d, hd, L, F = cfg.dim, cfg.head_dim, cfg.n_layers, cfg.mlp_dim
    kvd = cfg.n_kv_heads * hd
    if cfg.moe_experts:
        E = cfg.moe_experts
        mlp = {"mlp_norm": (L, d), "w_router": (L, d, E),
               "w_gate": (L, E, d, F), "w_up": (L, E, d, F),
               "w_down": (L, E, F, d)}
    else:
        mlp = {"mlp_norm": (L, d), "w_gate": (L, d, F), "w_up": (L, d, F),
               "w_down": (L, F, d)}
    return {
        "embed": (cfg.vocab_size, d),
        "layers": {
            "attn_norm": (L, d),
            "wq": (L, d, cfg.n_heads * hd),
            "wk": (L, d, kvd),
            "wv": (L, d, kvd),
            "wo": (L, cfg.n_heads * hd, d),
            **mlp,
        },
        "final_norm": (d,),
        "lm_head": (d, cfg.vocab_size),
    }


def logical_axes(cfg: LlamaConfig) -> dict:
    """Logical sharding axes per parameter (leading None = the stacked
    layer dim), the reference's: heads, kv_heads and mlp over tp, vocab
    rows over (tp, fsdp), norms and the MoE router replicated. Resolved
    against a mesh by ``parallel.sharding``."""
    if cfg.moe_experts:
        mlp = {
            "mlp_norm": (None, "norm"),
            "w_router": (None, "embed", None),
            "w_gate": (None, "expert", "embed", "mlp"),
            "w_up": (None, "expert", "embed", "mlp"),
            "w_down": (None, "expert", "mlp", "embed"),
        }
    else:
        mlp = {
            "mlp_norm": (None, "norm"),
            "w_gate": (None, "embed", "mlp"),
            "w_up": (None, "embed", "mlp"),
            "w_down": (None, "mlp", "embed"),
        }
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": (None, "norm"),
            "wq": (None, "embed", "heads"),
            "wk": (None, "embed", "heads"),
            "wv": (None, "embed", "heads"),
            "wo": (None, "heads", "embed"),
            **mlp,
        },
        "final_norm": ("norm",),
        "lm_head": ("embed", "vocab"),
    }


def param_dtype(cfg: LlamaConfig, name: str) -> torch.dtype:
    """A parameter's dtype: cfg.dtype, except the MoE router, which is
    f32 in every config (as in the reference)."""
    return torch.float32 if name == "w_router" else cfg.dtype


def init(cfg: LlamaConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from ``seed`` (a torch.Generator on ``device``):
    norms 1, weights N(0, 1/fan_in) drawn in f32 and cast to their dtype
    (``param_dtype``), one layer slice at a time so the f32 draw never
    holds a whole stacked tensor (an MoE slice holds every expert of the
    layer). Not the reference's jax.random stream; tests that compare
    with the reference convert its weights (models/convert.py)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    shapes = param_shapes(cfg)
    fan_in = {"embed": cfg.dim, "wq": cfg.dim, "wk": cfg.dim, "wv": cfg.dim,
              "wo": cfg.dim, "w_router": cfg.dim, "w_gate": cfg.dim,
              "w_up": cfg.dim, "w_down": cfg.mlp_dim, "lm_head": cfg.dim}

    def make(name, shape, stacked):
        if name.endswith("norm"):
            return torch.ones(shape, dtype=cfg.dtype, device=dev)
        out = torch.empty(shape, dtype=param_dtype(cfg, name), device=dev)
        std = 1.0 / math.sqrt(fan_in[name])
        for part in (out.unbind(0) if stacked else (out,)):
            part.copy_(torch.randn(part.shape, generator=g, device=dev,
                                   dtype=torch.float32) * std)
        return out

    return {
        "embed": make("embed", shapes["embed"], False),
        "layers": {n: make(n, s, True) for n, s in shapes["layers"].items()},
        "final_norm": make("final_norm", shapes["final_norm"], False),
        "lm_head": make("lm_head", shapes["lm_head"], False),
    }


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_freqs(cfg: LlamaConfig, positions):
    """positions [B, S] int -> (cos, sin) each [B, S, head_dim/2], f32."""
    exps = torch.arange(0, cfg.head_dim, 2, dtype=torch.float32,
                        device=positions.device) / cfg.head_dim
    # theta filled on the device: a host tensor copied in would be a
    # transfer that a CUDA graph capture refuses
    inv = 1.0 / torch.pow(torch.full_like(exps, cfg.rope_theta), exps)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [B, S, H, D]; half-split rotation (first half with second)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _qkv(h, p, cfg: LlamaConfig, cos, sin, lora=None, slots=None):
    """Projections + RoPE. h [B, S, dim] -> q [B,S,H,D], k/v [B,S,KVH,D].

    ``lora``/``slots``: one layer of the adapter slot table
    (``_lora_at_layer``) and the rows' slot ids — the batched multi-LoRA
    serving path adds scale·(h@A[slot])@B[slot] to each projection.
    None (training, base serving) leaves the math untouched."""
    b, s, _ = h.shape
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if lora is not None:
        q = _lora_add(q, h, lora, "wq", slots)
        k = _lora_add(k, h, lora, "wk", slots)
        v = _lora_add(v, h, lora, "wv", slots)
    # head counts from the weights: a tp shard holds H/tp and KVH/tp
    q = q.reshape(b, s, -1, cfg.head_dim)
    k = k.reshape(b, s, -1, cfg.head_dim)
    v = v.reshape(b, s, -1, cfg.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


# ---------------------------------------------------------------------------
# Batched multi-LoRA (llm/multilora): slot-table deltas on the serving paths
# ---------------------------------------------------------------------------
# The slot table (llm/multilora/slots.py) is a dict of fixed-shape f32
# tensors:
#   "<t>.A" [S, L, in_t, R]  "<t>.B" [S, L, R, out_t]   t in wq/wk/wv/wo
#   "lm_head.A" [S, d, R]    "lm_head.B" [S, R, V]
#   "scale" [S] (alpha/rank per slot; slot 0 = base, all-zero A/B)
# so a dispatch's shapes do not depend on which tenants are in its batch;
# per-row slot ids (device tensors, gathered with index_select: no host
# sync, so a captured program reads them like any input) select each
# row's adapter. Slot 0, rank padding and absent targets add an exact
# zero.

_LORA_LAYER_TARGETS = ("wq", "wk", "wv", "wo")


def _lora_at_layer(lora, layer: int):
    """The [S, L, ...] layer-stacked tables at one layer (views)."""
    if lora is None:
        return None
    out = {"scale": lora["scale"]}
    for t in _LORA_LAYER_TARGETS:
        a = lora.get(f"{t}.A")
        if a is not None:
            out[f"{t}.A"] = a[:, layer]
            out[f"{t}.B"] = lora[f"{t}.B"][:, layer]
    return out


def _lora_add(y, x, lora, target: str, slots):
    """y + scale[slot]·(x @ A[slot]) @ B[slot] for one projection.

    x [..., in]; ``slots`` is a scalar (one row's chunk or verify window:
    every position shares the row's adapter) or [B] with x [B, S, in]
    (batched decode: two batched products). The low-rank math runs in
    f32 — as ``lora.merge`` merges in f32 before casting — and the delta
    is cast back to y's dtype. Absent targets return y unchanged."""
    a = lora.get(f"{target}.A")
    if a is None:
        return y
    b = lora[f"{target}.B"]
    slots = torch.as_tensor(slots, device=x.device)
    xf = x.float()
    if slots.dim() == 0:
        idx = slots.reshape(1)
        d = (xf @ a.index_select(0, idx)[0]) @ b.index_select(0, idx)[0]
        d = d * lora["scale"].index_select(0, idx)
    else:
        d = torch.bmm(torch.bmm(xf, a.index_select(0, slots)),
                      b.index_select(0, slots))
        d = d * lora["scale"].index_select(0, slots)[:, None, None]
    return y + d.to(y.dtype)


def _mlp_block(x, p, cfg: LlamaConfig):
    """Post-attention MLP with residual: dense SwiGLU, or top-k MoE when
    cfg.moe_experts > 0. Returns (x, aux): the layer's MoE load-balance
    loss, None for a dense MLP (the reference's 0.0, without a kernel
    per layer to make it)."""
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    if cfg.moe_experts:
        y, aux = _moe_ffn(h, p, cfg)
        return x + y, aux
    gate = F.silu(h @ p["w_gate"])
    return x + (gate * (h @ p["w_up"])) @ p["w_down"], None


def _moe_ffn(h, p, cfg: LlamaConfig, f32_out: bool = False):
    """Top-k expert SwiGLU over capacity-bounded slots, GShard-style
    (the reference's ``_moe_ffn``). h [B, S, D] -> (out [B, S, D], aux).

    Router logits and softmax in f32; each token's k best experts, ties
    to the lower index (a stable descending sort: ``jax.lax.top_k``'s
    order; ``torch.topk`` promises none), gates renormalised over the k.
    Switch aux loss E·Σ(mean prob · first-choice fraction). Slots: choice
    j of token t takes the next free slot of its expert in flat token
    order, after every slot of choices < j; past C it is dropped. The
    dispatch mask (h's dtype) gathers [E, C, D], three batched products
    make the experts' SwiGLU, and the combine weights (f32 gates, cast
    to the experts' dtype, as the reference casts them) scatter back.
    One-hots compare against an ``arange``: no host sync anywhere.
    ``f32_out``: the combine's product comes out in f32 (a tp rank's
    partial sum, ``_paged_layers_tp``)."""
    b, s, d = h.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    T = b * s
    C = max(1, int(cfg.moe_capacity * k * T / E))
    ht = h.reshape(T, d)
    dev = h.device

    probs = torch.softmax(ht.float() @ p["w_router"], dim=-1)   # [T, E]
    idx_k = torch.sort(probs, dim=-1, descending=True,
                       stable=True).indices[:, :k]              # [T, k]
    gate_k = probs.gather(1, idx_k)
    gate_k = gate_k / gate_k.sum(dim=-1, keepdim=True).clamp(min=1e-9)

    experts = torch.arange(E, device=dev)
    first = (idx_k[:, :1] == experts).float()                   # [T, E]
    aux = E * torch.sum(probs.mean(dim=0) * first.mean(dim=0))

    slots = torch.arange(C, device=dev)
    combine = torch.zeros((T, E, C), dtype=torch.float32, device=dev)
    prev_counts = torch.zeros((E,), dtype=torch.int64, device=dev)
    for j in range(k):                                          # k is tiny
        oh = (idx_k[:, j:j + 1] == experts).long()              # [T, E]
        pos = torch.cumsum(oh, dim=0) - 1 + prev_counts         # [T, E]
        prev_counts = prev_counts + oh.sum(dim=0)
        in_cap = (pos < C) & (oh > 0)                           # [T, E]
        slot = (pos.clamp(0, C - 1)[..., None] == slots).float()  # [T,E,C]
        combine = combine + (gate_k[:, j, None, None]
                             * in_cap[..., None] * slot)
    dispatch = (combine > 0).to(h.dtype).reshape(T, E * C)

    xe = (dispatch.t() @ ht).reshape(E, C, d)                   # [E, C, D]
    ge = F.silu(torch.bmm(xe, p["w_gate"]))
    ue = torch.bmm(xe, p["w_up"])
    ye = torch.bmm(ge * ue, p["w_down"])                        # [E, C, D]
    mm = _logits if f32_out else torch.matmul
    out = mm(combine.to(ye.dtype).reshape(T, E * C), ye.reshape(E * C, d))
    return out.reshape(b, s, d), aux


class _F32Logits(torch.autograd.Function):
    """x2 [N, dim] @ w [dim, V] with f32 output from low-precision inputs
    on the card, differentiable. Forward: one cuBLAS call with f32
    accumulation and f32 output. Backward: the f32 gradient rounded to
    w's dtype, then two low-precision products (x's gradient and w's in
    their own dtype, as the reference's bf16 parameters get them)."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(w.dtype)
        return g @ w.t(), x2.t() @ g


def _logits(x, lm_head):
    """x [..., dim] @ lm_head [dim, V] -> f32 logits [..., V].

    On the card a bf16 head goes through one cuBLAS call with f32
    accumulation AND f32 output (``torch.mm(..., out_dtype=float32)``),
    so no f32 copy of the [dim, V] matrix is made per step. The CPU path
    (tests) upcasts."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype == torch.float32 and lm_head.dtype == torch.float32:
        out = x2 @ lm_head
    elif x2.is_cuda:
        out = _F32Logits.apply(x2, lm_head)
    else:
        out = x2.float() @ lm_head.float()
    return out.reshape(*lead, out.shape[-1])


def _layer_params(params: dict, layer: int) -> dict:
    return {k: v[layer] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# Training forward (no cache)
# ---------------------------------------------------------------------------

def _attention(q, k, v, cfg: LlamaConfig, causal: bool, attn_impl):
    if attn_impl is not None:
        return attn_impl(q, k, v)
    if cfg.use_flash:
        return flash_attention(q, k, v, causal, None, cfg.attn_block_q,
                               cfg.attn_block_k)
    return mha_reference(q, k, v, causal=causal)


def _layer(x, p: dict, cfg: LlamaConfig, cos, sin, attn_impl):
    """One transformer block in training mode (no KV cache). x [B,S,dim]
    -> (x, the layer's MoE aux loss or None)."""
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    b, s, _ = h.shape
    q, k, v = _qkv(h, p, cfg, cos, sin)
    attn = _attention(q, k, v, cfg, causal=True, attn_impl=attn_impl)
    x = x + attn.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return _mlp_block(x, p, cfg)


def _save_flash_outputs(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``save_attn``: keep what the flash
    op returns (out, lse), recompute everything else."""
    if op == FLASH_FWD_OP:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kwargs(cfg: LlamaConfig) -> dict:
    kw = {"use_reentrant": False}
    if cfg.remat_policy == "save_attn":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_flash_outputs)
    return kw


def apply(params: dict, tokens, cfg: LlamaConfig, attn_impl=None):
    """Training/prefill forward: tokens [B, S] int -> logits [B, S, V] f32.

    ``attn_impl(q, k, v)`` overrides attention. Runs on the device of
    ``params`` (the card, for params made with the default device)."""
    return apply_with_aux(params, tokens, cfg, attn_impl)[0]


def apply_with_aux(params: dict, tokens, cfg: LlamaConfig, attn_impl=None):
    """(logits, aux): aux is the mean per-layer MoE load-balance loss
    (0.0 for dense configs); add cfg.moe_aux_weight * aux to the loss."""
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    cos, sin = rope_freqs(cfg, positions.expand(tokens.shape))
    # one unbind per stacked weight: its backward stacks the per-layer
    # gradients once, instead of a full-size zero tensor per layer
    names = list(params["layers"])
    per_layer = [params["layers"][n].unbind(0) for n in names]
    remat = _remat_kwargs(cfg) if cfg.remat else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(cfg.n_layers):
        p = {n: w[layer] for n, w in zip(names, per_layer)}
        if remat is None:
            x, a = _layer(x, p, cfg, cos, sin, attn_impl)
        else:
            x, a = checkpoint(_layer, x, p, cfg, cos, sin, attn_impl,
                              **remat)
        if a is not None:
            aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x, params["lm_head"]), aux / cfg.n_layers


def cross_entropy_loss(logits, targets, mask=None):
    """Mean next-token NLL. logits [B,S,V] f32, targets [B,S] int."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


# ---------------------------------------------------------------------------
# Paged KV cache (block tables; used by the paged serving engine)
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: LlamaConfig, num_pages: int, page_size: int,
                     device="cuda") -> list[dict]:
    """Per-layer page pools: [{'k','v': [P, page, KVH, D]}] * n_layers,
    zero-filled. Separate per-layer tensors (not one stacked tensor), each
    written in place by the forwards and read by the attention kernel
    directly. Page 0 is the write sink (module docstring)."""
    dev = resolve_device(device)
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
            for _ in range(cfg.n_layers)]


def _as_i32(x, device):
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def _last_writer(flat_idx, cfg: LlamaConfig):
    """For MoE configs, row i of a scatter -> the last row writing the
    same slot (``flat_idx`` [N], one slot id per row): rows then write
    ``values.index_select(0, src)``, so duplicates carry equal values
    and no write order can change the result (module docstring). None
    for dense configs, which never read what a duplicate wrote."""
    if not cfg.moe_experts:
        return None
    rows = torch.arange(flat_idx.shape[0], device=flat_idx.device)
    same = flat_idx[:, None] == flat_idx[None, :]
    return torch.where(same, rows[None, :], -1).amax(dim=1)


def _rows_from(values, src):
    return values if src is None else values.index_select(0, src)


def _on(dev, *ts):
    """``ts`` on ``dev`` (a no-op for tensors already there; None stays)."""
    return tuple(None if t is None else t.to(dev) for t in ts)


def decode_paged(params: dict, tokens, caches: list[dict], block_tables,
                 lengths, cfg: LlamaConfig, *, page_size: int, lora=None,
                 slots=None):
    """One decode step over paged caches.

    tokens [B, 1]; block_tables [B, max_pages] int32; lengths [B] int32 =
    tokens already WRITTEN (the current token goes at position
    ``lengths``). Returns (logits [B, V] f32, caches) — the caches are
    updated in place and returned for the reference's calling shape.
    Inactive rows: pass length 0 with a zeroed table row and mask the
    output; their writes land in sink page 0.

    ``lora``/``slots`` [B]: batched multi-LoRA — each row's projections
    (and logits, for lm_head adapters) get its slot's low-rank delta
    (``_lora_add``). ``params``/``caches``/``lora`` may be tp shards
    (tensor-parallel section)."""
    params, caches, lora = _as_shards(params, caches, lora)
    b = tokens.shape[0]
    dev = tokens.device
    lengths = _as_i32(lengths, dev)
    rows = torch.arange(b, device=dev)
    x = _embed(params, tokens, cfg)                           # [B, 1, D]
    cos, sin = rope_freqs(cfg, lengths[:, None])
    page_ids = block_tables[rows, lengths // page_size]       # [B]
    offsets = lengths % page_size
    src = _last_writer(page_ids * page_size + offsets, cfg)
    attend_len = lengths + 1

    def attend(cache, q, k, v):
        pid, off, at, bt, sw = _on(q.device, page_ids, offsets, attend_len,
                                   block_tables, src)
        cache["k"][pid, off] = _rows_from(k[:, 0], sw).to(cache["k"].dtype)
        cache["v"][pid, off] = _rows_from(v[:, 0], sw).to(cache["v"].dtype)
        attn = ragged_decode_attention(q[:, 0], cache["k"], cache["v"], bt,
                                       at)
        return attn.reshape(b, 1, -1)

    x = _paged_layers(params, x, caches, cfg, cos, sin, lora, slots, attend)
    x = rms_norm(x, _first(params)["final_norm"], cfg.norm_eps)
    return _vocab_parallel(_lm_head, x, params, lora, slots)[:, 0], caches


def _out_proj(proj, p, lora, slots):
    """proj @ wo, plus the wo adapter delta on the LoRA path."""
    y = proj @ p["wo"]
    if lora is not None:
        y = _lora_add(y, proj, lora, "wo", slots)
    return y


def _lm_head(x, params, lora, slots):
    """f32 logits of x, plus the lm_head adapter delta on the LoRA
    path."""
    logits = _logits(x, params["lm_head"])
    if lora is not None and "lm_head.A" in lora:
        logits = _lora_add(logits, x, lora, "lm_head", slots)
    return logits


def _head_rows(last, params, lora, slots):
    """f32 logits of prefill rows' last hidden states [R, dim]; each
    row's lm_head adapter delta on that row alone, so a row's logits do
    not depend on how many rows its dispatch carries."""
    logits = _logits(last, params["lm_head"])
    if lora is not None and "lm_head.A" in lora:
        logits = torch.stack([
            _lora_add(logits[i], last[i], lora, "lm_head", slots[i])
            for i in range(last.shape[0])])
    return logits


def _paged_layers(params, x, caches, cfg: LlamaConfig, cos, sin, lora,
                  slots, attend):
    """The transformer blocks of a paged forward. ``attend(cache, q, k,
    v)`` writes the step's K/V into one layer's pages and returns
    attention's output [B, S, heads*D] in cfg.dtype. One device's params
    here; tp shards go to ``_paged_layers_tp``."""
    if _is_tp(params):
        return _paged_layers_tp(params, x, caches, cfg, cos, sin, lora,
                                slots, attend)
    for layer in range(cfg.n_layers):
        p = _layer_params(params, layer)
        ll = _lora_at_layer(lora, layer)
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(h, p, cfg, cos, sin, ll, slots)
        x = x + _out_proj(attend(caches[layer], q, k, v), p, ll, slots)
        x, _ = _mlp_block(x, p, cfg)
    return x


def _prefill_chunk_hidden(params, chunk, caches, block_table_row, start_pos,
                          cfg: LlamaConfig, page_size: int, true_chunk_len,
                          lora=None, slot=None):
    """prefill_paged_chunk up to the final norm: returns hidden [C, dim]."""
    c = chunk.shape[1]
    dev = chunk.device
    n_chunk_pages = c // page_size
    max_pages = block_table_row.shape[0]
    start_pos = _as_i32(start_pos, dev).reshape(())
    tl = _as_i32(c if true_chunk_len is None else true_chunk_len,
                 dev).reshape(())
    positions = start_pos + torch.arange(c, device=dev)[None, :]   # [1, C]
    cos, sin = rope_freqs(cfg, positions)
    scale = cfg.head_dim ** -0.5
    # pages past the chunk's real tokens, or past the table, go to the
    # sink page; the gather index is clipped only to stay in range — its
    # value is discarded wherever it was clipped
    idx = torch.arange(n_chunk_pages, device=dev)
    logical = start_pos // page_size + idx
    valid_pages = (tl + page_size - 1) // page_size
    valid = (idx < valid_pages) & (logical < max_pages)
    chunk_page_ids = torch.where(
        valid, block_table_row[logical.clamp(0, max_pages - 1)], 0)
    src = _last_writer(chunk_page_ids, cfg)
    starts1 = start_pos.reshape(1)
    qlens1 = tl.reshape(1)
    bt1 = block_table_row[None]

    def attend(cache, q, k, v):
        pid, sw, bt, st, ql = _on(q.device, chunk_page_ids, src, bt1,
                                  starts1, qlens1)
        shape = (n_chunk_pages, page_size) + tuple(k.shape[2:])
        cache["k"][pid] = _rows_from(k[0].reshape(shape), sw).to(
            cache["k"].dtype)
        cache["v"][pid] = _rows_from(v[0].reshape(shape), sw).to(
            cache["v"].dtype)
        # the writes above already placed the window's K/V: attention
        # reads pages only (prefix + causal window in one predicate)
        attn = ragged_paged_attention(q, cache["k"], cache["v"], bt, st, ql,
                                      scale=scale)
        return attn.to(cfg.dtype).reshape(1, c, -1)

    x = _embed(params, chunk, cfg)                            # [1, C, D]
    x = _paged_layers(params, x, caches, cfg, cos, sin, lora, slot, attend)
    return rms_norm(x, _first(params)["final_norm"], cfg.norm_eps)[0]


def prefill_paged_chunk(params: dict, chunk, caches: list[dict],
                        block_table_row, start_pos, cfg: LlamaConfig, *,
                        page_size: int, true_chunk_len=None, lora=None,
                        slot=None):
    """Prefill ONE page-aligned chunk of one sequence.

    chunk [1, C] (C a multiple of page_size, right-padded); block_table_row
    [max_pages] int32; start_pos = tokens already prefilled (page-aligned);
    true_chunk_len = real tokens in this chunk (default C). Writes the
    chunk's K/V into its pages (pad pages and pages past the table go to
    sink page 0), attends the paged prefix plus the chunk causally, and
    returns (logits [C, V] f32, caches). ``lora``/``slot`` (a scalar):
    the chunk's adapter, as in ``decode_paged``."""
    params, caches, lora = _as_shards(params, caches, lora)
    hidden = _prefill_chunk_hidden(params, chunk, caches, block_table_row,
                                   start_pos, cfg, page_size, true_chunk_len,
                                   lora, slot)
    return _vocab_parallel(_lm_head, hidden, params, lora, slot), caches


def prefill_paged_rows(params: dict, chunks, caches: list[dict], bt_rows,
                       start_pos, true_lens, cfg: LlamaConfig, *,
                       page_size: int, lora=None, slots=None):
    """Prefill R chunk-rows in order: chunks [R, C], bt_rows [R, max_pages],
    start_pos/true_lens [R]. Rows run one after another in a Python loop,
    so row i+1 sees row i's page writes (consecutive rows may be
    consecutive chunks of one sequence). Rows with true_lens == 0 are
    padding (all writes to the sink page). Returns (last_logits [R, V] f32
    — each row's logits at its last real token — and caches). Only that
    one position goes through the lm_head. ``lora``/``slots`` [R]: each
    row's adapter, as in ``decode_paged``; the row's lm_head delta is
    taken on that row alone, so a row's logits do not depend on how many
    rows its dispatch carries."""
    params, caches, lora = _as_shards(params, caches, lora)
    c = chunks.shape[1]
    dev = chunks.device
    true_lens = _as_i32(true_lens, dev)
    start_pos = _as_i32(start_pos, dev)
    if lora is not None and slots is None:
        slots = torch.zeros((chunks.shape[0],), dtype=torch.int32,
                            device=dev)
    last = []
    for i in range(chunks.shape[0]):
        hidden = _prefill_chunk_hidden(
            params, chunks[i:i + 1], caches, bt_rows[i], start_pos[i], cfg,
            page_size, true_lens[i], lora, None if lora is None else slots[i])
        # index_select with a device index: no host round trip per row
        last.append(hidden.index_select(
            0, (true_lens[i] - 1).clamp(0, c - 1).reshape(1))[0])
    return _vocab_parallel(_head_rows, torch.stack(last), params, lora,
                           slots), caches


def verify_paged_rows(params: dict, tokens, caches: list[dict], bt_rows,
                      starts, cfg: LlamaConfig, *, page_size: int,
                      lora=None, slots=None):
    """Speculative-verification forward: for each of R rows feed
    S1 = 1 + n_draft tokens at positions starts[r] .. starts[r]+S1-1,
    writing their K/V in place, and return (logits [R, S1, V] f32,
    caches). Positions past the block table write to sink page 0 (their
    logits are garbage the engine discards). Rows run in order, like
    prefill_paged_rows; ``lora``/``slots`` [R] as there."""
    params, caches, lora = _as_shards(params, caches, lora)
    dev = tokens.device
    maxp = bt_rows.shape[1]
    s1 = tokens.shape[1]
    scale = cfg.head_dim ** -0.5
    starts = _as_i32(starts, dev)
    qlens1 = torch.full((1,), s1, dtype=torch.int32, device=dev)
    if lora is not None and slots is None:
        slots = torch.zeros((tokens.shape[0],), dtype=torch.int32,
                            device=dev)
    out = []
    for i in range(tokens.shape[0]):
        bt = bt_rows[i]
        start = starts[i]
        sl = None if lora is None else slots[i]
        positions = start + torch.arange(s1, device=dev)           # [S1]
        cos, sin = rope_freqs(cfg, positions[None])
        pidx = positions // page_size
        page_ids = torch.where(pidx < maxp, bt[pidx.clamp(0, maxp - 1)], 0)
        offsets = positions % page_size
        src = _last_writer(page_ids * page_size + offsets, cfg)

        def attend(cache, q, k, v, page_ids=page_ids, offsets=offsets,
                   src=src, bt=bt, start=start):
            pid, off, sw, b1, st, ql = _on(q.device, page_ids, offsets, src,
                                           bt[None], start.reshape(1), qlens1)
            cache["k"][pid, off] = _rows_from(k[0], sw).to(cache["k"].dtype)
            cache["v"][pid, off] = _rows_from(v[0], sw).to(cache["v"].dtype)
            attn = ragged_paged_attention(q, cache["k"], cache["v"], b1, st,
                                          ql, scale=scale)
            return attn.to(cfg.dtype).reshape(1, s1, -1)

        x = _embed(params, tokens[i], cfg)[None]                   # [1,S1,D]
        x = _paged_layers(params, x, caches, cfg, cos, sin, lora, sl, attend)
        x = rms_norm(x, _first(params)["final_norm"], cfg.norm_eps)
        out.append(_vocab_parallel(_lm_head, x, params, lora, sl)[0])
    return torch.stack(out), caches


# ---------------------------------------------------------------------------
# Tensor-parallel paged forwards
# ---------------------------------------------------------------------------
# The paged forwards take one device's params, caches and slot table, or
# lists of the per-tp-rank shards of each (``parallel.sharding``: params
# cut by ``logical_axes``, the KV pools over kv_heads, the slot table by
# its own ``logical_axes``). A one-shard list runs exactly the one-device
# ops. With more, the Megatron layout: every rank runs the layer code at
# its own head counts (H/tp, KVH/tp) and mlp columns (mlp/tp; an MoE rank
# keeps every expert at mlp/tp columns) on its shards. The row-parallel
# products — wo with its adapter delta, w_down (or the MoE combine) —
# leave f32 partial sums that ``tp_all_reduce`` adds before the
# residual's cast. The embedding is a masked lookup of each rank's vocab
# rows, summed (one rank holds each token: the sum is exact); the
# lm_head gives each rank's f32 logit columns, concatenated, so sampling
# sees the whole row. Norms, RoPE and the MoE router are replicated; the
# activations between layers are too (one tensor per rank's device).

def _is_tp(params) -> bool:
    return isinstance(params, (list, tuple))


def _first(params) -> dict:
    return params[0] if _is_tp(params) else params


def _as_shards(params, caches, lora):
    """One-shard lists unwrapped to one device's (the exact one-device
    ops); anything else as given."""
    if _is_tp(params) and len(params) == 1:
        return params[0], caches[0], None if lora is None else lora[0]
    return params, caches, lora


def _embed(params, tokens, cfg: LlamaConfig):
    """Embedding rows of ``tokens`` in cfg.dtype, on tokens' device (tp:
    each rank's masked lookup of its vocab rows, summed)."""
    if not _is_tp(params):
        return params["embed"][tokens].to(cfg.dtype)
    parts, lo = [], 0
    for p in params:
        e = p["embed"]
        n = e.shape[0]
        t = tokens.to(e.device) - lo
        hit = (t >= 0) & (t < n)
        rows = e[t.clamp(0, n - 1)].to(cfg.dtype)
        parts.append(torch.where(hit[..., None], rows, 0))
        lo += n
    return tp_all_reduce(parts)[0].to(tokens.device)


def _vocab_parallel(head, x, params, lora, slots):
    """``head(x, params, lora, slots)`` on one device; tp: each rank's
    f32 logit columns, concatenated on x's device."""
    if not _is_tp(params):
        return head(x, params, lora, slots)
    cols = []
    for i, p in enumerate(params):
        ll = None if lora is None else lora[i]
        cols.append(head(x.to(p["lm_head"].device), p, ll, slots).to(
            x.device))
    return torch.cat(cols, dim=-1)


def _mlp_partial(h, p, cfg: LlamaConfig):
    """One rank's f32 partial sum of the MLP over its mlp columns."""
    if cfg.moe_experts:
        return _moe_ffn(h, p, cfg, f32_out=True)[0]
    gate = F.silu(h @ p["w_gate"])
    return _logits(gate * (h @ p["w_up"]), p["w_down"])


def _paged_layers_tp(shards, x, caches, cfg: LlamaConfig, cos, sin, loras,
                     slots, attend):
    """``_paged_layers`` over tp shards (section comment). Returns the
    first rank's copy of the replicated hidden state."""
    devs = [s["final_norm"].device for s in shards]
    xs = [x.to(d) for d in devs]
    rope = [_on(d, cos, sin) for d in devs]
    for layer in range(cfg.n_layers):
        ps = [_layer_params(s, layer) for s in shards]
        lls = [_lora_at_layer(None if loras is None else loras[i], layer)
               for i in range(len(ps))]
        parts = []
        for i, p in enumerate(ps):
            h = rms_norm(xs[i], p["attn_norm"], cfg.norm_eps)
            q, k, v = _qkv(h, p, cfg, *rope[i], lls[i], slots)
            attn = attend(caches[i][layer], q, k, v)
            y = _logits(attn, p["wo"])
            if lls[i] is not None:
                y = _lora_add(y, attn, lls[i], "wo", slots)
            parts.append(y)
        xs = [a + y.to(a.dtype) for a, y in zip(xs, tp_all_reduce(parts))]
        parts = [_mlp_partial(rms_norm(xs[i], p["mlp_norm"], cfg.norm_eps),
                              p, cfg) for i, p in enumerate(ps)]
        xs = [a + y.to(a.dtype) for a, y in zip(xs, tp_all_reduce(parts))]
    return xs[0]


# ---------------------------------------------------------------------------
# Dense KV cache (slot-based; used by the dense-slot engine)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  device="cuda") -> dict:
    """One shared position for the whole batch: {'k','v': [L, B, max_len,
    KVH, D] zeros, 'idx': 0} (``idx`` a host int, the next position)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "idx": 0}


def init_slot_cache(cfg: LlamaConfig, max_batch: int, max_len: int,
                    device="cuda") -> dict:
    """Per-slot KV cache: each batch row is an independent request with
    its own length (unlike init_kv_cache's single shared position)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, max_batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "lengths": torch.zeros((max_batch,), dtype=torch.int32,
                                   device=dev)}


def _cached_attention(q, ck, cv, q_pos, cfg: LlamaConfig):
    """Plain attention over a dense cache: q [B, S, H, D] at positions
    q_pos [B, S] attends keys k_pos <= q_pos of ck/cv [B, T, KVH, D]. The
    mask also hides the cache tail not written yet (and the pad K/V a
    prefill bucket left there): its positions exceed every query's. GQA
    as a grouped einsum (no repeat of the cache); scores and softmax in
    f32, probabilities rounded to the cache's dtype before p.V, as the
    reference rounds them."""
    b, s, h, d = q.shape
    t, kvh = ck.shape[1], ck.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, ck.float())
    scores = scores * (cfg.head_dim ** -0.5)
    k_pos = torch.arange(t, device=q.device)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]            # [B, S, T]
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, cv).reshape(b, s, h, d)


def _cached_layer(x, p: dict, cfg: LlamaConfig, cos, sin, ck, cv, q_pos):
    """One block over a dense cache (the reference's ``_layer`` cache
    branch): writes this step's K/V into ck/cv [B, T, KVH, D] in place at
    q_pos [B, S], then attends the cache prefix."""
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    b, s, _ = h.shape
    q, k, v = _qkv(h, p, cfg, cos, sin)
    rows = torch.arange(b, device=x.device)[:, None]
    ck[rows, q_pos] = k.to(ck.dtype)
    cv[rows, q_pos] = v.to(cv.dtype)
    attn = _cached_attention(q, ck, cv, q_pos, cfg)
    x = x + attn.reshape(b, s, -1) @ p["wo"]
    return _mlp_block(x, p, cfg)[0]


def apply_decode(params: dict, tokens, cache: dict, cfg: LlamaConfig):
    """Incremental forward with KV cache: tokens [B, S_step] appended at
    cache['idx']. Returns (logits [B, S_step, V] f32, cache with idx
    advanced); the K/V tensors are written in place. A step that would
    run past the cache's end raises (the reference clamped the write)."""
    b, s = tokens.shape
    idx = int(cache["idx"])
    x = params["embed"][tokens].to(cfg.dtype)
    positions = (idx + torch.arange(s, device=tokens.device)).expand(b, s)
    cos, sin = rope_freqs(cfg, positions)
    for layer in range(cfg.n_layers):
        x = _cached_layer(x, _layer_params(params, layer), cfg, cos, sin,
                          cache["k"][layer], cache["v"][layer], positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x, params["lm_head"]), {"k": cache["k"],
                                           "v": cache["v"], "idx": idx + s}


def _hidden_with_kv(params: dict, tokens, cfg: LlamaConfig):
    """apply_with_kv up to the final norm: (hidden [B, S, dim], ks, vs)."""
    b, s = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    cos, sin = rope_freqs(cfg, positions)
    ks, vs = [], []
    for layer in range(cfg.n_layers):
        p = _layer_params(params, layer)
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(h, p, cfg, cos, sin)
        attn = _attention(q, k, v, cfg, causal=True, attn_impl=None)
        x = x + attn.reshape(b, s, -1) @ p["wo"]
        x, _ = _mlp_block(x, p, cfg)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.stack(ks), torch.stack(vs)


def apply_with_kv(params: dict, tokens, cfg: LlamaConfig):
    """Prefill forward returning per-layer rope'd K/V for cache seeding:
    tokens [B, S] -> (logits [B, S, V] f32, k/v [L, B, S, KVH, D])."""
    hidden, ks, vs = _hidden_with_kv(params, tokens, cfg)
    return _logits(hidden, params["lm_head"]), ks, vs


def prefill_with_kv(params: dict, tokens, last: int, cfg: LlamaConfig):
    """apply_with_kv for a right-padded prompt: only position ``last``
    (the last real token) goes through the lm_head. Returns (logits
    [B, V] f32, ks, vs)."""
    hidden, ks, vs = _hidden_with_kv(params, tokens, cfg)
    return _logits(hidden[:, last], params["lm_head"]), ks, vs


def decode_batched(params: dict, tokens, cache: dict, cfg: LlamaConfig):
    """One decode step for a batch of independent slots.

    tokens [B, 1], the next token per slot; slot b writes its K/V at
    position cache['lengths'][b] (in place; every slot writes, inactive
    ones too, so the caller keeps lengths <= max_len - 1) and attends
    positions <= it. Returns (logits [B, V] f32, cache with lengths + 1).
    Inactive slots may carry any token; the caller masks their outputs.
    """
    lengths = cache["lengths"]
    x = params["embed"][tokens].to(cfg.dtype)                 # [B, 1, D]
    positions = lengths[:, None]                              # [B, 1]
    cos, sin = rope_freqs(cfg, positions)
    for layer in range(cfg.n_layers):
        x = _cached_layer(x, _layer_params(params, layer), cfg, cos, sin,
                          cache["k"][layer], cache["v"][layer], positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x, params["lm_head"])[:, 0], {
        "k": cache["k"], "v": cache["v"], "lengths": lengths + 1}
