"""LoRA adapters for the llama family (counterpart of
``ray_tpu/llm/lora.py``).

An adapter is a dict of numpy arrays, the reference's ``.npz`` layout:
``<t>.A`` [L, d_in, r] and ``<t>.B`` [L, r, d_out] for each layer
target t in ("wq", "wk", "wv", "wo"), ``lm_head.A`` [d, r] and
``lm_head.B`` [r, V] unstacked, plus the scalars ``rank`` and
``alpha``. An adapter saved by either package loads in the other.

Two ways to serve one: ``merge`` folds it into a copy of the weights
(W' = W + (alpha/r)·A@B, in f32 before the cast back — one engine per
adapter, and the parity oracle of the batched path), or the paged
engine's slot table (``llm/multilora``) adds the low-rank delta per row
of a mixed-tenant batch.
"""
from __future__ import annotations

import io
import os

import numpy as np
import torch

from ..models import llama

_LAYER_TARGETS = ("wq", "wk", "wv", "wo")


def target_dims(cfg: llama.LlamaConfig, target: str) -> tuple:
    """(d_in, d_out) of a LoRA target's weight."""
    d, hd = cfg.dim, cfg.head_dim
    if target == "wq":
        return d, cfg.n_heads * hd
    if target in ("wk", "wv"):
        return d, cfg.n_kv_heads * hd
    if target == "wo":
        return cfg.n_heads * hd, d
    if target == "lm_head":
        return d, cfg.vocab_size
    raise ValueError(f"unknown LoRA target {target!r}")


def random_adapter(seed, cfg: llama.LlamaConfig, rank: int = 4,
                   alpha: float = 8.0,
                   targets: tuple = ("wq", "wv")) -> dict:
    """A random adapter (B != 0 so it changes outputs — tests and demos;
    real adapters come from training, where B starts at zero).
    ``seed`` is an int or a CPU ``torch.Generator``; entries are
    N(0, 1) · 0.05 in f32, drawn on the CPU."""
    g = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    out = {"rank": np.int32(rank), "alpha": np.float32(alpha)}
    for t in targets:
        din, dout = target_dims(cfg, t)
        lead = () if t == "lm_head" else (cfg.n_layers,)
        for key, shape in ((f"{t}.A", lead + (din, rank)),
                           (f"{t}.B", lead + (rank, dout))):
            out[key] = (torch.randn(shape, generator=g) * 0.05).numpy()
    return out


def save_adapter(adapter: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **adapter)


def load_adapter(path: str) -> dict:
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def adapter_to_bytes(adapter: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **adapter)
    return buf.getvalue()


def adapter_from_bytes(blob: bytes) -> dict:
    with np.load(io.BytesIO(blob)) as z:
        return {k: z[k] for k in z.files}


def scale_of(adapter: dict) -> float:
    """alpha / rank, the reference's defaults (rank 4, alpha = rank)."""
    rank = int(adapter.get("rank", 4))
    alpha = float(adapter.get("alpha", rank))
    return alpha / max(rank, 1)


def _f32(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.require(arr, np.float32,
                                       ["C", "W"])).to(device)


def merge(params: dict, adapter: dict) -> dict:
    """params' = params + scale·A@B per target, computed in f32 and cast
    back to each weight's dtype. Returns a NEW dict; untouched tensors
    are shared (no copy)."""
    scale = scale_of(adapter)
    out = dict(params)
    layers = dict(params["layers"])
    for t in _LAYER_TARGETS:
        a, b = adapter.get(f"{t}.A"), adapter.get(f"{t}.B")
        if a is None or b is None:
            continue
        w = params["layers"][t]
        delta = torch.einsum("ldr,lrk->ldk", _f32(a, w.device),
                             _f32(b, w.device))
        layers[t] = (w.float() + scale * delta).to(w.dtype)
    out["layers"] = layers
    if "lm_head.A" in adapter:
        w = params["lm_head"]
        delta = _f32(adapter["lm_head.A"], w.device) @ _f32(
            adapter["lm_head.B"], w.device)
        out["lm_head"] = (w.float() + scale * delta).to(w.dtype)
    return out

