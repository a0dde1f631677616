"""Fixed-shape resident-adapter slot table for batched multi-LoRA
(counterpart of ``ray_tpu/llm/multilora/slots.py``).

The device side of multi-tenant serving: per LoRA target one stacked,
rank-padded pair of f32 tensors

    "<t>.A" [S, L, in_t, R]   "<t>.B" [S, L, R, out_t]   t in wq/wk/wv/wo
    "lm_head.A" [S, d, R]     "lm_head.B" [S, R, V]
    "scale" [S] f32           (alpha / rank per slot)

where S = max_adapters and R = the table's max rank. Shapes never
depend on which adapters are resident, so the engine's programs are
built once and every dispatch gathers rows by the batch's
``adapter_slot`` ids (``models/llama.py`` ``_lora_add``). Slot 0 is the
base-model no-op: all-zero A/B, scale 0 — it adds an exact zero, so
base rows through a LoRA-enabled engine give the plain engine's tokens
and logprobs (rank-r adapters padded to R add 0·0 terms only).

A load writes the slot's rows in place (``copy_`` into the existing
tensors) and never rebinds a table tensor: on the card the engine's
captured programs (``llm/graphs.py``) read the addresses they were
captured with. Callers serialize loads against the engine's stepping
(the serving layer's step lock), as for page imports.

On a tp mesh (``shard``) the table becomes one tree per tp rank, each
tensor cut like the weight its rows add onto (``logical_axes``); a load
then writes every rank's slice of the slot's rows in place.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...models import llama
from ..lora import scale_of, target_dims


class AdapterSlotTable:
    """max_adapters resident slots over one LlamaConfig; slot 0 = base."""

    def __init__(self, cfg: llama.LlamaConfig, max_adapters: int,
                 max_rank: int,
                 targets: tuple = ("wq", "wk", "wv", "wo", "lm_head"),
                 device="cuda"):
        if max_adapters < 2:
            raise ValueError("max_adapters must be >= 2 (slot 0 is the "
                             "reserved base/no-op slot)")
        if max_rank < 1:
            raise ValueError("max_rank must be >= 1")
        self.cfg = cfg
        self.max_adapters = int(max_adapters)
        self.max_rank = int(max_rank)
        self.targets = tuple(targets)
        dev = llama.resolve_device(device)
        S, L, R = self.max_adapters, cfg.n_layers, self.max_rank
        f32 = dict(dtype=torch.float32, device=dev)
        tree = {"scale": torch.zeros((S,), **f32)}
        for t in self.targets:
            din, dout = target_dims(cfg, t)
            lead = () if t == "lm_head" else (L,)
            tree[f"{t}.A"] = torch.zeros((S,) + lead + (din, R), **f32)
            tree[f"{t}.B"] = torch.zeros((S,) + lead + (R, dout), **f32)
        self.tree = tree

    # -- tensor-parallel placement (parallel/sharding.py) -----------------

    def logical_axes(self) -> dict:
        """Logical axis names per table key, the reference's: each B
        shards its OUTPUT dim as the target weight does (wq->heads,
        wk/wv->kv_heads, wo->embed, lm_head->vocab), each A its input
        dim, and the slot, layer and rank dims stay replicated, so a
        rank's low-rank delta composes with its shard of the base
        product (wo's delta is a partial sum, reduced with wo's)."""
        out_axis = {"wq": "heads", "wk": "kv_heads", "wv": "kv_heads",
                    "wo": "embed", "lm_head": "vocab"}
        in_axis = {"wq": "embed", "wk": "embed", "wv": "embed",
                   "wo": "heads", "lm_head": "embed"}
        axes = {"scale": (None,)}
        for t in self.targets:
            lead = (None,) if t == "lm_head" else (None, None)
            axes[f"{t}.A"] = lead + (in_axis[t], None)
            axes[f"{t}.B"] = lead + (None, out_axis[t])
        return axes

    def shard(self, mesh) -> None:
        """Cut the table into one tree per tp rank of ``mesh``
        (``self.tree`` becomes that list) by ``logical_axes``. The caller
        holds the same serialization contract as ``load``."""
        from ...parallel.sharding import shard_tensor, split_dim
        axes = self.logical_axes()
        trees = [dict() for _ in mesh.axis_devices("tp")]
        self._split = {}
        for key, t in self.tree.items():
            self._split[key] = split_dim(axes[key], mesh)
            for tree, part in zip(trees, shard_tensor(t, axes[key], mesh)):
                tree[key] = part
        self.tree = trees

    def _rows(self, key: str, slot: int) -> list:
        """[(row tensor, slice of a full row)] of ``slot`` for ``key``:
        one per distinct tensor (tp ranks on one device may share a
        replicated one)."""
        if isinstance(self.tree, dict):
            return [(self.tree[key][slot], ...)]
        dim, out, seen = self._split[key], [], set()
        for rank, tree in enumerate(self.tree):
            row = tree[key][slot]
            if dim is None:
                if row.data_ptr() not in seen:
                    seen.add(row.data_ptr())
                    out.append((row, ...))
                continue
            n = row.shape[dim - 1]                    # the slot dim is gone
            idx = [slice(None)] * row.dim()
            idx[dim - 1] = slice(rank * n, (rank + 1) * n)
            out.append((row, tuple(idx)))
        return out

    def _padded(self, adapter: dict, target: str):
        """(A, B) padded to [.., in, R]/[.., R, out] f32, or None when
        the adapter lacks the target. Rank padding is exact: the extra
        lanes multiply 0·0 into the dot products."""
        a = adapter.get(f"{target}.A")
        if a is None:
            return None
        b = adapter[f"{target}.B"]
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        r = a.shape[-1]
        if r > self.max_rank:
            raise ValueError(
                f"adapter rank {r} exceeds the slot table's max_rank "
                f"{self.max_rank} (target {target!r})")
        if r < self.max_rank:
            pad_a = [(0, 0)] * (a.ndim - 1) + [(0, self.max_rank - r)]
            pad_b = [(0, 0)] * (b.ndim - 2) + [(0, self.max_rank - r),
                                               (0, 0)]
            a = np.pad(a, pad_a)
            b = np.pad(b, pad_b)
        return a, b

    def load(self, slot: int, adapter: Optional[dict]) -> None:
        """Install ``adapter`` (``llm/lora.py`` npz dict) into ``slot``
        in place; None clears the slot back to the base no-op. The
        caller serializes against the engine's stepping thread."""
        if not 0 < slot < self.max_adapters:
            raise ValueError(
                f"slot must be in [1, {self.max_adapters}); slot 0 is "
                f"the reserved base slot")
        if adapter is None:
            scale = 0.0
            per_target = {t: None for t in self.targets}
        else:
            scale = scale_of(adapter)
            per_target = {t: self._padded(adapter, t)
                          for t in self.targets}
            unknown = [k[:-2] for k in adapter
                       if k.endswith(".A") and k[:-2] not in self.targets]
            if unknown:
                raise ValueError(
                    f"adapter targets {unknown} are not in this table's "
                    f"targets {self.targets}")
        for tgt, ab in per_target.items():
            for key, val in zip((f"{tgt}.A", f"{tgt}.B"),
                                (None, None) if ab is None else ab):
                for row, part in self._rows(key, slot):
                    if val is None:
                        row.zero_()
                    else:
                        row.copy_(torch.from_numpy(np.require(
                            val[part], np.float32, ["C", "W"])))
        for row, _ in self._rows("scale", slot):
            row.fill_(scale)
