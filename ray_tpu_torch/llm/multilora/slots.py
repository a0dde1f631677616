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
        t = self.tree
        for tgt, ab in per_target.items():
            for key, val in zip((f"{tgt}.A", f"{tgt}.B"),
                                (None, None) if ab is None else ab):
                row = t[key][slot]
                if val is None:
                    row.zero_()
                else:
                    row.copy_(torch.from_numpy(
                        np.require(val, np.float32, ["C", "W"])))
        t["scale"][slot] = scale
