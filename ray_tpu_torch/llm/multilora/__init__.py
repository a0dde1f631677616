"""ray_tpu_torch.llm.multilora — many tenants, one shared paged base
model (counterpart of ``ray_tpu.llm.multilora``).

Resident adapters live in a fixed-shape SLOT TABLE (``slots.py`` —
[max_adapters, L, d, r] stacked, rank-padded A/B per target, slot 0 =
base/no-op) and every engine dispatch carries per-row ``adapter_slot``
ids, so one program per static key serves a mixed-tenant batch with no
per-tenant weight copy. ``llm/lora.py`` ``merge`` instead folds an
adapter into a full weight copy (one engine per adapter — the
single-tenant path and the parity oracle).

  publish — ``registry.py`` AdapterRegistry: versioned adapter store
            with a keep window (the runtime's store and directory
            under ``init()``, else in process);
  train   — ``train.py`` LoRATrainer: fine-tune one adapter over a
            frozen base, in process or on the Train library's gang,
            checkpointed and resumable; ``publish()`` into the registry;
  serve   — ``manager.py`` MultiLoraManager: engine-side LRU of
            resident slots, hot-swap without engine restart, in-flight
            requests pinned to their admitted version; the serving
            layer resolves adapter ids at admission and salts prefix-
            cache keys with (adapter_id, version).
"""
from .manager import MultiLoraManager, prefix_salt
from .registry import AdapterRegistry
from .slots import AdapterSlotTable
from .train import LoRATrainConfig, LoRATrainer

__all__ = ["AdapterSlotTable", "AdapterRegistry", "LoRATrainConfig",
           "LoRATrainer", "MultiLoraManager", "prefix_salt"]
