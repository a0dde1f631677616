"""LoRATrainer: per-tenant fine-tuning on the port's Train library
(counterpart of ``ray_tpu/llm/multilora/train.py``).

The train leg of the train -> publish -> serve loop. Base weights stay
FROZEN; only the adapter factors A/B train (A ~ N(0, 0.02²), B = 0, the
standard LoRA init, so step 0 is exactly the base model). The forward
differentiates THROUGH ``llm/lora.py``'s ``merge`` — the W + (alpha/r)·A@B
math, in f32 before the cast back, that the merged serving engine runs
— so a trained adapter's serving outputs are the model the trainer
optimized. The step runs on the device of the base weights (the card
for weights made with ``llama.init``'s default), through the flash
attention kernels of the training forward and backward.

Two execution modes:

- ``scaling_config=None`` (default): the loop runs in-process;
- with a ScalingConfig, the loop runs under ``train.DataParallelTrainer``
  (gang scheduling, failure handling, result bus) with
  ``train.report()``/``Checkpoint`` per checkpoint_every steps and
  resume via ``train.get_checkpoint()``. The base weights travel to the
  worker pickled from host copies; the worker puts them on its own
  card (or keeps them on the CPU when the driver's were there).

Both modes checkpoint ``{"step", "adapter", "opt_leaves"}`` as host
numpy arrays, ``opt_leaves`` in optax's leaf order for ``optax.adam``
(``count``, then ``mu`` and ``nu`` per factor in sorted key order), so
that a state either package reports resumes in the other. ``publish()``
lands the trained adapter in the AdapterRegistry, where serving
replicas' managers pick it up live.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Any, Callable, Optional

import numpy as np

from .registry import AdapterRegistry

# optax.adam's defaults: b1, b2, eps (eps_root 0)
_ADAM = (0.9, 0.999, 1e-8)


@dataclasses.dataclass
class LoRATrainConfig:
    model: Any                       # llama.LlamaConfig
    rank: int = 4
    alpha: float = 8.0
    targets: tuple = ("wq", "wv")
    learning_rate: float = 5e-2
    steps: int = 40
    batch_size: int = 4
    seq_len: int = 32
    checkpoint_every: int = 10
    seed: int = 0


def _init_adapter(tcfg: LoRATrainConfig) -> dict:
    """Trainable factors as f32 numpy arrays: A random, B zero (delta
    starts at exactly 0). A is N(0, 1) · 0.02 from a CPU
    ``torch.Generator`` seeded by ``tcfg.seed``, drawn per target in
    ``tcfg.targets`` order (not the reference's jax.random stream)."""
    import torch

    from .. import lora

    cfg = tcfg.model
    g = torch.Generator().manual_seed(int(tcfg.seed))
    out = {}
    for t in tcfg.targets:
        din, dout = lora.target_dims(cfg, t)
        lead = () if t == "lm_head" else (cfg.n_layers,)
        out[f"{t}.A"] = (torch.randn(lead + (din, tcfg.rank), generator=g)
                         * 0.02).numpy()
        out[f"{t}.B"] = np.zeros(lead + (tcfg.rank, dout), np.float32)
    return out


def _default_data(tcfg: LoRATrainConfig) -> Callable:
    """Plain LM objective on random token streams (callers pass a real
    data_fn; this keeps the trainer runnable out of the box)."""
    def data_fn(step: int):
        rng = np.random.RandomState(tcfg.seed * 100003 + step)
        toks = rng.randint(1, tcfg.model.vocab_size,
                           (tcfg.batch_size, tcfg.seq_len + 1))
        return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
    return data_fn


def _device_of(params):
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _run_loop(tcfg: LoRATrainConfig, base_params, data_fn,
              state: Optional[dict], report_cb,
              on_step: Optional[Callable] = None) -> dict:
    """The loop both modes share. ``state`` resumes {step, adapter,
    opt_leaves} (numpy arrays or CPU tensors, from either package);
    ``report_cb(step, loss, state_dict)`` fires every checkpoint_every
    steps and at the end, ``on_step(step, loss)`` after every step.
    Returns the final state.

    A step: ``merge`` -> ``llama.apply`` -> ``cross_entropy_loss`` ->
    the gradient of the factors alone, then Adam as ``optax.adam(lr)``
    computes it (bias-corrected moments, update m̂ / (√v̂ + eps))."""
    import torch

    from .. import lora
    from ...models import llama

    dev = _device_of(base_params)
    if state is None:
        adapter = _init_adapter(tcfg)
        keys = sorted(adapter)
        count = 0
        mu = {k: np.zeros_like(adapter[k]) for k in keys}
        nu = {k: np.zeros_like(adapter[k]) for k in keys}
        start = 0
    else:
        adapter = {k: np.asarray(v, np.float32)
                   for k, v in state["adapter"].items()}
        keys = sorted(adapter)
        leaves = [np.asarray(leaf) for leaf in state["opt_leaves"]]
        if len(leaves) != 1 + 2 * len(keys):
            raise ValueError(f"opt_leaves holds {len(leaves)} leaves, want "
                             f"1 + 2 x {len(keys)} (count, mu, nu)")
        count = int(leaves[0])
        mu = dict(zip(keys, leaves[1:1 + len(keys)]))
        nu = dict(zip(keys, leaves[1 + len(keys):]))
        start = int(state["step"])

    def on_dev(arrs):
        return {k: torch.tensor(np.asarray(arrs[k], np.float32), device=dev)
                for k in keys}
    params = on_dev(adapter)
    m, v = on_dev(mu), on_dev(nu)
    scalars = {"rank": np.int32(tcfg.rank), "alpha": np.float32(tcfg.alpha)}
    mc, lr = tcfg.model, float(tcfg.learning_rate)
    b1, b2, eps = _ADAM

    def snapshot(step: int) -> dict:
        return {"step": np.int32(step),
                "adapter": {k: _host(params[k]) for k in keys},
                "opt_leaves": [np.asarray(count, np.int32)]
                + [_host(m[k]) for k in keys] + [_host(v[k]) for k in keys]}

    loss = float("nan")
    for i in range(start, tcfg.steps):
        tokens, targets = data_fn(i)
        tokens = torch.as_tensor(np.asarray(tokens, np.int32),
                                 dtype=torch.int64, device=dev)
        targets = torch.as_tensor(np.asarray(targets, np.int32),
                                  dtype=torch.int64, device=dev)
        leaves = [params[k].requires_grad_() for k in keys]
        merged = lora.merge(base_params, {**params, **scalars})
        logits = llama.apply(merged, tokens, mc)
        loss_t = llama.cross_entropy_loss(logits, targets)
        grads = torch.autograd.grad(loss_t, leaves)
        del merged, logits
        count += 1
        c1 = 1 - np.float32(b1) ** np.float32(count)
        c2 = 1 - np.float32(b2) ** np.float32(count)
        with torch.no_grad():
            for k, g in zip(keys, grads):
                m[k] = (1 - b1) * g + b1 * m[k]
                v[k] = (1 - b2) * (g * g) + b2 * v[k]
                step = (m[k] / float(c1)) / (torch.sqrt(v[k] / float(c2))
                                             + eps)
                params[k] = params[k].detach() + (-lr) * step
        loss = float(loss_t.detach())
        if on_step is not None:
            on_step(i + 1, loss)
        done = i + 1 >= tcfg.steps
        if done or (i + 1) % tcfg.checkpoint_every == 0:
            state = snapshot(i + 1)
            report_cb(i + 1, loss, state)
    if state is None:      # steps == 0 degenerate case
        state = snapshot(start)
        report_cb(start, loss, state)
    return state


def _as_published(tcfg: LoRATrainConfig, adapter_arrays: dict) -> dict:
    """Trained factors -> the llm/lora.py npz adapter format (what the
    registry stores, the merged engine merges, and the slot table
    loads)."""
    return {"rank": np.int32(tcfg.rank), "alpha": np.float32(tcfg.alpha),
            **{k: np.asarray(v, np.float32)
               for k, v in adapter_arrays.items()}}


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


class LoRATrainer:
    """Fine-tune one adapter; checkpoint/resume; publish to a registry.

    Without ``base_params`` the base is ``llama.init(tcfg.model,
    seed=tcfg.seed)``, made on the card (it raises where CUDA is absent:
    pass weights made with ``device="cpu"`` for the plain versions).
    ``on_step(step, loss)``, where given, runs after every step in the
    process that trains (the gang's worker in substrate mode)."""

    def __init__(self, tcfg: LoRATrainConfig, adapter_id: str,
                 base_params: Optional[dict] = None,
                 data_fn: Optional[Callable] = None,
                 storage_path: Optional[str] = None,
                 registry: Optional[AdapterRegistry] = None,
                 scaling_config=None, run_config=None,
                 on_step: Optional[Callable] = None):
        self.tcfg = tcfg
        self.adapter_id = adapter_id
        self._base_params = base_params
        self.data_fn = data_fn or _default_data(tcfg)
        self.storage_path = storage_path
        self.registry = registry or AdapterRegistry()
        self.scaling_config = scaling_config
        self.run_config = run_config
        self.on_step = on_step
        self.adapter: Optional[dict] = None   # set by fit()
        self.last_loss: Optional[float] = None
        self.losses: list[float] = []         # the losses fit() reported
        # substrate mode: the pickled base weights' size and pickle time
        self.base_blob_bytes: Optional[int] = None
        self.base_pickle_s: Optional[float] = None

    def _base(self):
        if self._base_params is None:
            from ...models import llama
            self._base_params = llama.init(self.tcfg.model,
                                           seed=self.tcfg.seed)
        return self._base_params

    # -- local (in-process) mode -----------------------------------------

    def _fit_local(self) -> dict:
        from ...train.checkpoint import Checkpoint, CheckpointManager
        manager = None
        state = None
        if self.storage_path:
            manager = CheckpointManager(
                os.path.join(self.storage_path, self.adapter_id,
                             "checkpoints"), num_to_keep=2)
            manager.scan_existing()
            if manager.latest is not None:
                try:
                    state = manager.latest.load_state()
                except Exception:
                    state = None   # truncated checkpoint: start over

        losses = []

        def report(step, loss, st):
            losses.append(loss)
            if manager is not None:
                tmp = Checkpoint.from_state(st, metadata={"step": step})
                manager.register(tmp, {"step": step, "loss": loss})
                shutil.rmtree(tmp.path, ignore_errors=True)   # copied

        state = _run_loop(self.tcfg, self._base(), self.data_fn, state,
                          report, self.on_step)
        self.losses = losses
        self.last_loss = losses[-1] if losses else None
        return state

    # -- Train-substrate mode --------------------------------------------

    def _fit_substrate(self) -> dict:
        import cloudpickle

        from ... import train as train_mod
        tcfg, data_fn, on_step = self.tcfg, self.data_fn, self.on_step
        base = self._base()
        dev_type = _device_of(base).type
        t0 = time.perf_counter()
        base_blob = cloudpickle.dumps(_to_host(base))
        self.base_pickle_s = time.perf_counter() - t0
        self.base_blob_bytes = len(base_blob)

        def train_fn():
            import cloudpickle as _cp

            from ray_tpu_torch import train as ts
            base = _to_device(_cp.loads(base_blob), dev_type)
            restored = ts.get_checkpoint()
            state = restored.load_state() if restored is not None else None

            def report(step, loss, st):
                ck = ts.Checkpoint.from_state(st, metadata={"step": step})
                ts.report({"step": step, "loss": loss}, checkpoint=ck)

            _run_loop(tcfg, base, data_fn, state, report, on_step)

        trainer = train_mod.DataParallelTrainer(
            train_fn, scaling_config=self.scaling_config,
            run_config=self.run_config)
        result = trainer.fit()
        if result.checkpoint is None:
            raise RuntimeError("LoRA training finished without a "
                               "checkpoint (steps < checkpoint_every?)")
        self.losses = [m["loss"] for m in result.metrics_history]
        self.last_loss = (result.metrics or {}).get("loss")
        return result.checkpoint.load_state()

    # -- public surface ---------------------------------------------------

    def fit(self) -> dict:
        """Train (or resume) and return the adapter in llm/lora.py
        format."""
        state = (self._fit_local() if self.scaling_config is None
                 else self._fit_substrate())
        self.adapter = _as_published(self.tcfg, state["adapter"])
        return self.adapter

    def publish(self) -> int:
        """Land the trained adapter in the registry; serving replicas'
        managers observe the new version within their refresh TTL and
        hot-swap without an engine restart. Returns the version."""
        if self.adapter is None:
            raise RuntimeError("call fit() before publish()")
        return self.registry.publish(
            self.adapter_id, self.adapter,
            meta={"loss": self.last_loss, "steps": int(self.tcfg.steps)})
