"""Weights from the reference package into the port's tensors.

``params_from_numpy`` takes the reference's Llama parameter pytree as
nested dicts of numpy arrays (the tests make it with
``jax.tree.map(np.asarray, params)``) and returns the port's dict of
tensors. The layout is kept as it is — stacked ``layers`` ``[L, ...]``
and ``x @ W`` weights stored ``[in, out]`` — and every shape is checked
against the config, so a transposed or mis-sized weight raises instead of
being silently transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from .llama import LlamaConfig, param_dtype, param_shapes, resolve_device


def _to_tensor(arr, name: str) -> torch.Tensor:
    # contiguous and writable (arrays exported from JAX are read-only);
    # copies only when the input is neither
    arr = np.require(arr, requirements=["C", "W"])
    if arr.dtype.name == "bfloat16":
        # numpy bf16 (ml_dtypes) has no torch counterpart torch.from_numpy
        # accepts: carry the raw 16-bit patterns and reinterpret them
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    if arr.dtype not in (np.float32, np.float16, np.float64):
        raise TypeError(f"{name}: unsupported dtype {arr.dtype}")
    return torch.from_numpy(arr)


def params_from_numpy(tree: dict, cfg: LlamaConfig, device="cuda") -> dict:
    """Reference pytree of numpy arrays -> port params on ``device`` in
    cfg.dtype (an MoE router in f32: ``llama.param_dtype``). Raises on a
    missing or extra key and on any shape that differs from the
    reference layout for ``cfg``."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)

    def convert(sub: dict, want: dict, prefix: str) -> dict:
        if set(sub) != set(want):
            raise KeyError(f"{prefix or 'params'}: keys {sorted(sub)} != "
                           f"expected {sorted(want)}")
        out = {}
        for key, shape in want.items():
            name = f"{prefix}{key}"
            if isinstance(shape, dict):
                out[key] = convert(sub[key], shape, name + ".")
                continue
            t = _to_tensor(sub[key], name)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                 f"{tuple(shape)} (reference layout)")
            out[key] = t.to(device=dev, dtype=param_dtype(cfg, key))
        return out

    return convert(tree, shapes, "")
