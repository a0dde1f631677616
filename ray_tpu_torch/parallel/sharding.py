"""Logical-axis sharding rules and explicit tensor-parallel shards
(counterpart of ``ray_tpu/parallel/sharding.py``).

Model code names its dimensions with logical axes (``models/llama.py``
``logical_axes``); ``logical_spec`` maps them onto mesh axes with the
reference's rules. The reference hands the result to XLA as a
``NamedSharding``; the port cuts tensors itself: ``shard_tensor`` makes
one contiguous shard per tp rank on that rank's device, ``unshard`` puts
them back together, and ``tp_all_reduce`` is the one place where shards'
partial sums meet. Only the tp axis may have a size above 1 here; the
other axes (and a transport between distinct cards) are queue A9.2's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .mesh import BATCH_AXES, get_mesh

# Default logical->mesh axis rules, the reference's verbatim.
# Each entry: (logical_axis, mesh axis or tuple of mesh axes or None).
# First rule whose mesh axes all exist in the mesh (and are unused so far in
# the same spec) wins.
LOGICAL_AXIS_RULES: tuple[tuple[str, object], ...] = (
    ("batch", ("dp", "fsdp")),
    ("sequence", "sp"),
    ("embed", "fsdp"),          # FSDP shards params along embed/feature dims
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("q_seq", "sp"),
    ("kv_seq", None),
    ("head_dim", None),
    # Vocab rows shard over (tp, fsdp): Megatron-style vocab-parallel
    # embedding. On lm_head ("embed", "vocab") the embed dim claims fsdp
    # first, so logits stay tp-sharded.
    ("vocab", ("tp", "fsdp")),
    ("expert", "ep"),
    ("stage", "pp"),
    ("channel", None),
    ("norm", None),
)


def logical_spec(logical_axes: Sequence[Optional[str]], mesh=None,
                 rules=LOGICAL_AXIS_RULES) -> tuple:
    """Map logical axis names (None = replicated) to a spec tuple, the
    counterpart of the reference's ``PartitionSpec``: per dimension None,
    one mesh axis, or a tuple of them; trailing Nones dropped.

    Mesh axes present in the mesh with size 1 are kept (harmless); mesh
    axes absent from the mesh are dropped. A mesh axis is used at most
    once per spec: later logical axes lose the contested axis."""
    mesh = mesh or get_mesh()
    mesh_axes = set(mesh.axis_names) if mesh is not None else set()
    rule_map = dict(rules)
    used: set[str] = set()
    out = []
    for ax in logical_axes:
        if ax is None:
            out.append(None)
            continue
        if ax not in rule_map:
            raise ValueError(f"no sharding rule for logical axis {ax!r}")
        target = rule_map[ax]
        if target is None:
            out.append(None)
            continue
        cand = (target,) if isinstance(target, str) else tuple(target)
        cand = tuple(a for a in cand if a in mesh_axes and a not in used)
        used.update(cand)
        if not cand:
            out.append(None)
        elif len(cand) == 1:
            out.append(cand[0])
        else:
            out.append(cand)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def batch_spec(mesh=None) -> tuple:
    """Spec of a [batch, ...] tensor: batch over dp+fsdp."""
    mesh = mesh or get_mesh()
    axes = tuple(a for a in BATCH_AXES
                 if mesh is not None and a in mesh.axis_names)
    return (axes if axes else None,)


def constrain(x, logical_axes: Sequence[Optional[str]] = (), mesh=None,
              rules=LOGICAL_AXIS_RULES):
    """Returns ``x``: the port shards explicitly, so there is no layout
    to hint (the reference's ``constrain`` is a no-op off-mesh too)."""
    return x


def _check_tp_only(mesh) -> None:
    other = {a: n for a, n in mesh.shape.items() if a != "tp" and n > 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {other}: only tp shards in ray_tpu_torch "
            f"(dp/fsdp/ep/sp/pp are queue A9.2)")


def split_dim(logical_axes: Sequence[Optional[str]], mesh) -> Optional[int]:
    """The dimension a tensor with these logical axes splits over tp, or
    None when it is replicated."""
    _check_tp_only(mesh)
    for i, entry in enumerate(logical_spec(logical_axes, mesh)):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        if "tp" in names:
            return i
    return None


def shard_tensor(t: torch.Tensor, logical_axes: Sequence[Optional[str]],
                 mesh) -> list:
    """One contiguous shard of ``t`` per tp rank, placed on that rank's
    device: an equal slice along the tp-split dimension, or the whole
    tensor when the axes leave it replicated (ranks that share a device
    share it). A shard already contiguous on its device (a leading-dim
    slice, or ``t`` itself) is a view of ``t``, not a copy."""
    devices = mesh.axis_devices("tp")
    dim = split_dim(logical_axes, mesh)
    if dim is None:
        copies: dict = {}
        for d in devices:
            if d not in copies:
                copies[d] = t.to(d).contiguous()
        return [copies[d] for d in devices]
    n = t.shape[dim]
    if n % len(devices):
        raise ValueError(f"tp={len(devices)} must divide dim {dim} "
                         f"({n}) of a tensor with axes {tuple(logical_axes)}")
    return [part.to(d).contiguous() for part, d in
            zip(torch.chunk(t, len(devices), dim=dim), devices)]


def unshard(parts: Sequence[torch.Tensor],
            logical_axes: Sequence[Optional[str]], mesh) -> torch.Tensor:
    """The whole tensor from its tp shards, on the first shard's device."""
    dim = split_dim(logical_axes, mesh)
    dev = parts[0].device
    if dim is None:
        return parts[0]
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def tp_all_reduce(parts: Sequence[torch.Tensor]) -> list:
    """Sum the tp shards' partial results: on the first shard's device,
    in rank order, handed back to each shard's device (ranks on one
    device get the same tensor). Every reduction of a tp forward goes
    through here; a transport between distinct cards replaces only this
    function."""
    if len(parts) == 1:
        return [parts[0]]
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev)
    return [total.to(p.device) for p in parts]
