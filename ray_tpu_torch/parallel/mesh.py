"""Device meshes and GPU topology (counterpart of
``ray_tpu/parallel/mesh.py``).

A mesh names how an engine's devices are laid out over the reference's
six axes:

  dp    data parallel
  fsdp  fully-sharded data parallel
  tp    tensor parallel (Megatron-style layer sharding)
  sp    sequence/context parallel
  ep    expert parallel
  pp    pipeline parallel

The reference's mesh is a ``jax.sharding.Mesh`` over which XLA partitions
its programs. Here ``Mesh`` only records the layout: ``axis_names``,
``shape`` (an ordered ``{axis: size}``, as the reference's) and
``devices``, a numpy object array of ``torch.device`` in the reference's
shape. The port shards explicitly (``parallel/sharding.py``), one tensor
per tp rank. An explicit device list may repeat a device: two tp shards
can share one card.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import threading
from typing import Optional, Sequence

import numpy as np
import torch

# Canonical mesh-axis order, as the reference's: tp and sp innermost.
AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# Batch-like logical dimensions shard over every data-ish axis.
BATCH_AXES = ("dp", "fsdp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape: axis name -> size; at most one -1 (inferred).

    MeshSpec(dp=-1, tp=4) on 32 devices resolves dp=8. By default
    (keep_unit_axes=True) ALL six axes appear in the mesh, size-1 ones
    included, so sharding rules can target any axis unconditionally. With
    keep_unit_axes=False only axes of size > 1 are kept.
    """

    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1
    keep_unit_axes: bool = True

    def resolved(self, n_devices: int) -> dict[str, int]:
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        inferred = [a for a, s in sizes.items() if s == -1]
        if len(inferred) > 1:
            raise ValueError(f"at most one axis may be -1, got {inferred}")
        known = math.prod(s for s in sizes.values() if s != -1)
        if inferred:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[inferred[0]] = n_devices // known
        elif known != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {known} devices, have {n_devices}")
        return sizes

    def wanted(self) -> int:
        """Devices the fixed axes ask for (an inferred axis counts 1)."""
        return math.prod(max(getattr(self, a), 1) for a in AXIS_ORDER)


class Mesh:
    """A device layout: ``devices`` (object array of ``torch.device``)
    shaped by ``axis_names``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of shape {devices.shape} for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(
            (a, int(n)) for a, n in zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` at index 0 of every other axis (the
        tp ranks' devices, for ``axis="tp"``); [first device] when the
        mesh has no such axis."""
        if axis not in self.axis_names:
            return [self.devices.flat[0]]
        i = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        idx[i] = slice(None)
        return list(self.devices[tuple(idx)])

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={list(self.devices.flat)})"


def default_devices(want: int, kind: Optional[str] = None) -> list:
    """The first ``want`` CUDA devices for ``kind="cuda"`` (every visible
    one for ``want`` <= 0), or ``want`` entries of the CPU for
    ``kind="cpu"``: the counterpart of the reference's forced host
    devices. ``kind=None`` means CUDA when it is available."""
    if kind is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    if kind == "cpu":
        return [torch.device("cpu")] * max(want, 1)
    n = torch.cuda.device_count()
    if want > 0:
        n = min(n, want)
    return [torch.device("cuda", i) for i in range(n)]


def build_mesh(spec: MeshSpec | dict | None = None,
               devices: Optional[Sequence] = None,
               axis_names: Optional[Sequence[str]] = None) -> Mesh:
    """A ``Mesh`` from a MeshSpec over ``devices`` (default: every visible
    CUDA device, or the CPU as many times as the spec's fixed axes ask);
    devices are reshaped in order, as the reference does off-TPU."""
    if isinstance(spec, dict):
        spec = MeshSpec(**spec)
    if spec is None:
        spec = MeshSpec(dp=-1)
    if devices is None:
        devices = default_devices(
            0 if torch.cuda.is_available() else spec.wanted())
    devices = [torch.device(d) for d in devices]
    sizes = spec.resolved(len(devices))
    if axis_names is None:
        axis_names = [a for a in AXIS_ORDER
                      if spec.keep_unit_axes or sizes[a] > 1]
        if not axis_names:
            axis_names = ["dp"]
    shape = tuple(sizes[a] for a in axis_names)
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return Mesh(arr.reshape(shape), axis_names)


# ---------------------------------------------------------------------------
# Current-mesh context (thread-local, nestable)
# ---------------------------------------------------------------------------

_local = threading.local()


def get_mesh():
    """Current mesh set by `use_mesh`, or None."""
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Set the current mesh for this thread (nestable)."""
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


# ---------------------------------------------------------------------------
# GPU topology (the reference's TpuTopology)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GpuTopology:
    """What this process sees of its devices: the card's name where the
    reference has a TPU generation, and the per-device bf16 peak from
    ``util/profiling.device_peak_flops`` (None when unknown: the CPU, or
    a card not in its table)."""

    name: str                # torch.cuda.get_device_name, or "cpu"
    num_devices: int         # devices visible to this process
    num_hosts: int
    devices_per_host: int
    peak_flops_bf16: Optional[float]

    @property
    def total_peak_flops(self) -> Optional[float]:
        if self.peak_flops_bf16 is None:
            return None
        return self.peak_flops_bf16 * self.num_devices


def gpu_topology(devices: Optional[Sequence] = None) -> GpuTopology:
    """Topology of ``devices`` (default: ``default_devices(0)``)."""
    from ..util.profiling import device_peak_flops
    if devices is None:
        devices = default_devices(0)
    devices = [torch.device(d) for d in devices]
    d0 = devices[0]
    name = torch.cuda.get_device_name(d0) if d0.type == "cuda" else "cpu"
    return GpuTopology(name=name, num_devices=len(devices), num_hosts=1,
                       devices_per_host=len(devices),
                       peak_flops_bf16=device_peak_flops(d0))
