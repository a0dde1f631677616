"""Step profiling: first-dispatch-vs-later wall split, FLOPs -> MFU.

Counterpart of ``ray_tpu/util/profiling.py``. Three pieces:

- :class:`StepProfiler` — per-step wall-clock accounting, kept exactly
  as the reference's: the first step seen for a (kind, static key) pair
  books as "compile", later ones as "execute", and ``record_compile``
  books an explicitly measured one (the paged engine's warmup). In eager
  PyTorch nothing is compiled per key, so here the split means "first
  dispatch at a key" against "later dispatches": the first one carries
  the allocator's and the library handles' first-use costs, and the CUDA
  kernel library itself is built (or loaded) once, at engine warmup.
  Every step also lands in the flight recorder (STEP_BEGIN/STEP_END).
- FLOPs estimation — ``compiled_flops(fn, *args)`` runs ``fn`` once
  under ``torch.utils.flop_counter.FlopCounterMode`` and returns the
  FLOPs it counted (the reference lowers and compiles out of band and
  reads XLA's ``cost_analysis()``). The counter sees dispatcher ops
  only: a hand-written kernel called through ``ctypes`` (the ragged
  paged attention kernel on the card) is invisible to it, so an
  estimate leaves that work out and MFU understates, never inflates.
  :func:`mfu` divides by wall time and the device's peak, from a table
  keyed by the CUDA device name (CPU or an unknown card -> None, MFU
  then reports None rather than a made-up number).
- Optional ``torch.profiler`` capture — :func:`trace` wraps a block in a
  TensorBoard-loadable trace when a directory is given, and is a no-op
  otherwise, so call sites can leave the hook in place unconditionally.

Profilers are cheap enough to leave attached (two perf_counter reads and
two flight events per step); FLOPs estimation runs the program once
more, so it runs only when explicitly requested.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Optional

import torch

from ..core import flight

# dense bf16 tensor-core peak FLOP/s by CUDA device-name substring
# (NVIDIA's H100 SXM data sheet, at the full 700 W power limit)
_PEAK_FLOPS = (
    ("H100", 989e12),
)

# StepProfiler kind codes for the flight ring (exported by name)
STEP_KINDS = {"prefill": 0, "decode": 1, "verify": 2, "update": 3,
              "train": 4, "other": 5}


def device_peak_flops(device=None) -> Optional[float]:
    """Per-device peak bf16 FLOP/s, or None when unknown (CPU, a card
    not in the table): MFU must be honest, not guessed. ``device`` is a
    torch device (or its name); None means the current CUDA device."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    index = None if device is None else torch.device(device).index
    name = torch.cuda.get_device_name(index)
    for key, peak in _PEAK_FLOPS:
        if key.lower() in name.lower():
            return peak
    return None


def compiled_flops(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call of ``fn`` at these args, counted by running it
    once under ``FlopCounterMode`` (the program runs: call once, cache
    the result). Ops outside the dispatcher (a ``ctypes`` kernel) are
    not counted. None when the counter saw no FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    total = counter.get_total_flops()
    return float(total) if total else None


def mfu(flops_per_step: Optional[float], step_seconds: float,
        n_devices: int = 1, peak: Optional[float] = None) -> Optional[float]:
    """Model FLOPs utilization for one step, or None when either the
    FLOPs or the device peak is unknown."""
    peak = peak if peak is not None else device_peak_flops()
    if not flops_per_step or not peak or step_seconds <= 0:
        return None
    return flops_per_step / (step_seconds * peak * max(1, n_devices))


class StepProfiler:
    """Wall-clock accounting for a family of dispatched steps.

    ``with prof.step("decode", key):`` times one step; the first step
    seen for a (kind, key) pair is booked as compile time, later ones as
    execute time. ``record_compile`` books an explicitly measured one
    (warmup paths). ``attach_flops`` stores a FLOPs-per-step estimate so
    ``summary()`` can report MFU. ``device`` picks the peak MFU divides
    by (None: the current CUDA device, if any).
    """

    def __init__(self, name: str = "step", n_devices: int = 1,
                 device=None):
        self.name = name
        self.n_devices = max(1, n_devices)
        self.compile_s = 0.0
        self.execute_s = 0.0
        self.compiles = 0
        self.steps = 0
        self.flops_per_step: dict[str, float] = {}
        self.steps_by_kind: dict[str, int] = {}
        self._steps_by_tag: dict[tuple, int] = {}
        self._flops_by_tag: dict[tuple, float] = {}
        self._seen: set = set()
        self._peak = device_peak_flops(device)

    @contextlib.contextmanager
    def step(self, kind: str = "other", key: Any = None):
        code = STEP_KINDS.get(kind, STEP_KINDS["other"])
        flight.evt(flight.STEP_BEGIN, code)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            flight.evt(flight.STEP_END, code)
            tag = (kind, key)
            if tag not in self._seen:
                # first dispatch at this static key
                self._seen.add(tag)
                self.compile_s += dt
                self.compiles += 1
            else:
                self.execute_s += dt
                self.steps += 1
                self.steps_by_kind[kind] = \
                    self.steps_by_kind.get(kind, 0) + 1
                self._steps_by_tag[tag] = \
                    self._steps_by_tag.get(tag, 0) + 1

    def record_compile(self, seconds: float, kind: str = "other",
                       key: Any = None) -> None:
        """Book an explicitly measured first dispatch (e.g. warmup) and
        mark its key warm so the next timed step counts as execute."""
        self.compile_s += seconds
        self.compiles += 1
        self._seen.add((kind, key))

    def executed_tags(self) -> list:
        """(kind, key) tags with at least one EXECUTED step (compiles
        excluded) — what a length-aware FLOPs estimator should cost."""
        return sorted(self._steps_by_tag, key=repr)

    def attach_flops(self, kind: str, flops: Optional[float],
                     key: Any = None) -> None:
        """Record a FLOPs-per-step estimate for steps of ``(kind, key)``.
        The key must be the SAME static key those steps time under: an
        estimate taken at one shape must not be credited to dispatches
        at another (an 8-row prefill estimate applied to 1-row steps
        would inflate MFU ~8x). Steps at unestimated keys contribute
        wall but no FLOPs — MFU understates, never overstates.

        ``summary()['flops_per_step'][kind]`` keeps the LARGEST estimate
        attached for the kind (the widest program) as the representative
        per-step cost; MFU always uses the exact per-tag estimates."""
        if flops:
            self.flops_per_step[kind] = max(
                float(flops), self.flops_per_step.get(kind, 0.0))
            self._flops_by_tag[(kind, key)] = float(flops)

    def summary(self) -> dict:
        per_step = (self.execute_s / self.steps) if self.steps else None
        # MFU over the whole execute window: flops actually performed
        # (per-(kind, static-key) flops x matching executed steps) over
        # total execute wall. Steps at unestimated tags contribute wall
        # but no flops, so a partial estimate UNDERstates MFU.
        done_flops = sum(
            f * self._steps_by_tag.get(tag, 0)
            for tag, f in self._flops_by_tag.items()) or None
        return {
            "name": self.name,
            "compile_s": round(self.compile_s, 6),
            "execute_s": round(self.execute_s, 6),
            "compiles": self.compiles,
            "steps": self.steps,
            "steps_by_kind": dict(self.steps_by_kind) or None,
            "step_wall_s": per_step,
            "flops_per_step": self.flops_per_step or None,
            "peak_flops": self._peak,
            # no peak for this profiler's device (CPU): None, never the
            # peak of some other device mfu() would look up
            "mfu": (mfu(done_flops, self.execute_s, self.n_devices,
                        self._peak)
                    if self.execute_s and self._peak else None),
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` capture around a block, written for
    TensorBoard into ``log_dir`` when it is set (CUDA activity included
    when a card is present); a no-op otherwise (leave the hook
    unconditional at call sites)."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
