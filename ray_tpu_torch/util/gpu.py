"""GPU identity labels for a node, found without opening a CUDA context.

The port's counterpart of ``ray_tpu/util/tpu.py``'s
``discover_tpu_labels``: a node agent labels its node with the kind and
count of the cards its host holds, so that placement can select on them
(``label_selector={"rtpu.gpu.kind": ...}``). The labels come from
``nvidia-smi``, queried with a timeout, never from ``torch.cuda``: the
agent must not touch CUDA (a context would hold device memory for the
agent's whole life, and CUDA reads ``CUDA_VISIBLE_DEVICES`` once per
process). Without ``nvidia-smi`` on ``PATH``, or when it fails, there are
no labels.

``compute_apps`` reads, the same way, the compute processes each card
lists: the head holds a dead worker's GPU lease until its card no longer
lists it (``core/runtime.py`` ``_release_gpus_after_card``).
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Optional

KIND_LABEL = "rtpu.gpu.kind"      # e.g. "NVIDIA H100 80GB HBM3"
COUNT_LABEL = "rtpu.gpu.count"    # cards on the host, e.g. "4"


def discover_gpu_labels(timeout_s: float = 10.0) -> dict[str, str]:
    """{KIND_LABEL, COUNT_LABEL} of this host's cards, or {} when
    ``nvidia-smi`` is absent, fails, times out or lists no card."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return {}
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=timeout_s, check=True)
    except (OSError, subprocess.SubprocessError):
        return {}
    names = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if not names:
        return {}
    return {KIND_LABEL: names[0], COUNT_LABEL: str(len(names))}


def _query(exe: str, query: str, timeout_s: float) -> list[list[str]]:
    out = subprocess.run(
        [exe, query, "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=timeout_s, check=True)
    return [[f.strip() for f in ln.split(",")]
            for ln in out.stdout.splitlines() if ln.strip()]


def compute_apps(timeout_s: float = 5.0
                 ) -> Optional[dict[int, list[tuple[int, int]]]]:
    """{card index: [(pid, used MiB), ...]} of the compute processes that
    ``nvidia-smi --query-compute-apps=pid,gpu_uuid,gpu_bus_id,used_memory``
    lists, mapped to indices through ``--query-gpu=index,uuid,pci.bus_id``
    (every index lists no process on a card-less host); None when
    ``nvidia-smi`` is absent, fails or times out.

    Each card is known by its (uuid, bus id) pair. Where the pairs do not
    tell the cards apart (a container may redact both), a process is listed
    on every index. Inside a container's PID namespace the pids are the
    host's, not the reader's: callers cannot always find a process of
    theirs by its pid, but a process's entry still appears when it opens
    the card and leaves when the card has freed its memory."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        cards = _query(exe, "--query-gpu=index,uuid,pci.bus_id", timeout_s)
        apps = _query(exe, "--query-compute-apps=pid,gpu_uuid,gpu_bus_id,"
                      "used_memory", timeout_s)
    except (OSError, subprocess.SubprocessError):
        return None
    try:
        index = {tuple(c[1:3]): int(c[0]) for c in cards}
        out: dict[int, list[tuple[int, int]]] = {int(c[0]): []
                                                 for c in cards}
        for a in apps:
            pid = int(a[0])
            mib = int(a[3]) if a[3].isdigit() else 0
            at = ([index[tuple(a[1:3])]] if len(index) == len(cards)
                  and tuple(a[1:3]) in index else list(out))
            for i in at:
                out[i].append((pid, mib))
    except (ValueError, IndexError):
        return None
    return out
