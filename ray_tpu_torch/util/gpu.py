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
"""
from __future__ import annotations

import shutil
import subprocess

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
