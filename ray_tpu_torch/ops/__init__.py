"""Attention ops of the port: plain PyTorch versions plus the hand-written
CUDA kernels that replace the TPU's Pallas kernels (``csrc/``)."""
from .flash_attention import flash_attention, mha_reference

__all__ = ["flash_attention", "mha_reference"]
