"""Kernel backend selection — which implementation serves each policy op.

  * ``reference`` — the plain PyTorch path (fake-quant float GEMMs, and
                    for quantize-once weights the exact integer product
                    in plain torch; gathered-view decode attention).
  * ``kernels``   — the hand-written Hopper kernels under ``csrc/``. A
                    wrapper given CUDA tensors launches its kernel or
                    raises; only a wrapper given CPU tensors runs the
                    kernel's plain version. Nothing falls back from a
                    kernel to its plain version on the card.

Op routing lives in ``kernels/dispatch.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["BACKENDS", "resolve", "resolve_device"]

BACKENDS = ("reference", "kernels")


def resolve(policy_backend: Optional[str]) -> str:
    """Concrete backend name for a policy's `backend` field."""
    name = policy_backend or "reference"
    if name not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; expected one of {BACKENDS}")
    return name


def resolve_device(device=None):
    """The device an entry point runs on: CUDA unless the caller asks for
    another device. Raises when CUDA is asked for and absent — an entry
    point never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
