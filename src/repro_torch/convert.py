"""Convert a reference-package parameter tree into this package's tensors.

The input is the reference tree flattened to numpy on the caller's side:
nested dicts of numpy arrays, where a quantize-once weight arrives as the
dict {"data", "scale", "fmt", "n", "packed"}. bfloat16 arrays (numpy
dtype name 'bfloat16') keep their bits. Layouts are kept as they are —
[K, N] weights and the leading [L, ...] layer axis — so both packages'
GEMMs see the same operands.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.qtensor import QuantizedTensor

__all__ = ["from_numpy_tree", "QTENSOR_KEYS"]

QTENSOR_KEYS = frozenset({"data", "scale", "fmt", "n", "packed"})


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")        # own, writable memory
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_numpy_tree(tree, device="cpu"):
    """Nested dicts of numpy arrays (and quantized-leaf dicts) -> the same
    tree of torch tensors and `QuantizedTensor`s on `device`."""
    if isinstance(tree, dict):
        if set(tree) == QTENSOR_KEYS:
            return QuantizedTensor(_tensor(tree["data"], device),
                                   _tensor(tree["scale"], device),
                                   str(tree["fmt"]), int(tree["n"]),
                                   bool(tree["packed"]))
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    return _tensor(np.asarray(tree), device)
