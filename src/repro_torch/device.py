"""Device resolution and the port's default float dtype.

Entry points take ``device=None``, which means the card.  Without a card
they raise instead of falling back to the CPU: a caller that wants the CPU
(the tests do) passes ``device="cpu"``.

The JAX package runs with 64-bit mode off, so ``jnp.asarray`` narrows
float64 host data to float32 (``src/repro/sparse/operator.py:114-115``).
:func:`to_device` applies the same cast, so both packages compute in the
same dtype from the same host arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` without a GPU); any
    other value is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the "
                "CPU (the default is the card)")
        return torch.device("cuda")
    return torch.device(device)


def to_device(x, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``; float64 becomes float32 and
    other floats keep their dtype, as ``jnp.asarray`` does with x64 off.
    Integer arrays keep their dtype."""
    x = np.asarray(x)
    if x.dtype == np.float64:
        x = x.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def as_float(x) -> np.ndarray:
    """Host vector -> float ndarray (integers become float32), the
    reference's ``operator._as_float``."""
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.float32)
    return x
