"""The JAX package's parameter tree, as numpy arrays, into the port's
modules.

The reference keeps the layers stacked on a leading ``n_groups`` axis under
``tree["layers"]["<i>:<kind>"]`` (one group per repeating unit; for the
dense family the unit is one layer) and leftover layers under
``tree["rem"]``; with tied embeddings there is no ``lm_head``.  Weights are
(in, out) for ``x @ W`` in both packages, so leaves copy over unchanged.

bfloat16 leaves arrive as ``ml_dtypes`` arrays, which ``torch.from_numpy``
refuses; they go through a ``uint16`` view of the same bits.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .common import ParamInit
from .config import ModelConfig
from .transformer import LM, _dtype


def to_tensor(a, device) -> torch.Tensor:
    """numpy (float32, float64, integer or ml_dtypes bfloat16) -> tensor
    on ``device``, same dtype, same bits."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:           # e.g. a view of a JAX buffer
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _copy(param: nn.Parameter, leaf, name: str) -> None:
    t = to_tensor(leaf, param.device)
    if tuple(t.shape) != tuple(param.shape) or t.dtype != param.dtype:
        raise ValueError(f"{name}: reference leaf {tuple(t.shape)} "
                         f"{t.dtype} does not fit {tuple(param.shape)} "
                         f"{param.dtype}")
    param.data.copy_(t)


def load_tree(module: nn.Module, tree) -> nn.Module:
    """Fill every parameter of ``module`` from the nested dict ``tree``
    whose keys are the parameter names split on dots (an attention, MLP or
    norm sub-tree of the reference)."""
    for name, param in module.named_parameters():
        leaf = tree
        for key in name.split("."):
            leaf = leaf[key]
        _copy(param, leaf, name)
    return module


def params_from_jax(tree, cfg: ModelConfig, device=None) -> LM:
    """The reference's ``init_model`` params (numpy leaves) as an
    :class:`LM` on ``device`` (``None`` is the card)."""
    dev = resolve_device(device)
    model = LM(cfg, ParamInit(None, _dtype(cfg), dev))
    stacked = tree["layers"]["0:dense"]
    for name, param in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            leaf = stacked
            for key in parts[2:]:
                leaf = leaf[key]
            leaf = np.asarray(leaf)[int(parts[1])]
        else:
            leaf = tree
            for key in parts:
                leaf = leaf[key]
        _copy(param, leaf, name)
    return model
