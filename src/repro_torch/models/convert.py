"""The JAX package's parameter tree, as numpy arrays, into the port's
modules.

The reference keeps the layers stacked on a leading ``n_groups`` axis under
``tree["layers"]["<i>:<kind>"]`` (one group per repeating unit: ``"0:dense"``
for the dense family, ``"0:rec"``, ``"1:rec"``, ``"2:attn"`` for
RecurrentGemma) and the remainder layers unstacked under
``tree["rem"]["<j>:<kind>"]``; with tied embeddings there is no
``lm_head``.  The port's layer ``l`` is the group ``l // len(unit)`` of
``"<l % len(unit)>:<kind>"``, and past the groups remainder layer ``j``.
The audio family's tree (``src/repro/models/encdec.py``) stacks its
encoder and decoder layers under ``tree["enc"]`` and ``tree["dec"]``; the
port's ``enc.<l>`` / ``dec.<l>`` is entry ``l`` of those leaves.  Weights
are (in, out) for ``x @ W`` in both packages, so leaves copy over
unchanged.  An MoE layer placed by the reference's
``permute_expert_params`` carries a ``"perm"`` leaf beside its weights; it
becomes the port module's ``perm`` buffer.

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
from .encdec import EncDec
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


def _layer_tree(tree, cfg: ModelConfig, l: int):
    """(sub-tree, index into its stacked leaves or None) of layer ``l``."""
    U = len(cfg.unit)
    if l < cfg.n_groups * U:
        return tree["layers"][f"{l % U}:{cfg.unit[l % U]}"], l // U
    j = l - cfg.n_groups * U
    return tree["rem"][f"{j}:{cfg.remainder[j]}"], None


def _locate(tree, cfg: ModelConfig, parts: list[str]):
    """(sub-tree, keys below it, index into its stacked leaves or None) of
    the port's parameter ``".".join(parts)``."""
    if parts[0] == "layers":
        sub, index = _layer_tree(tree, cfg, int(parts[1]))
        return sub, parts[2:], index
    if parts[0] in ("enc", "dec"):
        return tree[parts[0]], parts[2:], int(parts[1])
    return tree, parts, None


def params_from_jax(tree, cfg: ModelConfig, device=None) -> LM | EncDec:
    """The reference's ``init_model`` params (numpy leaves) as an
    :class:`LM`, or for the audio family an :class:`EncDec`, on
    ``device`` (``None`` is the card)."""
    dev = resolve_device(device)
    make = EncDec if cfg.family == "audio" else LM
    model = make(cfg, ParamInit(None, _dtype(cfg), dev))
    for name, param in model.named_parameters():
        leaf, keys, index = _locate(tree, cfg, name.split("."))
        for key in keys:
            leaf = leaf[key]
        if index is not None:
            leaf = np.asarray(leaf)[index]
        _copy(param, leaf, name)
    if make is EncDec:
        return model
    for l, layer in enumerate(model.layers):
        sub, index = _layer_tree(tree, cfg, l)
        perm = sub["ffn"].get("perm") if "ffn" in sub else None
        if perm is not None:
            perm = np.asarray(perm)
            layer.ffn.perm = to_tensor(
                perm if index is None else perm[index], dev).long()
    return model
