"""Checkpoint save / restore for fault-tolerant training, ported from
``src/repro/train/checkpoint.py`` with its layout:

  * ``<ckpt_dir>/step_XXXXXXXX/`` holds ``state.npz`` (one array per
    path-keyed tensor) and ``manifest.json`` (step, time, keys, extras);
  * a save writes ``.tmp_step_XXXXXXXX/`` and renames it into place, so a
    crash mid-save never leaves a broken latest checkpoint;
  * the newest ``keep`` checkpoints are kept.

The state is a nest of dicts whose leaves are tensors or ``nn.Module``s (a
module contributes its named parameters and buffers).  Keys join the path
with ``/``: the trainer's state gives ``params/<name>``, ``opt/m/<name>``,
``opt/v/<name>`` and ``opt/step``.  numpy has no bfloat16, so a bf16
tensor is stored as a ``uint16`` view of its bits and the manifest's
``dtypes`` records it; a restore reads the view back bit for bit.

A restore copies into the tensors of ``state_like`` in place (a trainer's
model and optimizer keep their storage and device) and raises
``ValueError`` on a shape mismatch and ``KeyError`` on a missing key, as
the reference does.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn


def flatten_state(state, prefix: str = "") -> dict[str, torch.Tensor]:
    """{path: tensor} of every leaf of ``state``, in order."""
    if isinstance(state, torch.Tensor):
        return {prefix: state}
    if isinstance(state, nn.Module):
        items = [*state.named_parameters(), *state.named_buffers()]
        return {f"{prefix}/{n}" if prefix else n: t for n, t in items}
    if isinstance(state, dict):
        out: dict[str, torch.Tensor] = {}
        for k, v in state.items():
            out.update(flatten_state(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    raise TypeError(f"checkpoint: cannot store a {type(state).__name__} "
                    f"at {prefix!r}")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(ckpt_dir: str | Path, state, step: int,
                    extra: dict | None = None, keep: int = 3) -> Path:
    """Write ``state`` as ``step_<step>`` under ``ckpt_dir`` (atomically),
    then delete all but the newest ``keep`` checkpoints.  Returns the
    checkpoint's directory."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    final = ckpt_dir / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    flat = flatten_state(state)
    np.savez(tmp / "state.npz", **{k: _to_numpy(t) for k, t in flat.items()})
    dtypes = {k: "bfloat16" for k, t in flat.items()
              if t.dtype == torch.bfloat16}
    manifest = {"step": step, "time": time.time(), "keys": sorted(flat),
                "dtypes": dtypes, **(extra or {})}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _checkpoints(ckpt_dir: Path) -> list[Path]:
    return sorted(p for p in ckpt_dir.iterdir()
                  if re.fullmatch(r"step_\d{8}", p.name))


def _gc(ckpt_dir: Path, keep: int):
    for p in _checkpoints(ckpt_dir)[:-keep]:
        shutil.rmtree(p)


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    ckpts = _checkpoints(ckpt_dir)
    return ckpts[-1] if ckpts else None


def restore_checkpoint(path: str | Path, state_like):
    """Restore into the tensors of ``state_like``, in place.  Returns
    (state_like, manifest)."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    bf16 = manifest.get("dtypes", {})
    flat = flatten_state(state_like)
    with np.load(path / "state.npz") as data:
        arrays = {}
        for key, t in flat.items():
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{key}: checkpoint {arr.shape} != "
                                 f"{tuple(t.shape)}")
            if bf16.get(key) == "bfloat16":
                src = torch.from_numpy(np.array(arr.view(np.int16))
                                       ).view(torch.bfloat16)
            else:
                src = torch.from_numpy(np.array(arr))
            arrays[key] = src
    with torch.no_grad():
        for key, t in flat.items():
            t.copy_(arrays[key])
    return state_like, manifest
