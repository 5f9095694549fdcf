"""Single-device SpMV building blocks.

  * padded-COO — (rows, cols, vals) each (nnz_pad,); padding entries carry
    value 0.  The converters are host NumPy copied from
    ``src/repro/sparse/spmv.py`` (bit-equal); ``spmv_coo`` is the port of
    its segment-sum matvec as one ``index_add_``.
  * block-ELL  — see ``kernels/spmv_bell.py`` (the CUDA kernel).
"""
from __future__ import annotations

import numpy as np
import torch


def csr_to_padded_coo(indptr: np.ndarray, indices: np.ndarray,
                      data: np.ndarray, nnz_pad: int | None = None):
    """CSR -> padded COO (rows, cols, vals); padded entries have val 0.
    ``vals`` keeps the dtype of ``data`` (float dtypes pass through;
    anything non-float is promoted to float32)."""
    n = len(indptr) - 1
    nnz = len(indices)
    nnz_pad = nnz_pad or nnz
    data = np.asarray(data)
    vdt = data.dtype if np.issubdtype(data.dtype, np.floating) \
        else np.float32
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
    out_r = np.zeros(nnz_pad, dtype=np.int32)
    out_c = np.zeros(nnz_pad, dtype=np.int32)
    out_v = np.zeros(nnz_pad, dtype=vdt)
    out_r[:nnz], out_c[:nnz], out_v[:nnz] = rows, indices, data
    return out_r, out_c, out_v


def spmv_coo(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """y = A @ x for padded COO, in the dtype of ``vals``.  ``x`` may carry
    a trailing RHS-batch axis (``(n, nb)``).  On the card ``index_add_``
    adds atomically, so the order of the sums (and the last bits) varies
    from run to run."""
    n = n if n is not None else x.shape[0]
    contrib = vals.reshape(vals.shape + (1,) * (x.dim() - 1)) * x[cols]
    y = torch.zeros((n,) + tuple(x.shape[1:]), dtype=vals.dtype,
                    device=x.device)
    return y.index_add_(0, rows, contrib)


def csr_diagonal(indptr: np.ndarray, indices: np.ndarray,
                 data: np.ndarray) -> np.ndarray:
    """(n,) diagonal of a CSR matrix (duplicates summed) — feeds the
    Jacobi preconditioner of ``cg.cg_solve``.  Keeps the dtype of
    ``data``.  Vectorized NumPy."""
    n = len(indptr) - 1
    data = np.asarray(data)
    vdt = data.dtype if np.issubdtype(data.dtype, np.floating) \
        else np.float32
    src = np.repeat(np.arange(n), np.diff(indptr))
    on_diag = src == np.asarray(indices)
    d = np.zeros(n, dtype=vdt)
    np.add.at(d, src[on_diag], data[on_diag])
    return d
