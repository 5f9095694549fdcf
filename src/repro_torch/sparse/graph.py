"""CSR graph / sparse-matrix container (host NumPy, copied from
``src/repro/sparse/graph.py``; bit-equal to it).

The paper exploits the correspondence between a symmetric n x n matrix A and
an undirected graph G (Sec. II).  We store graphs in CSR with both edge
directions present (as ParMetis/Metis do), plus optional vertex coordinates
for the geometric partitioners.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    """Undirected graph in symmetric CSR.

    indptr:  (n+1,) int64
    indices: (m2,) int32   — column indices; m2 = 2 * #undirected-edges
    weights: (m2,) float32 — edge weights (1.0 for unweighted)
    coords:  (n, d) float32 or None — vertex coordinates for geometric methods
    """

    indptr: np.ndarray
    indices: np.ndarray
    weights: np.ndarray
    coords: np.ndarray | None = None

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        """Number of undirected edges."""
        return len(self.indices) // 2

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def dim(self) -> int:
        return 0 if self.coords is None else self.coords.shape[1]

    def validate(self) -> None:
        n = self.n
        assert self.indptr[0] == 0 and self.indptr[-1] == len(self.indices)
        assert np.all(np.diff(self.indptr) >= 0)
        assert self.indices.min(initial=0) >= 0
        assert self.indices.max(initial=-1) < n
        # symmetry: edge multiset must be symmetric
        src = np.repeat(np.arange(n), self.degrees)
        fwd = set(zip(src.tolist(), self.indices.tolist()))
        assert all((v, u) in fwd for (u, v) in fwd), "graph is not symmetric"

    def edge_list(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (src, dst, w) with both directions."""
        src = np.repeat(np.arange(self.n, dtype=np.int32), self.degrees)
        return src, self.indices, self.weights

    def _edge_positions(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """CSR positions of directed edges (u, v); raises on a missing
        edge.  Requires canonical (sorted-within-row) indices, which
        :func:`from_edges` guarantees."""
        u = np.asarray(u, dtype=np.int64)
        v = np.asarray(v, dtype=np.int64)
        src = np.repeat(np.arange(self.n, dtype=np.int64), self.degrees)
        keys = src * self.n + self.indices
        want = u * self.n + v
        pos = np.searchsorted(keys, want)
        ok = (pos < len(keys)) & (keys[np.minimum(pos, len(keys) - 1)]
                                  == want) if len(keys) else \
            np.zeros(len(want), dtype=bool)
        if not np.all(ok):
            bad = np.flatnonzero(~ok)[0]
            raise KeyError(f"edge ({u[bad]}, {v[bad]}) not in graph")
        return pos

    def add_edges(self, u: np.ndarray, v: np.ndarray,
                  w: np.ndarray | None = None) -> "Graph":
        """New graph with undirected edges (u, v) added.

        Follows :func:`from_edges` semantics: self-loops are dropped and
        an edge that already exists gets the weights *summed*.
        """
        u = np.asarray(u, dtype=np.int64)
        v = np.asarray(v, dtype=np.int64)
        w = (np.ones(len(u), dtype=np.float32) if w is None
             else np.asarray(w, dtype=np.float32))
        s0, d0, w0 = self.edge_list()
        return from_edges(self.n,
                          np.concatenate([s0, u, v]),
                          np.concatenate([d0, v, u]),
                          np.concatenate([w0, w, w]), coords=self.coords)

    def remove_edges(self, u: np.ndarray, v: np.ndarray) -> "Graph":
        """New graph with undirected edges (u, v) removed (must exist)."""
        u = np.asarray(u, dtype=np.int64)
        v = np.asarray(v, dtype=np.int64)
        kill = np.concatenate([self._edge_positions(u, v),
                               self._edge_positions(v, u)])
        keep = np.ones(len(self.indices), dtype=bool)
        keep[kill] = False
        s0, d0, w0 = self.edge_list()
        return from_edges(self.n, s0[keep], d0[keep], w0[keep],
                          coords=self.coords)

    def reweight_edges(self, u: np.ndarray, v: np.ndarray,
                       w: np.ndarray) -> "Graph":
        """New graph with undirected edges (u, v) set to weight w (both
        CSR directions; edges must exist).  Structure is shared — only
        the weight array is copied."""
        w = np.asarray(w, dtype=np.float32)
        weights = self.weights.copy()
        weights[self._edge_positions(u, v)] = w
        weights[self._edge_positions(v, u)] = w
        return Graph(indptr=self.indptr, indices=self.indices,
                     weights=weights, coords=self.coords)

    def subgraph(self, mask: np.ndarray) -> tuple["Graph", np.ndarray]:
        """Vertex-induced subgraph.  Returns (sub, old_ids)."""
        old_ids = np.nonzero(mask)[0]
        remap = -np.ones(self.n, dtype=np.int64)
        remap[old_ids] = np.arange(len(old_ids))
        src, dst, w = self.edge_list()
        keep = mask[src] & mask[dst]
        s2, d2, w2 = remap[src[keep]], remap[dst[keep]], w[keep]
        sub = from_edges(len(old_ids), s2, d2, w2,
                         coords=None if self.coords is None
                         else self.coords[old_ids])
        return sub, old_ids


def from_edges(n: int, src: np.ndarray, dst: np.ndarray,
               w: np.ndarray | None = None,
               coords: np.ndarray | None = None,
               symmetrize: bool = False) -> Graph:
    """Build CSR from an edge list.

    If ``symmetrize``, (u,v) implies (v,u); duplicate edges get their weights
    summed; self-loops are dropped.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if w is None:
        w = np.ones(len(src), dtype=np.float32)
    w = np.asarray(w, dtype=np.float32)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]
    # dedupe
    key = src * n + dst
    order = np.argsort(key, kind="stable")
    key, src, dst, w = key[order], src[order], dst[order], w[order]
    uniq, start = np.unique(key, return_index=True)
    w = np.add.reduceat(w, start) if len(w) else w
    src, dst = src[start], dst[start]

    counts = np.bincount(src, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return Graph(indptr=indptr, indices=dst.astype(np.int32),
                 weights=w.astype(np.float32), coords=coords)


def structure_graph(indptr, indices, data=None) -> Graph:
    """Off-diagonal structure of a canonical CSR matrix as a :class:`Graph`.

    Edge weights are |data| (or 1.0 when ``data`` is None).  Assumes a
    structurally symmetric matrix with sorted rows — e.g. the Laplacians
    this repo plans — so the CSR order can be reused directly, skipping
    the O(m log m) sort of :func:`from_edges`.  This is how the drift
    monitor prices a mutated matrix after every delta without paying a
    graph rebuild.
    """
    indptr = np.asarray(indptr)
    n = len(indptr) - 1
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    ind = np.asarray(indices)
    off = src != ind
    counts = np.bincount(src[off], minlength=n)
    new_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=new_indptr[1:])
    w = (np.ones(int(off.sum()), dtype=np.float32) if data is None
         else np.abs(np.asarray(data)[off]).astype(np.float32))
    return Graph(indptr=new_indptr, indices=ind[off].astype(np.int32),
                 weights=w)


def laplacian_csr(g: Graph, shift: float = 1e-3):
    """Graph Laplacian L = D - A, diagonal shifted to be positive definite
    (Sec. VI-a: 'we shift the diagonal of the Laplacian slightly').

    Returns CSR arrays (indptr, indices, data) including the diagonal.
    """
    n = g.n
    src, dst, w = g.edge_list()
    deg_w = np.zeros(n, dtype=np.float64)
    np.add.at(deg_w, src, w)
    # rows: off-diagonal -w, diagonal deg + shift
    all_src = np.concatenate([src, np.arange(n)])
    all_dst = np.concatenate([dst, np.arange(n)])
    all_val = np.concatenate([-w.astype(np.float64), deg_w + shift])
    order = np.lexsort((all_dst, all_src))
    all_src, all_dst, all_val = (all_src[order], all_dst[order],
                                 all_val[order])
    counts = np.bincount(all_src, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, all_dst.astype(np.int32), all_val.astype(np.float32)
