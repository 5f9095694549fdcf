"""Halo-round scheduling (host NumPy, copied from
``src/repro/core/refinement.py`` and bit-equal to it): only the
Misra-Gries edge coloring that ``sparse.distributed.build_plan`` uses.  The
FM refinement passes wait for the geoRef slice (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import numpy as np


def vizing_edge_coloring(pairs: np.ndarray,
                         weights: np.ndarray | None = None) -> np.ndarray:
    """Misra–Gries edge coloring: guaranteed <= maxdeg + 1 colors (Vizing's
    bound).  Returns a color per edge.

    Used for the halo-exchange round schedule in ``sparse.distributed``:
    each color class is a matching = one ppermute round, so the Delta+1
    guarantee bounds the number of rounds by quotient-graph degree + 1
    (greedy only guarantees 2*Delta - 1).  Colors are relabeled so the
    heaviest class (largest total communication volume) is round 0 —
    preserving the heaviest-first scheduling of :func:`greedy_edge_coloring`
    at class granularity.

    O(V * E) on the quotient graph — V = #blocks, tiny by construction.
    """
    m = len(pairs)
    if m == 0:
        return np.zeros(0, np.int32)
    pairs = np.asarray(pairs, dtype=np.int64)
    # at[x]: color -> (edge index, neighbor); edge_color[e] current color
    at: dict[int, dict[int, tuple[int, int]]] = {}
    for u in np.unique(pairs):
        at[int(u)] = {}
    edge_color = -np.ones(m, dtype=np.int32)
    deg = np.bincount(pairs.ravel())
    C = int(deg.max()) + 1                      # palette 0..Delta

    def free(x: int) -> int:
        cx = at[x]
        for c in range(C):
            if c not in cx:
                return c
        raise AssertionError("no free color — palette too small")

    def set_color(e: int, c: int) -> None:
        u, v = int(pairs[e, 0]), int(pairs[e, 1])
        old = int(edge_color[e])
        if old >= 0:
            at[u].pop(old, None)
            at[v].pop(old, None)
        edge_color[e] = c
        at[u][c] = (e, v)
        at[v][c] = (e, u)

    order = (np.argsort(-np.asarray(weights), kind="stable")
             if weights is not None else np.arange(m))
    for e in map(int, order):
        u, v = int(pairs[e, 0]), int(pairs[e, 1])
        # maximal fan of u starting at v
        fan = [v]
        in_fan = {v}
        while True:
            last = fan[-1]
            nxt = None
            for c_, (_e2, nbr) in at[u].items():
                if nbr not in in_fan and c_ not in at[last]:
                    nxt = nbr
                    break
            if nxt is None:
                break
            fan.append(nxt)
            in_fan.add(nxt)
        c = free(u)
        d = free(fan[-1])
        if c != d and d in at[u]:
            # invert the maximal cd-path starting at u.  Two phases (clear
            # all, then recolor all): flipping in place would transiently
            # alias two path edges onto one color at their shared endpoint
            # and the second flip would pop the first one's fresh entry.
            path = []
            x, need = u, d
            while need in at[x]:
                e2, nbr = at[x][need]
                path.append((e2, need))
                x, need = nbr, (c if need == d else d)
            for e2, col in path:
                a, b = int(pairs[e2, 0]), int(pairs[e2, 1])
                at[a].pop(col)
                at[b].pop(col)
                edge_color[e2] = -1
            for e2, col in path:
                set_color(e2, c if col == d else d)
        # w = first fan vertex with d free whose prefix is still a fan
        # (the inversion can break the fan property at one point; the lemma
        # guarantees a valid w exists at or before it)
        ucol_of = {nb: (cc, ee) for cc, (ee, nb) in at[u].items()}
        w_i = None
        for i, fv in enumerate(fan):
            if d not in at[fv]:
                w_i = i
                break
            if i + 1 < len(fan):
                nxt = ucol_of.get(fan[i + 1])
                if nxt is None or nxt[0] in at[fv]:
                    break                      # fan broken by the inversion
        assert w_i is not None, "Misra–Gries invariant violated"
        # rotate fan[0:w_i]: shift each (u, fan[i+1]) color onto (u, fan[i]);
        # the uncolored u-edge walks along the fan as colors shift down
        uncol = e                              # edge u–fan[0]
        for i in range(w_i):
            c_next, e_next = ucol_of[fan[i + 1]]
            edge_color[e_next] = -1
            at[u].pop(c_next)
            at[fan[i + 1]].pop(c_next)
            set_color(uncol, c_next)           # colors edge u–fan[i]
            uncol = e_next                     # u–fan[i+1] now uncolored
        set_color(uncol, d)

    # relabel so the heaviest color class is round 0
    w_arr = (np.asarray(weights, dtype=np.float64) if weights is not None
             else np.ones(m))
    n_col = int(edge_color.max()) + 1
    class_w = np.zeros(n_col)
    np.add.at(class_w, edge_color, w_arr)
    relabel = np.empty(n_col, dtype=np.int32)
    relabel[np.argsort(-class_w, kind="stable")] = np.arange(n_col)
    return relabel[edge_color].astype(np.int32)
