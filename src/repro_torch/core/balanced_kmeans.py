"""Balanced k-means geometric partitioner (geoKM) — von Looz et al. ICPP'18,
used by the paper as Geographer's phase 1, with heterogeneous target block
weights (Algorithm 1 output).  The port of
``src/repro/core/balanced_kmeans.py`` (flat mode).

Method.  Minimize sum of squared point-center distances subject to per-block
target sizes tw_i.  Each center carries a multiplicative price gamma_i;
points choose argmin_i gamma_i * dist(x, c_i)^2.  Loads above target raise
the price, loads below lower it — a tatonnement that converges to blocks of
the requested sizes with compact shapes.

The loop runs on the device with a fixed trip count, as the reference's
``lax.fori_loop`` does: an (n, k) distance computation (the CUDA kernel of
``kernels/pdist.py`` under ``use_pallas=True``), argmin assignment,
``index_add_`` loads and centroids, and a price update.  Seeding and the
exact rebalance are host NumPy, copied from the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.pdist import pairwise_sqdist
from ..kernels.ref import pairwise_sqdist_ref
from ..sparse.graph import Graph
from .geometry import morton_codes, weighted_split_assignment


def _init_centers(coords: np.ndarray, tw: np.ndarray,
                  device: torch.device) -> np.ndarray:
    """SFC seeding: slice the Morton order at cumulative target weights and
    take each chunk's centroid (Geographer's initialization)."""
    codes = morton_codes(torch.from_numpy(coords).to(device)).cpu().numpy()
    order = np.argsort(codes, kind="stable")
    part = weighted_split_assignment(order, tw)
    k = len(tw)
    sums = np.zeros((k, coords.shape[1]), dtype=np.float64)
    np.add.at(sums, part, coords)
    counts = np.maximum(np.bincount(part, minlength=k), 1)
    return (sums / counts[:, None]).astype(np.float32)


def _bkm_loop(coords: torch.Tensor, centers: torch.Tensor, tw: torch.Tensor,
              iters: int, price_steps: int, price_lr: float = 0.18,
              use_pallas: bool = False):
    """The optimization loop on ``coords``' device.

    Per outer iteration: ``price_steps`` rounds of price adjustment under
    fixed centers (reusing the distance matrix), then one centroid update.
    ``use_pallas`` keeps the reference's flag name: it selects the
    hand-written distance kernel (``kernels.pdist``) over the plain form.
    Returns (part, centers, log_price).
    """
    n = coords.shape[0]
    k = centers.shape[0]
    dev = coords.device
    tw_frac = tw / tw.sum()
    ones = torch.ones(n, dtype=coords.dtype, device=dev)

    def sqdist(c):
        dist2 = (pairwise_sqdist(coords, c) if use_pallas
                 else pairwise_sqdist_ref(coords, c))
        # normalize so prices act on comparable scales
        return dist2 / (dist2.mean() + 1e-12)

    def assign(dist2, log_price):
        # log-domain multiplicative price; argmin takes the first minimum
        return torch.argmin(dist2 + log_price[None, :], dim=1)

    log_price = torch.zeros(k, dtype=coords.dtype, device=dev)
    for _ in range(iters):
        dist2 = sqdist(centers)
        for _ in range(price_steps):
            part = assign(dist2, log_price)
            load = torch.zeros(k, dtype=coords.dtype, device=dev)
            load.index_add_(0, part, ones)
            load_frac = load / n
            # raise price where overloaded, lower where underloaded
            log_price = log_price + price_lr * torch.log(
                (load_frac + 1e-6) / (tw_frac + 1e-6))
            log_price = log_price - log_price.mean()
        part = assign(dist2, log_price)
        sums = torch.zeros((k, coords.shape[1]), dtype=coords.dtype,
                           device=dev)
        sums.index_add_(0, part, coords)
        counts = torch.zeros(k, dtype=coords.dtype, device=dev)
        counts.index_add_(0, part, ones)
        new_centers = sums / counts.clamp(min=1.0)[:, None]
        # keep empty centers where they were
        centers = torch.where(counts[:, None] > 0, new_centers, centers)
    part = assign(sqdist(centers), log_price)
    return part, centers, log_price


def _exact_rebalance(coords: np.ndarray, centers: np.ndarray,
                     part: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """Post-pass: enforce sizes exactly (floor(tw) sum-preserving) by moving
    the cheapest vertices out of overloaded blocks to the nearest underloaded
    block.  Keeps compactness: candidates are those with the smallest
    (d_target^2 - d_own^2) regret.  Host NumPy, copied from the reference."""
    k = len(tw)
    want = np.round(tw).astype(np.int64)
    want[np.argmax(want)] += len(part) - want.sum()  # fix rounding drift
    d2 = ((coords[:, None, :] - centers[None, :, :]) ** 2).sum(-1) \
        if len(coords) * k <= 5_000_000 else None
    for _ in range(4 * k):
        sizes = np.bincount(part, minlength=k)
        over = np.nonzero(sizes > want)[0]
        under = np.nonzero(sizes < want)[0]
        if len(over) == 0:
            break
        b = over[np.argmax(sizes[over] - want[over])]
        members = np.nonzero(part == b)[0]
        if d2 is not None:
            regret = d2[members][:, under] - d2[members][:, b][:, None]
        else:
            dm = coords[members]
            d_own = ((dm - centers[b]) ** 2).sum(-1)
            d_tgt = ((dm[:, None, :] - centers[under][None]) ** 2).sum(-1)
            regret = d_tgt - d_own[:, None]
        flat = np.argsort(regret, axis=None, kind="stable")
        n_move = int(sizes[b] - want[b])
        moved = 0
        deficit = (want - sizes).clip(min=0)
        for f in flat:
            if moved >= n_move:
                break
            vi, uj = np.unravel_index(f, regret.shape)
            tgt = under[uj]
            if deficit[tgt] > 0 and part[members[vi]] == b:
                part[members[vi]] = tgt
                deficit[tgt] -= 1
                moved += 1
    return part


def partition_balanced_kmeans(g: Graph, tw: np.ndarray, seed: int = 0,
                              iters: int = 30, price_steps: int = 12,
                              exact: bool = True, use_pallas: bool = False,
                              device=None) -> np.ndarray:
    """geoKM: balanced k-means with heterogeneous target weights.  The loop
    runs on ``device`` (default the card); returns the (n,) int32 host
    partition."""
    if g.coords is None:
        raise ValueError("balanced k-means needs coordinates")
    device = resolve_device(device)
    tw = np.asarray(tw, dtype=np.float64)
    coords = np.asarray(g.coords, dtype=np.float32)
    centers0 = _init_centers(coords, tw, device)
    part, centers, _ = _bkm_loop(
        torch.from_numpy(coords).to(device),
        torch.from_numpy(centers0).to(device),
        torch.from_numpy(tw.astype(np.float32)).to(device),
        iters=iters, price_steps=price_steps, use_pallas=use_pallas)
    part = part.cpu().numpy().astype(np.int32)
    if exact:
        part = _exact_rebalance(coords, centers.cpu().numpy(), part, tw)
    return part
