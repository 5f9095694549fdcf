"""LDHT expert placement for a MoE layer on the PyTorch port -- the paper's
Algorithm 1 + swap refinement applied to the olmoe-style expert-parallel
layer (the port of ``examples/moe_expert_placement.py``, at its sizes).

Pipeline (mirrors the paper's two-stage LDHT process, Sec. IV):
  1. profile routing on a calibration batch -> expert loads + co-activation,
  2. stage 1: Algorithm 1 computes per-rank load budgets from PU speeds,
  3. stage 2: LPT greedy + pairwise-swap refinement places experts under
     the exact E_loc slot constraint (the 'memory capacity' Eq. 3),
  4. apply the placement: permute the stacked expert weights and carry the
     routing permutation in the module,
  5. verify numerics are unchanged and report the Eq. 2 objective.

Run:  PYTHONPATH=src python examples/moe_expert_placement_torch.py
      [--device cpu]      (default: the card; raises without one)
"""
import argparse

import numpy as np
import torch

from repro_torch.core.expert_placement import (coactivation_graph,
                                               expert_loads, place_experts,
                                               permute_expert_params)
from repro_torch.core.topology import PU, Topology
from repro_torch.device import resolve_device
from repro_torch.models.common import ParamInit
from repro_torch.models.mlp import init_moe, moe_forward, route

B, S, D, E, K, F = 8, 64, 64, 16, 4, 128
EP = 4                                   # expert-parallel ranks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    moe = init_moe(ParamInit(gen, torch.float32, dev), D, E, F)

    # 1. calibration: run the router, collect top-k statistics
    x = torch.randn((B, S, D), generator=gen, device=dev)
    _, _, topk = route(moe, x, K)
    ids = topk.reshape(-1, K).cpu().numpy()
    counts = np.bincount(ids.ravel(), minlength=E)
    loads = expert_loads(counts)
    coact = coactivation_graph(ids, E)
    print(f"expert load spread: min={loads.min():.4f} max={loads.max():.4f}")

    # 2+3. heterogeneous EP ranks: one 2x-speed rank (e.g. a newer chip
    # generation in the serving pool) and three baseline ranks
    topo = Topology(pus=[PU(speed=2.0, memory=1e9)]
                    + [PU(speed=1.0, memory=1e9) for _ in range(EP - 1)])
    res = place_experts(loads, topo, coact=coact)
    print(f"rank loads: {np.round(res.load_per_rank, 4)} "
          f"(speeds {topo.speeds})")
    print(f"Eq.2 max load/speed: {res.max_load_ratio:.4f}  "
          f"(uniform contiguous placement: "
          f"{(loads.reshape(EP, -1).sum(1) / topo.speeds).max():.4f})")
    print(f"Eq.1 co-activation cut: {res.coact_cut:.1f}")

    # 4. apply placement
    y0, _ = moe_forward(moe, x, n_experts=E, top_k=K, impl="dense")
    permute_expert_params(moe, res.perm)
    y1, _ = moe_forward(moe, x, n_experts=E, top_k=K, impl="dense")

    # 5. verify
    err = float((y0 - y1).abs().max())
    print(f"placement numerics max|y0-y1| = {err:.2e} on {dev}")
    if not err < 1e-5:
        raise SystemExit(f"placement changed the output by {err}")
    print("OK — placement is numerics-neutral and load-balanced.")


if __name__ == "__main__":
    main()
