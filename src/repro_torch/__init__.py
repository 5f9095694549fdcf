"""PyTorch + CUDA port of the LDHT pipeline for one NVIDIA Hopper GPU.

A package beside ``repro`` (the JAX reference), with its layout: ``core``
(topology, Algorithm 1, geoKM), ``sparse`` (graphs, operators, CG, the
distributed plan and its stacked runtime) and ``kernels`` (hand-written CUDA
for ``sm_90a``, each beside its plain PyTorch version).  It imports neither
``jax`` nor ``repro``.

Entry points (``core.api.partition``, ``sparse.operator.make_operator``,
``sparse.distributed.build_plan``, ``sparse.operator.cg_solve_global``) run
on the card unless the caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
