"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas TPU kernel
on the port's path, each beside its plain PyTorch version:

  pdist.py     — pairwise squared distance (balanced k-means hot loop)
  spmv_bell.py — block-ELL SpMV (interior matvec of bell / dist_bell)
  flash.py     — flash attention forward (causal prefill of the LM stack)
  ref.py       — the plain versions; _build.py — nvcc build, launch counts
"""
