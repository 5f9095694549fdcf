// Block-ELL SpMV for Hopper (sm_90a), stacked over PU blocks:
//
//   y[k, s*BM + m] = sum_b sum_t blocks[k, s, b, m, t] * x[k, cols[k, s, b]*BK + t]
//
// with x read as zero past its length n (the TPU kernel's zero-padded panels).
//
// Replaces the Pallas TPU kernel src/repro/kernels/spmv_bell.py
// (_spmv_block_ell).  The TPU version walks a sequential (S, NNZB) grid and
// carries the stripe sum in the output block across the NNZB axis; blocks on
// Hopper run in no order, so the NNZB walk becomes a loop inside one CTA.
// One CTA per (PU block k, stripe s) -- k is the outer grid axis (blockIdx.y)
// so one launch covers the whole stacked (K, S, NNZB, BM, BK) form of a
// distributed plan; the single-device operator is the K = 1 case.  Warp m of
// the CTA owns row m of the stripe: each lane reads BK/32 entries of the
// block row and of the x panel (both coalesced), keeps a running partial in
// the blocks' dtype, and one shuffle reduction per row ends the stripe.
//
// Bound: bytes.  Every block entry is read once and used for one FMA, so
// the kernel streams the (K, S, NNZB, BM, BK) array from DRAM at 2 flops per
// element -- far below the card's flop/byte ratio.  The x panel is re-read by
// the BM warps of a CTA, which L1 serves.
//
// Plain C interface: launched on the caller's stream, returns the
// cudaGetLastError() code of the launch.
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void spmv_bell_kernel(const T* __restrict__ blocks,
                                 const int* __restrict__ cols,
                                 const T* __restrict__ x, T* __restrict__ y,
                                 int S, int nnzb, int bm, int bk,
                                 long long n) {
  const int s = blockIdx.x;
  const long long kk = blockIdx.y;
  const int m = threadIdx.y;
  const int lane = threadIdx.x;
  const long long stripe = kk * S + s;
  const T* xk = x + kk * n;
  const int* ck = cols + stripe * nnzb;
  const T* a = blocks + stripe * (long long)nnzb * bm * bk + (long long)m * bk;
  T acc = T(0);
  for (int b = 0; b < nnzb; ++b) {
    const long long base = (long long)ck[b] * bk;
    const T* ab = a + (long long)b * bm * bk;
    for (int t = lane; t < bk; t += 32) {
      const long long col = base + t;
      const T xv = col < n ? xk[col] : T(0);
      acc += ab[t] * xv;
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  const long long row = (long long)s * bm + m;
  if (lane == 0 && row < n) y[kk * n + row] = acc;
}

template <typename T>
int launch(const void* blocks, const void* cols, const void* x, void* y,
           int K, int S, int nnzb, int bm, int bk, long long n, void* stream) {
  if (K == 0 || S == 0) return 0;
  const dim3 grid((unsigned)S, (unsigned)K);
  const dim3 block(32, (unsigned)bm);
  spmv_bell_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)blocks, (const int*)cols, (const T*)x, (T*)y, S, nnzb, bm, bk,
      n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spmv_bell_f32(const void* blocks, const void* cols,
                             const void* x, void* y, int K, int S, int nnzb,
                             int bm, int bk, long long n, void* stream) {
  return launch<float>(blocks, cols, x, y, K, S, nnzb, bm, bk, n, stream);
}

extern "C" int spmv_bell_f64(const void* blocks, const void* cols,
                             const void* x, void* y, int K, int S, int nnzb,
                             int bm, int bk, long long n, void* stream) {
  return launch<double>(blocks, cols, x, y, K, S, nnzb, bm, bk, n, stream);
}
