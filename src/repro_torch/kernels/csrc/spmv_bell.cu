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
// spmv_bell_multi: the same product for an RHS batch, Y = A @ X with X
// (n, nb) row-major (the batched CG keeps the batch axis last) -- the TPU
// kernel under the reference's jax.vmap over columns (sparse/cg.py), which
// streams every block once per column.  Here a CTA reads each (BM, BK)
// block once for all nb columns: one CTA per stripe, warp m on stripe row
// m, and C accumulators per lane (one per column of a chunk of C <= 16
// columns, C the power of two at or above nb).  For each block a lane
// issues the loads of its U = 4 entries of the block row (BK / 32 of them
// at BK 128) before it uses any, then reads the X row of each entry that
// is not zero: C contiguous values (16-byte loads where nb is a multiple
// of C and the row is aligned).  (Issuing all NNZB * BK / 32 entries of
// the row at once measured slower: more registers, fewer CTAs per SM.)
// The reference's layout is mostly zeros (1% of the bm 8 x bk 128 blocks of
// a 5-point Laplacian); the first version of this kernel read the X row
// of every entry, and those reads, 8 warps to a panel through L1, took 7x
// the block stream's time at nb = 16.  A zero entry still has to give
// 0 * Inf = NaN where X holds an Inf or NaN, as the dense product does:
// a first pass over X (its bytes once, a few percent of the blocks') sets
// a flag when any value is not finite, and a flagged launch reads the X
// row of every entry.  One xor-shuffle reduction per column leaves every
// sum in every lane, and lane j stores column j, so the Y row is one
// coalesced store.  Wider batches (the reference's exact-width oversize
// class) loop over column chunks, re-reading the stripe's blocks.  A
// single column (nb = 1, the service's first size class) is the
// single-column kernel's case: X (n, 1) is its x, and it runs it (its one
// accumulator per lane and dense reads measured faster there).  Bound:
// bytes, the block array once (at most 2 flops per element and column,
// below the card's flop/byte ratio up to nb = 16).
//
// Plain C interface: launched on the caller's stream, returns the
// cudaGetLastError() code of the launch.
#include <cstdint>

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

// C values of one X row from xr; columns at or past cn read as zero.
template <typename T, int C, bool VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ xr, int cn,
                                         T (&xv)[C]) {
  if constexpr (VEC) {                 // cn == C, xr 16-byte aligned
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int j = 0; j < C; j += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(xr + j));
        xv[j] = v.x;
        xv[j + 1] = v.y;
        xv[j + 2] = v.z;
        xv[j + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < C; j += 2) {
        const double2 v = __ldg(reinterpret_cast<const double2*>(xr + j));
        xv[j] = v.x;
        xv[j + 1] = v.y;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j) xv[j] = j < cn ? __ldg(xr + j) : T(0);
  }
}

// Sets *flag when any of the len values of x is not finite.
template <typename T>
__global__ void any_nonfinite_kernel(const T* __restrict__ x, long long len,
                                     int* __restrict__ flag) {
  bool bad = false;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < len; i += (long long)gridDim.x * blockDim.x)
    bad |= !isfinite(x[i]);
  if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = 1;
}

template <typename T, int C, bool VEC>
__global__ void spmv_bell_multi_kernel(const T* __restrict__ blocks,
                                       const int* __restrict__ cols,
                                       const T* __restrict__ x,
                                       T* __restrict__ y,
                                       const int* __restrict__ nonfinite,
                                       int nnzb, int bm, int bk, long long n,
                                       int nb) {
  const bool dense = *nonfinite != 0;  // X holds an Inf or NaN
  const int s = blockIdx.x;
  const int m = threadIdx.y;
  const int lane = threadIdx.x;
  const int* cs = cols + (long long)s * nnzb;
  const T* a = blocks + (long long)s * nnzb * bm * bk + (long long)m * bk;
  const long long row = (long long)s * bm + m;
  constexpr int U = 4;                 // block entries in flight per lane
  for (int c0 = 0; c0 < nb; c0 += C) {
    const int cn = min(C, nb - c0);
    T acc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] = T(0);
    for (int b = 0; b < nnzb; ++b) {
      const long long base = (long long)cs[b] * bk;
      const T* ab = a + (long long)b * bm * bk;
      for (int t0 = lane; t0 < bk; t0 += 32 * U) {
        T av[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int t = t0 + 32 * u;
          av[u] = t < bk ? ab[t] : T(0);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long col = base + t0 + 32 * u;
          if ((dense || av[u] != T(0)) && col < n) {  // zero past n
            T xv[C];
            load_row<T, C, VEC>(x + col * nb + c0, cn, xv);
#pragma unroll
            for (int j = 0; j < C; ++j) acc[j] += av[u] * xv[j];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j)
      for (int off = 16; off > 0; off >>= 1)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    T mine = T(0);
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (lane == j) mine = acc[j];
    if (row < n && lane < cn) y[row * nb + c0 + lane] = mine;
  }
}

template <typename T, int C>
int launch_multi_c(const void* blocks, const void* cols, const void* x,
                   void* y, const int* flag, int S, int nnzb, int bm, int bk,
                   long long n, int nb, cudaStream_t st) {
  const dim3 grid((unsigned)S);
  const dim3 block(32, (unsigned)bm);
  const bool vec = nb % C == 0 && (uintptr_t)x % 16 == 0;
  if constexpr ((C * sizeof(T)) % 16 == 0) {
    if (vec) {
      spmv_bell_multi_kernel<T, C, true><<<grid, block, 0, st>>>(
          (const T*)blocks, (const int*)cols, (const T*)x, (T*)y, flag, nnzb,
          bm, bk, n, nb);
      return (int)cudaGetLastError();
    }
  }
  spmv_bell_multi_kernel<T, C, false><<<grid, block, 0, st>>>(
      (const T*)blocks, (const int*)cols, (const T*)x, (T*)y, flag, nnzb, bm,
      bk, n, nb);
  return (int)cudaGetLastError();
}

// flag: one int of device scratch for the non-finite pass.
template <typename T>
int launch_multi(const void* blocks, const void* cols, const void* x,
                 void* y, void* flag, int S, int nnzb, int bm, int bk,
                 long long n, int nb, void* stream) {
  if (S == 0 || nb == 0) return 0;
  if (nb == 1)
    return launch<T>(blocks, cols, x, y, 1, S, nnzb, bm, bk, n, stream);
  const cudaStream_t st = (cudaStream_t)stream;
  if (const cudaError_t e = cudaMemsetAsync(flag, 0, sizeof(int), st))
    return (int)e;
  any_nonfinite_kernel<T><<<1024, 256, 0, st>>>((const T*)x, n * nb,
                                                 (int*)flag);
  const int* f = (const int*)flag;
  if (nb <= 2)
    return launch_multi_c<T, 2>(blocks, cols, x, y, f, S, nnzb, bm, bk, n,
                                nb, st);
  if (nb <= 4)
    return launch_multi_c<T, 4>(blocks, cols, x, y, f, S, nnzb, bm, bk, n,
                                nb, st);
  if (nb <= 8)
    return launch_multi_c<T, 8>(blocks, cols, x, y, f, S, nnzb, bm, bk, n,
                                nb, st);
  return launch_multi_c<T, 16>(blocks, cols, x, y, f, S, nnzb, bm, bk, n,
                               nb, st);
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

extern "C" int spmv_bell_multi_f32(const void* blocks, const void* cols,
                                   const void* x, void* y, void* flag, int S,
                                   int nnzb, int bm, int bk, long long n,
                                   int nb, void* stream) {
  return launch_multi<float>(blocks, cols, x, y, flag, S, nnzb, bm, bk, n,
                             nb, stream);
}

extern "C" int spmv_bell_multi_f64(const void* blocks, const void* cols,
                                   const void* x, void* y, void* flag, int S,
                                   int nnzb, int bm, int bk, long long n,
                                   int nb, void* stream) {
  return launch_multi<double>(blocks, cols, x, y, flag, S, nnzb, bm, bk, n,
                              nb, stream);
}
