// Block-ELL SpMV for Hopper (sm_90a), over the blocks' nonzero entries:
//
//   y[k, s*BM + m] = sum_b sum_t blocks[k, s, b, m, t] * x[k, cols[k, s, b]*BK + t]
//
// with x read as zero past its length n (the TPU kernel's zero-padded
// panels), for one vector, one per PU block of a stacked plan (K of them),
// or an (n, nb) batch, X row-major (the batched CG keeps the batch axis
// last).
//
// Replaces the Pallas TPU kernel src/repro/kernels/spmv_bell.py
// (_spmv_block_ell), also under the reference's jax.vmap over columns
// (sparse/cg.py).  The TPU version walks a sequential (S, NNZB) grid and
// streams every (BM, BK) block.  The bm 8 x bk 128 blocks of a 5-point
// Laplacian are 99% zeros (2.15 GB of blocks for 42 MB of values and int32
// columns at the 1024^2 grid), so a kernel that streams the blocks sits
// far above what the product needs: 0.7-3 ms on an H100 at the port's
// shapes, where the nonzeros take 0.02-0.05 ms at the HBM rate.
//
// spmv_sell: the operators build, once, a list of the blocks' nonzero
// entries (spmv_bell.py::bell_index) in sliced ELL: rows in slices of 32,
// each slice padded to its longest row, entry j of the slice's row i at
// ptr[slice] + 32 j + i (one int32 column within the row's PU block, -1 on
// padding, and the block's value bit for bit).  A team of L lanes takes one
// row and a chunk of C columns of the batch, W = C / L of them each (one
// thread per row up to 16 bytes of the X row: nb <= 2 in f32, 1 in f64;
// float4 / double2 slices above); wider batches loop over chunks.  A warp
// reads its slice's entries with coalesced streaming loads (evict first,
// so X keeps L2), U = 8 entries of a row in flight before its first X
// read, X through the read-only path (the +-1 / +-side neighbours of a grid
// row hit L1 / L2), and writes its Y rows once, coalesced.  Bound: bytes,
// the nonzeros' value and column, X once and Y once (2 flops per 8-12 bytes
// and column; no tensor cores: the products are gathers of X rows, which
// TMA cannot do on Hopper, at far below the card's flop/byte ratio).
//
// A zero block entry under an Inf or NaN of X still has to give NaN, as
// the dense product does: a first pass over X (any_nonfinite_kernel) sets
// a device flag when any value is not finite, and a flagged launch computes
// every row as the dense product over its stripe's NNZB blocks (exact, and
// slow).  The flag is read on the device; the host never waits for it.
//
// Plain C interface: launched on the caller's stream, returns the
// cudaGetLastError() code of the launch.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

// W values of a row from p: the sell route's X reads and Y writes.  VEC:
// all W present and p aligned to W * sizeof(T); else columns at or past cn
// read as zero (and are not written).
template <typename T, int W, bool VEC>
__device__ __forceinline__ void load_vals(const T* __restrict__ p, int cn,
                                          T (&v)[W]) {
  if constexpr (VEC && W * sizeof(T) == 16 && sizeof(T) == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (VEC && W * sizeof(T) == 16) {
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else if constexpr (VEC && W == 2 && sizeof(T) == 4) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = (VEC || i < cn) ? __ldg(p + i) : T(0);
  }
}

template <typename T, int W, bool VEC>
__device__ __forceinline__ void store_vals(T* __restrict__ p, int cn,
                                           const T (&v)[W]) {
  if constexpr (VEC && W * sizeof(T) == 16 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC && W * sizeof(T) == 16) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  } else if constexpr (VEC && W == 2 && sizeof(T) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (VEC || i < cn) p[i] = v[i];
  }
}

// One team of L = C / W lanes per row r of the rows = K * n rows (PU block
// k = r / n); lane l owns columns c0 + l W .. c0 + l W + W - 1 of each
// chunk of C columns.
template <typename T, int C, bool VEC>
__global__ void spmv_sell_kernel(
    const int* __restrict__ ptr, const int* __restrict__ icol,
    const T* __restrict__ ival, const T* __restrict__ blocks,
    const int* __restrict__ bcols, const T* __restrict__ x, T* __restrict__ y,
    const int* __restrict__ nonfinite, long long rows, long long n, int nb,
    int S, int nnzb, int bm, int bk) {
  constexpr int W = (C * sizeof(T) < 16) ? C : (int)(16 / sizeof(T));
  constexpr int L = C / W;
  constexpr int U = 8;                 // entries of a row in flight
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = t / L;
  if (r >= rows) return;
  const int cl = (int)(t % L) * W;
  const long long k = r / n;
  const T* xk = x + k * n * nb;
  T* yr = y + r * nb;
  if (*nonfinite) {                    // the dense product over the stripe
    const long long i = r - k * n;
    const long long stripe = k * S + i / bm;
    const int* cs = bcols + stripe * nnzb;
    const T* a = blocks + (stripe * nnzb * bm + i % bm) * (long long)bk;
    for (int c = cl; c < nb; c += C) {
      const int cn = min(W, nb - c);
      T acc[W];
#pragma unroll
      for (int q = 0; q < W; ++q) acc[q] = T(0);
      for (int b = 0; b < nnzb; ++b) {
        const long long base = (long long)cs[b] * bk;
        const T* ab = a + (long long)b * bm * bk;
        for (int e = 0; e < bk; ++e) {
          const T av = ab[e];
          T xv[W];
          if (base + e < n) {
            load_vals<T, W, VEC>(xk + (base + e) * nb + c, cn, xv);
          } else {
#pragma unroll
            for (int q = 0; q < W; ++q) xv[q] = T(0);   // zero past n
          }
#pragma unroll
          for (int q = 0; q < W; ++q) acc[q] += av * xv[q];
        }
      }
      store_vals<T, W, VEC>(yr + c, cn, acc);
    }
    return;
  }
  const long long sl = r >> 5;
  const int beg = ptr[sl];
  const int w = (ptr[sl + 1] - beg) >> 5;
  const int* ic = icol + beg + (int)(r & 31);
  const T* iv = ival + beg + (int)(r & 31);
  for (int c = cl; c < nb; c += C) {
    const int cn = min(W, nb - c);
    T acc[W];
#pragma unroll
    for (int q = 0; q < W; ++q) acc[q] = T(0);
    for (int j0 = 0; j0 < w; j0 += U) {
      int cc[U];
      T vv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        cc[u] = j < w ? __ldcs(ic + 32 * j) : -1;
        vv[u] = j < w ? __ldcs(iv + 32 * j) : T(0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (cc[u] >= 0) {              // -1: the slice's padding
          T xv[W];
          load_vals<T, W, VEC>(xk + (long long)cc[u] * nb + c, cn, xv);
#pragma unroll
          for (int q = 0; q < W; ++q) acc[q] += vv[u] * xv[q];
        }
      }
    }
    store_vals<T, W, VEC>(yr + c, cn, acc);
  }
}

__device__ __forceinline__ bool finite16(float4 v) {
  return isfinite(v.x) && isfinite(v.y) && isfinite(v.z) && isfinite(v.w);
}
__device__ __forceinline__ bool finite16(double2 v) {
  return isfinite(v.x) && isfinite(v.y);
}

// Sets *flag when any of the len values of x is not finite: the sell
// route's first pass.  16-byte loads over the aligned body, with a scalar
// head and tail, so any x of the blocks' dtype will do; the body is walked
// from its end to its start, so that what stays in L2 afterwards is the
// head of x, which the product reads first (an X of 64 MB, nb = 16 at the
// 1024^2 grid, does not fit in L2).
template <typename T>
__global__ void any_nonfinite_kernel(const T* __restrict__ x, long long len,
                                     int* __restrict__ flag) {
  using V = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
  constexpr int E = 16 / sizeof(T);
  const long long to16 = (long long)((16 - (uintptr_t)x % 16) % 16) / sizeof(T);
  const long long head = to16 < len ? to16 : len;
  const long long nv = (len - head) / E;
  const V* xv = reinterpret_cast<const V*>(x + head);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool bad = false;
  for (long long i = first; i < nv; i += stride)
    bad |= !finite16(xv[nv - 1 - i]);
  for (long long i = first; i < head; i += stride) bad |= !isfinite(x[i]);
  for (long long i = head + nv * E + first; i < len; i += stride)
    bad |= !isfinite(x[i]);
  if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = 1;
}

// flag := 1 if any of the len values of x is not finite, else 0.
template <typename T>
int nonfinite_pass(const void* x, long long len, void* flag,
                   cudaStream_t st) {
  if (const cudaError_t e = cudaMemsetAsync(flag, 0, sizeof(int), st))
    return (int)e;
  const long long want = (len + 256 * 4 - 1) / (256 * 4);
  const unsigned grid = (unsigned)(want < 1024 ? (want > 0 ? want : 1) : 1024);
  any_nonfinite_kernel<T><<<grid, 256, 0, st>>>((const T*)x, len, (int*)flag);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int launch_sell_c(const void* ptr, const void* icol, const void* ival,
                  const void* blocks, const void* bcols, const void* x,
                  void* y, const int* flag, long long rows, long long n,
                  int nb, int S, int nnzb, int bm, int bk, cudaStream_t st) {
  constexpr int W = (C * sizeof(T) < 16) ? C : (int)(16 / sizeof(T));
  constexpr int L = C / W;
  constexpr int threads = 256;
  const long long grid = (rows * L + threads - 1) / threads;
  const uintptr_t align = W * sizeof(T);
  const bool vec = nb % W == 0 && (uintptr_t)x % align == 0 &&
                   (uintptr_t)y % align == 0;
  if (vec) {
    spmv_sell_kernel<T, C, true><<<(unsigned)grid, threads, 0, st>>>(
        (const int*)ptr, (const int*)icol, (const T*)ival, (const T*)blocks,
        (const int*)bcols, (const T*)x, (T*)y, flag, rows, n, nb, S, nnzb, bm,
        bk);
  } else {
    spmv_sell_kernel<T, C, false><<<(unsigned)grid, threads, 0, st>>>(
        (const int*)ptr, (const int*)icol, (const T*)ival, (const T*)blocks,
        (const int*)bcols, (const T*)x, (T*)y, flag, rows, n, nb, S, nnzb, bm,
        bk);
  }
  return (int)cudaGetLastError();
}

// rows = K * n; x and y are (rows, nb) row-major; flag: one int of device
// scratch for the non-finite pass.
template <typename T>
int launch_sell(const void* ptr, const void* icol, const void* ival,
                const void* blocks, const void* bcols, const void* x, void* y,
                void* flag, long long rows, long long n, int nb, int S,
                int nnzb, int bm, int bk, void* stream) {
  if (rows == 0 || nb == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (const int e = nonfinite_pass<T>(x, rows * nb, flag, st)) return e;
  const int* f = (const int*)flag;
  if (nb == 1)
    return launch_sell_c<T, 1>(ptr, icol, ival, blocks, bcols, x, y, f, rows,
                               n, nb, S, nnzb, bm, bk, st);
  if (nb == 2)
    return launch_sell_c<T, 2>(ptr, icol, ival, blocks, bcols, x, y, f, rows,
                               n, nb, S, nnzb, bm, bk, st);
  if (nb <= 4)
    return launch_sell_c<T, 4>(ptr, icol, ival, blocks, bcols, x, y, f, rows,
                               n, nb, S, nnzb, bm, bk, st);
  if (nb <= 8)
    return launch_sell_c<T, 8>(ptr, icol, ival, blocks, bcols, x, y, f, rows,
                               n, nb, S, nnzb, bm, bk, st);
  return launch_sell_c<T, 16>(ptr, icol, ival, blocks, bcols, x, y, f, rows,
                              n, nb, S, nnzb, bm, bk, st);
}

}  // namespace

extern "C" int spmv_sell_f32(const void* ptr, const void* icol,
                             const void* ival, const void* blocks,
                             const void* bcols, const void* x, void* y,
                             void* flag, long long rows, long long n, int nb,
                             int S, int nnzb, int bm, int bk, void* stream) {
  return launch_sell<float>(ptr, icol, ival, blocks, bcols, x, y, flag, rows,
                            n, nb, S, nnzb, bm, bk, stream);
}

extern "C" int spmv_sell_f64(const void* ptr, const void* icol,
                             const void* ival, const void* blocks,
                             const void* bcols, const void* x, void* y,
                             void* flag, long long rows, long long n, int nb,
                             int S, int nnzb, int bm, int bk, void* stream) {
  return launch_sell<double>(ptr, icol, ival, blocks, bcols, x, y, flag, rows,
                             n, nb, S, nnzb, bm, bk, stream);
}

// The sell route's first pass alone, for timing it apart: x holds len
// float64 values if f64 is not 0, else float32 ones.
extern "C" int bell_nonfinite(const void* x, long long len, int f64,
                              void* flag, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return f64 ? nonfinite_pass<double>(x, len, flag, st)
             : nonfinite_pass<float>(x, len, flag, st);
}
