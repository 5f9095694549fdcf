// Pairwise squared distances D[i, j] = ||x_i||^2 - 2 x_i.c_j + ||c_j||^2 for
// Hopper (sm_90a), the hot loop of balanced k-means (geoKM).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pdist.py
// (pairwise_sqdist_pallas / _pdist_kernel).  The TPU version pads d to the
// 8-sublane width and runs the x.c term on the MXU; here d is 2 or 3 (at
// most 8), so there is nothing for the tensor cores to do.  The arithmetic
// is the TPU kernel's three-term formula in float32.
//
// Bound: bytes.  At (2^20, 2) x (8, 2) the kernel reads 8 MB of x and
// writes 32 MB of float32 output, 0.0125 ms at the card's 3.35 TB/s; the
// flops (6d per entry) are negligible.  So the design spends as few
// instructions per output byte as it can:
//
// * One thread per point: it reads x_i once, computes ||x_i||^2 once and
//   writes its k outputs, as 16-byte stores where k % 4 == 0 (k = 8 on the
//   main path), scalar stores otherwise.
// * Each CTA stages the centres and their ||c_j||^2 in shared memory once
//   (in chunks of up to 1024 centres), read back as broadcasts.
// * d is a template parameter for 2 and 3 (the meshes' dimensions), with a
//   generic loop up to 8; no 64-bit division anywhere.
//
// Plain C interface: launched on the caller's stream, returns the
// cudaGetLastError() code of the launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int KC = 1024;       // centres staged per chunk
constexpr int MAX_D = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// DT: d as a template parameter, or 0 for the generic loop (d <= MAX_D)
template <typename T, int DT>
__global__ void __launch_bounds__(THREADS)
pdist_kernel(const T* __restrict__ x, const T* __restrict__ c,
             float* __restrict__ out, long long n, int k, int d) {
  constexpr int DR = DT ? DT : MAX_D;        // register slots for x_i
  const int dd = DT ? DT : d;
  const int kc = min(k, KC);
  extern __shared__ float smem[];
  float* cs = smem;                          // kc x dd centres
  float* ccs = smem + kc * dd;               // their ||c||^2

  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  const bool live = i < n;
  float xr[DR];
  float xx = 0.f;
#pragma unroll
  for (int t = 0; t < DR; ++t) {
    xr[t] = (live && t < dd) ? to_f32(x[i * dd + t]) : 0.f;
    xx += xr[t] * xr[t];
  }
  const bool vec = (k & 3) == 0;

  for (int j0 = 0; j0 < k; j0 += kc) {
    const int m = min(kc, k - j0);
    __syncthreads();                         // previous chunk consumed
    for (int t = threadIdx.x; t < m * dd; t += THREADS)
      cs[t] = to_f32(c[j0 * dd + t]);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += THREADS) {
      float s = 0.f;
      for (int t = 0; t < dd; ++t) s += cs[j * dd + t] * cs[j * dd + t];
      ccs[j] = s;
    }
    __syncthreads();
    if (!live) continue;
    float* row = out + i * k + j0;
    auto dist = [&](int j) {
      float xc = 0.f;
#pragma unroll
      for (int t = 0; t < DR; ++t)
        if (t < dd) xc += xr[t] * cs[j * dd + t];
      return xx - 2.0f * xc + ccs[j];
    };
    if (vec) {
      for (int j = 0; j < m; j += 4)
        *reinterpret_cast<float4*>(row + j) =
            make_float4(dist(j), dist(j + 1), dist(j + 2), dist(j + 3));
    } else {
      for (int j = 0; j < m; ++j) row[j] = dist(j);
    }
  }
}

template <typename T, int DT>
int launch_d(const void* x, const void* c, void* out, long long n, int k,
             int d, void* stream) {
  const int dd = DT ? DT : d;
  const int kc = k < KC ? k : KC;
  const size_t smem = (size_t)kc * (dd + 1) * sizeof(float);
  const long long blocks = (n + THREADS - 1) / THREADS;
  pdist_kernel<T, DT><<<(unsigned)blocks, THREADS, smem,
                        (cudaStream_t)stream>>>((const T*)x, (const T*)c,
                                                (float*)out, n, k, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* c, void* out, long long n, int k, int d,
           void* stream) {
  if (n == 0 || k == 0) return 0;
  if (d < 1 || d > MAX_D) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 2:
      return launch_d<T, 2>(x, c, out, n, k, d, stream);
    case 3:
      return launch_d<T, 3>(x, c, out, n, k, d, stream);
    default:
      return launch_d<T, 0>(x, c, out, n, k, d, stream);
  }
}

}  // namespace

extern "C" int pdist_f32(const void* x, const void* c, void* out, long long n,
                         int k, int d, void* stream) {
  return launch<float>(x, c, out, n, k, d, stream);
}

extern "C" int pdist_bf16(const void* x, const void* c, void* out, long long n,
                          int k, int d, void* stream) {
  return launch<__nv_bfloat16>(x, c, out, n, k, d, stream);
}
