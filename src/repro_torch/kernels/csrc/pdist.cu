// Pairwise squared distances D[i, j] = ||x_i||^2 - 2 x_i.c_j + ||c_j||^2 for
// Hopper (sm_90a), the hot loop of balanced k-means (geoKM).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pdist.py
// (pairwise_sqdist_pallas / _pdist_kernel).  The TPU version pads d to the
// 8-sublane width and runs the x.c term on the MXU; here d is 2 or 3 (at
// most 8), so there is nothing for the tensor cores to do.  One thread
// computes one (i, j) entry in float32 with the same three-term formula.
//
// Bound: bytes.  Per entry the kernel does 6d flops and writes 4 bytes of
// output; x (n*d) and c (k*d) are read once from DRAM (c and the x row are
// re-read from L1/L2 by the k neighbouring threads of one row).  Neighbouring
// threads write neighbouring output addresses, so the (n, k) float32 store,
// which dominates the traffic, is fully coalesced.
//
// Plain C interface: launched on the caller's stream, returns the
// cudaGetLastError() code of the launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void pdist_kernel(const T* __restrict__ x, const T* __restrict__ c,
                             float* __restrict__ out, long long n, int k,
                             int d) {
  const long long total = n * (long long)k;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long i = idx / k;
    const int j = (int)(idx - i * k);
    float xx = 0.f, cc = 0.f, xc = 0.f;
    for (int t = 0; t < d; ++t) {
      const float a = to_f32(x[i * d + t]);
      const float b = to_f32(c[(long long)j * d + t]);
      xx += a * a;
      cc += b * b;
      xc += a * b;
    }
    out[idx] = xx - 2.0f * xc + cc;
  }
}

template <typename T>
int launch(const void* x, const void* c, void* out, long long n, int k, int d,
           void* stream) {
  const long long total = n * (long long)k;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride beyond this
  pdist_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)c, (float*)out, n, k, d);
  return (int)cudaGetLastError();
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
