// Flash attention forward (FlashAttention-2 schedule) for Hopper (sm_90a):
//
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h/G, j]) v[b, h/G, j]
//
// with scale = D^-1/2, G = H / Hkv query heads per kv head, and (causal)
// key j masked for query i when j > i.  Scores, the running max m, the
// normalizer l and the accumulator are float32; q, k, v and o are float32
// or bfloat16 (o in q's dtype).  Masked scores are -1e30 and the output is
// acc / max(l, 1e-30), as in the TPU kernel.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash.py (flash_attention,
// body _flash_kernel).  The TPU version walks a sequential (B*H, Sq/BQ,
// Sk/BK) grid and carries m, l, acc in VMEM scratch across the key axis;
// blocks on Hopper run in no order, so the key walk is a loop inside one CTA.
//
// One CTA of 128 threads per (query tile, b*h).  R threads own one query
// row (R = 1 for D <= 64, 2 for D = 80 and 128): each holds
// D/R of the row's q (pre-scaled by scale*log2(e), so the softmax uses
// exp2) and of its accumulator in registers.  K and V tiles of KT keys are
// converted to float32 and staged in shared memory; every thread of a warp
// reads the same key row at once (a broadcast), so the products are f32
// FMAs out of registers and broadcast loads.  Keys are taken 16 at a time:
// 16 scores, one max, one rescale of acc, 16 exps.  Under the causal mask
// the key loop stops at the tile's last row, so key tiles strictly above
// the diagonal are never read, and a warp skips the 16-key chunks that lie
// wholly above its own rows.  Query tiles are issued heaviest first.
//
// Bound: operations.  At (B, H, S, D) = (8, 16, 2048, 64) bf16 causal the
// kernel must do 2*S*(S+1)/2*D*2 flops per (b, h) = 68.7 GFLOP against 134
// MB of q, k, v and o; on the card's bf16 tensor-core peak that is 0.069 ms
// and the bytes 0.040 ms.  These f32 FMAs run on the CUDA cores (67 TFLOP/s
// peak), so this kernel cannot come within about 15x of that bound; tensor
// cores (wgmma) and TMA are the redesign's work.
//
// Strides: q, k, v and o are read as (B, H, S, D) through element strides
// for b, h and s (D contiguous), so a (B, S, H, D) buffer seen as (B, H, S,
// D) is read and written in place, without a transpose.
//
// Plain C interface: launched on the caller's stream, returns the
// cudaGetLastError() code of the launch (cudaErrorInvalidValue for a head
// dim it has no instantiation for: it has the head dims of the dense
// configs, 16, 64, 80 and 128).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int CHUNK = 16;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long q[3], k[3], v[3], o[3];   // element strides of b, h, s
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H,
                 int group, int Sq, int Sk, Strides st, float scale_log2,
                 int causal) {
  constexpr int DPT = D / R;                   // dims per thread
  constexpr int BQ = THREADS / R;              // query rows per CTA
  constexpr int KT = D <= 80 ? 64 : 32;        // keys per staged tile
  static_assert(D % R == 0 && KT % CHUNK == 0, "tile shape");
  __shared__ __align__(16) float ks[KT][D];
  __shared__ __align__(16) float vs[KT][D];

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / group;
  const int row = threadIdx.x / R;
  const int d0 = (threadIdx.x - row * R) * DPT;
  const int q0 = qt * BQ;
  const int qi = q0 + row;
  const int warp = threadIdx.x / 32;
  const int warp_last = q0 + (warp + 1) * (32 / R) - 1;

  const T* qp = q + b * st.q[0] + h * st.q[1];
  const T* kp = k + b * st.k[0] + hk * st.k[1];
  const T* vp = v + b * st.v[0] + hk * st.v[1];

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) {
    qr[d] = qi < Sq ? to_f32(qp[qi * st.q[2] + d0 + d]) * scale_log2 : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG, l = 0.f;

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += KT) {
    __syncthreads();                           // previous tile consumed
    for (int idx = threadIdx.x; idx < KT * D; idx += THREADS) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int key = k0 + j;
      const bool ok = key < Sk;
      ks[j][d] = ok ? to_f32(kp[key * st.k[2] + d]) : 0.f;
      vs[j][d] = ok ? to_f32(vp[key * st.v[2] + d]) : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < KT; c += CHUNK) {
      const int kc = k0 + c;
      // both exits are uniform across the warp (the shuffles need that):
      // past k_end for the CTA, or every key left is above this warp's rows
      if (kc >= k_end || (causal && kc > warp_last)) break;
      float s[CHUNK];
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DPT; ++d)
          dot = fmaf(qr[d], ks[c + jj][d0 + d], dot);
#pragma unroll
        for (int off = R / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const int key = kc + jj;
        const bool ok = key < Sk && (!causal || key <= qi);
        s[jj] = ok ? dot : NEG;
      }
      float mx = s[0];
#pragma unroll
      for (int jj = 1; jj < CHUNK; ++jj) mx = fmaxf(mx, s[jj]);
      const float m_new = fmaxf(m, mx);
      const float corr = exp2f(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        const float p = exp2f(s[jj] - m_new);
        l += p;
#pragma unroll
        for (int d = 0; d < DPT; ++d)
          acc[d] = fmaf(p, vs[c + jj][d0 + d], acc[d]);
      }
      m = m_new;
    }
  }
  if (qi < Sq) {
    const float den = fmaxf(l, 1e-30f);
    T* op = o + b * st.o[0] + h * st.o[1] + qi * st.o[2] + d0;
#pragma unroll
    for (int d = 0; d < DPT; ++d) store(op + d, acc[d] / den);
  }
}

template <typename T, int D, int R>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int Sq, int Sk, const long long* strides,
             int causal, void* stream) {
  constexpr int BQ = THREADS / R;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  const float scale_log2 = LOG2E / sqrtf((float)D);
  flash_fwd_kernel<T, D, R><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, H / Hkv, Sq, Sk, st,
      scale_log2, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Sq, int Sk, int D, const long long* strides,
           int causal, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  switch (D) {
    case 16:   // the smoke configs
      return launch_d<T, 16, 1>(q, k, v, o, B, H, Hkv, Sq, Sk, strides,
                                causal, stream);
    case 64:   // qwen1.5-0.5b
      return launch_d<T, 64, 1>(q, k, v, o, B, H, Hkv, Sq, Sk, strides,
                                causal, stream);
    case 80:   // stablelm-3b
      return launch_d<T, 80, 2>(q, k, v, o, B, H, Hkv, Sq, Sk, strides,
                                causal, stream);
    case 128:  // qwen2.5-14b, mistral-large-123b
      return launch_d<T, 128, 2>(q, k, v, o, B, H, Hkv, Sq, Sk, strides,
                                 causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int Hkv, int Sq, int Sk,
                              int D, const long long* strides, int causal,
                              void* stream) {
  return launch<float>(q, k, v, o, B, H, Hkv, Sq, Sk, D, strides, causal,
                       stream);
}

extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int Hkv, int Sq, int Sk,
                               int D, const long long* strides, int causal,
                               void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, D, strides,
                               causal, stream);
}
