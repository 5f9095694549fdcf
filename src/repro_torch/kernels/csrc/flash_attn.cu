// Flash attention forward on Hopper's tensor cores through mma.sync
// (sm_90a), float32 at head dims 16, 64, 80 and 128 and bf16 at head dims 16
// and 80 (csrc/flash_attn_sm90.cu takes bf16 at 64 and 128):
//
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h/G, j]) v[b, h/G, j]
//
// with scale = D^-1/2, G = H / Hkv query heads per kv head, and (causal)
// key j masked for query i when j > i.  The running max m, the normalizer l
// and the accumulator are float32; masked scores are -1e30 and the output
// is acc / max(l, 1e-30) in q's dtype, as in the TPU kernel.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash.py::flash_attention
// (body _flash_kernel).  The TPU version walks a sequential (B*H, Sq/BQ,
// Sk/BK) grid and carries m, l, acc in VMEM scratch across the key axis;
// blocks on Hopper run in no order, so the key walk is a loop inside one CTA.
//
// Bound: operations, at both of this kernel's path shapes (causal, so the
// products cover the triangle, 4 B H D S (S+1) / 2 flops):
// * bf16 (8, 32, 2048, 80), stablelm-3b's prefill: 171.9 GFLOP, 0.174 ms at
//   989 TFLOP/s of bf16 tensor-core work, against 335.5 MB of q, k, v and
//   o (0.100 ms at 3.35 TB/s);
// * f32 (4, 16, 2048, 64), the f32 consistency check: 34.38 GFLOP.  Done as
//   3xTF32 (below) that is three TF32 products per product, 103.1 GFLOP at
//   495 TFLOP/s: 0.208 ms (0.513 ms for the same flops on the CUDA cores'
//   67 TFLOP/s of f32 FMAs, which the previous design of this kernel used).
//
// How the design meets it (FlashAttention-2's schedule):
// * CTA: one per (query tile, b*h), grid (B*H, tiles) with the heaviest
//   causal tiles issued first.  8 warps; each owns 16 query rows, so a tile
//   is 128 rows.  Registers are capped at 128 a thread so that two CTAs
//   share an SM (16 warps to hide the mma.sync and exp2 latencies), except
//   for f32 at D = 128, whose 132 KB of tiles leave room for one.  Key
//   tiles wholly above the causal diagonal are never loaded; a warp skips a
//   tile that lies wholly above its own 16 rows, and only a tile that
//   crosses the diagonal (or the end of Sk) is masked.
// * Copies: k and v tiles of KT keys (64 in bf16; 32 in f32, whose 3xTF32
//   fragments take more registers) move with cp.async.cg, 16 bytes a
//   thread, into a ring of STAGES (3 in bf16, 2 in f32) in shared memory,
//   one commit group per tile and one __syncthreads per tile.  They stay in
//   the input dtype.  Rows past S are zero-filled (src-size 0) and masked.
//   Every row of a tile is padded to an odd number of 16-byte chunks, so the
//   8 row addresses of an ldmatrix phase (and the f32 v reads below) fall
//   in 8 distinct bank groups: the padding does what an XOR swizzle does for
//   power-of-two rows, and also fits the rows of D = 80 (10 or 20 chunks),
//   which an 8-chunk XOR pattern does not.
// * bf16: S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 accumulate; the
//   products are exact in f32), q's A fragments loaded once by ldmatrix, k's
//   B fragments by ldmatrix; online softmax on the accumulator fragment (row
//   max and sum across the quad with __shfl_xor_sync, exp2 with
//   scale*log2(e) folded into one FMA with the row max); P rounded to bf16
//   and repacked from the S accumulator registers straight into the A
//   fragments of the PV mma.sync (never through shared memory), v's B
//   fragments by ldmatrix.trans; l summed from the rounded P, as in
//   flash_sm90.  D = 80 is 5 k-steps of Q K^T and 10 n8 blocks of P V.
// * f32 (3xTF32): each operand x is split into hi = cvt.rna.tf32(x) and
//   lo = cvt.rna.tf32(x - hi), and each product is lo*hi + hi*lo + hi*hi by
//   mma.sync m16n8k8 tf32 (lo*lo, about 2^-22 of the product, is dropped),
//   which keeps the error at f32's level where plain TF32 would not meet the
//   2e-3 kernel limit.  q is read from shared memory at each use (its hi/lo
//   fragments would take D registers a thread) and split there; k's B
//   fragments come by ldmatrix (an 8x8 b16 matrix is 8 rows of 4 f32).  P
//   stays f32 and is split like the other operands.  The S accumulator holds
//   keys 2t and 2t+1 of each 8-key block where the tf32 A fragment wants
//   keys t and t+4; the PV product sums over keys, so it takes the keys in
//   the accumulator's order and reads v's rows 2t and 2t+1 to match.
//
// Strides: q, k, v and o are read as (B, H, S, D) through element strides
// for b, h and s (D contiguous), so a (B, S, H, D) buffer seen as (B, H, S,
// D) is read and written in place, without a transpose.  cp.async's
// contract: every base pointer and every byte stride of s, b and h a
// multiple of 16 (the wrapper checks it).
//
// Plain C interface: launched on the caller's stream, returns the
// cudaGetLastError() code of the launch (cudaErrorInvalidValue for a head
// dim it has no instantiation for).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long q[3], k[3], v[3], o[3];   // element strides of b, h, s
};

template <typename T, int D>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int WARPS = 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS;                 // query rows per CTA
  static constexpr int KT = F32 ? 32 : 64;              // keys per tile
  static constexpr int STAGES = F32 ? 2 : 3;
  static constexpr int EPC = 16 / sizeof(T);            // elements per chunk
  static constexpr int CH = D / EPC;                    // chunks per row
  static constexpr int ROW = (CH | 1) * 16;             // padded row, bytes
  static constexpr int Q_BYTES = BQ * ROW;
  static constexpr int KV_BYTES = KT * ROW;
  static constexpr int BYTES = Q_BYTES + 2 * STAGES * KV_BYTES;
  // two CTAs an SM where their shared memory fits (all but f32 at D = 128)
  static constexpr int CTAS = 2 * BYTES <= 227 * 1024 ? 2 : 1;
  static constexpr int NK = CH / 2;     // k-steps of Q K^T, two chunks each
  static constexpr int NO = D / 8;      // n8 blocks of the output
  static constexpr int NS = KT / 8;     // n8 blocks of S
  static_assert(CH % 2 == 0 && NO % 2 == 0 && KT % 16 == 0, "tile shape");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async --------------------------------------------------------------
// 16 bytes from global to shared memory; ok == false writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows row0 .. row0 + R - 1 of a (S, D) matrix with row stride `stride`
// elements into a padded shared-memory tile; rows at or past n are zeros
template <class C, int R, typename T>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src,
                                          long long stride, int row0, int n) {
  for (int i = threadIdx.x; i < R * C::CH; i += C::THREADS) {
    const int r = i / C::CH;
    const int c = i - r * C::CH;
    const bool ok = row0 + r < n;
    const T* p = ok ? src + (row0 + r) * stride + c * C::EPC : src;
    cp_async16(dst + r * C::ROW + c * 16, p, ok);
  }
}

// ---- ldmatrix and mma.sync -------------------------------------------------
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d(16x8, f32) += a(16x16, bf16) b(16x8, bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d(16x8, f32) += a(16x8, tf32) b(8x8, tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, both tf32 (round to nearest, ties away from zero)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d += a b in 3xTF32: the two small cross terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y, float& sum) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(p);
  sum += f.x + f.y;
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Fragments (PTX ISA, mma.sync m16n8k16 / m16n8k8): in a warp, lane = 4 g +
// t.  The f32 accumulator of a 16x8 block holds (row g, cols 2t, 2t+1) and
// (row g + 8, the same cols).  ldmatrix .x4 takes row addresses from lanes
// 8 m .. 8 m + 7 for matrix m; an 8x8 b16 matrix is 8 rows of one 16-byte
// chunk.  Two address patterns cover every operand here (a k-step is two
// chunks: 16 bf16 or 8 f32 columns):
//   A: matrix m = rows 8 (m & 1) .., chunk m >> 1  -> q's A fragment, and
//      with .trans v's B fragments of two n8 blocks (bf16)
//   B: matrix m = rows 8 (m >> 1) .., chunk m & 1  -> k's B fragments of
//      two n8 blocks of keys
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::THREADS, Cfg<T, D>::CTAS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int group,
                 int Sq, int Sk, Strides st, float scale_log2, int causal) {
  using C = Cfg<T, D>;
  constexpr int KT = C::KT;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_kv = s_q + C::Q_BYTES;     // stage s: k at +2s, v at +2s+1

  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / group;
  const int q0 = qt * C::BQ;
  const int k_tiles = (Sk + KT - 1) / KT;
  const int n_kt = causal ? min(k_tiles, (q0 + C::BQ + KT - 1) / KT) : k_tiles;

  const T* qp = q + b * st.q[0] + h * st.q[1];
  const T* kp = k + b * st.k[0] + hk * st.k[1];
  const T* vp = v + b * st.v[0] + hk * st.v[1];

  // the q tile rides in the first commit group, with k/v tile 0
  load_tile<C, C::BQ>(s_q, qp, st.q[2], q0, Sq);
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_kt) {
      load_tile<C, KT>(s_kv + 2 * s * C::KV_BYTES, kp, st.k[2], s * KT, Sk);
      load_tile<C, KT>(s_kv + (2 * s + 1) * C::KV_BYTES, vp, st.v[2], s * KT,
                       Sk);
    }
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mi = lane >> 3;
  const int ri = lane & 7;
  const int wr0 = q0 + warp * 16;             // this warp's first row
  const int qp0 = wr0 + g;                    // rows qp0 and qp0 + 8
  // ldmatrix row addresses of this lane, patterns A and B
  const uint32_t a_off = ((mi & 1) * 8 + ri) * C::ROW + (mi >> 1) * 16;
  const uint32_t b_off = ((mi >> 1) * 8 + ri) * C::ROW + (mi & 1) * 16;
  const uint32_t qa = s_q + warp * 16 * C::ROW + a_off;
  const float c = scale_log2;

  float oacc[C::NO][4];
#pragma unroll
  for (int n = 0; n < C::NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[n][i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  uint32_t qf[C::F32 ? 1 : C::NK][4];         // bf16: q's A fragments

  for (int it = 0; it < n_kt; ++it) {
    cp_async_wait<C::STAGES - 2>();           // tile it has landed here,
    __syncthreads();                          // everywhere; it-1 consumed
    if constexpr (!C::F32) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < C::NK; ++kk) ldsm_x4(qf[kk], qa + kk * 32);
      }
    }
    {
      const int nt = it + C::STAGES - 1;      // refill the stage it-1 used
      if (nt < n_kt) {
        const int s = nt % C::STAGES;
        load_tile<C, KT>(s_kv + 2 * s * C::KV_BYTES, kp, st.k[2], nt * KT,
                         Sk);
        load_tile<C, KT>(s_kv + (2 * s + 1) * C::KV_BYTES, vp, st.v[2],
                         nt * KT, Sk);
      }
      cp_async_commit();
    }
    const int k0 = it * KT;
    if (causal && k0 > wr0 + 15) continue;    // above all 16 rows (uniform)
    const int s = it % C::STAGES;
    const uint32_t ks = s_kv + 2 * s * C::KV_BYTES;
    const uint32_t vs = ks + C::KV_BYTES;

    // ---- S = Q K^T (raw scores) ------------------------------------------
    float sc[C::NS][4];
#pragma unroll
    for (int n = 0; n < C::NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::NK; ++kk) {
      if constexpr (C::F32) {
        uint32_t ah[4], al[4];
        ldsm_x4(ah, qa + kk * 32);
#pragma unroll
        for (int i = 0; i < 4; ++i) split(__uint_as_float(ah[i]), ah[i], al[i]);
#pragma unroll
        for (int np = 0; np < KT / 16; ++np) {
          uint32_t bh[4], bl[4];
          ldsm_x4(bh, ks + np * 16 * C::ROW + b_off + kk * 32);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split(__uint_as_float(bh[i]), bh[i], bl[i]);
          mma_3xtf32(sc[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(sc[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
      } else {
#pragma unroll
        for (int np = 0; np < KT / 16; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, ks + np * 16 * C::ROW + b_off + kk * 32);
          mma_bf16(sc[2 * np], qf[kk], bb[0], bb[1]);
          mma_bf16(sc[2 * np + 1], qf[kk], bb[2], bb[3]);
        }
      }
    }

    // ---- online softmax on the fragment -----------------------------------
    if ((causal && k0 + KT - 1 > wr0) || k0 + KT > Sk) {
#pragma unroll
      for (int n = 0; n < C::NS; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = k0 + 8 * n + 2 * t + j;
          if (key >= Sk || (causal && key > qp0)) sc[n][j] = NEG;
          if (key >= Sk || (causal && key > qp0 + 8)) sc[n][2 + j] = NEG;
        }
    }
    float t0 = NEG, t1 = NEG;
#pragma unroll
    for (int n = 0; n < C::NS; ++n) {
      t0 = fmaxf(t0, fmaxf(sc[n][0], sc[n][1]));
      t1 = fmaxf(t1, fmaxf(sc[n][2], sc[n][3]));
    }
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
    const float mn0 = fmaxf(m0, t0);
    const float mn1 = fmaxf(m1, t1);
    const float corr0 = ex2((m0 - mn0) * c);
    const float corr1 = ex2((m1 - mn1) * c);
    m0 = mn0;
    m1 = mn1;
    const float ms0 = mn0 * c;
    const float ms1 = mn1 * c;
#pragma unroll
    for (int n = 0; n < C::NO; ++n) {
      oacc[n][0] *= corr0;
      oacc[n][1] *= corr0;
      oacc[n][2] *= corr1;
      oacc[n][3] *= corr1;
    }
    float ls0 = 0.f, ls1 = 0.f;

    // ---- O += P V -----------------------------------------------------------
    if constexpr (C::F32) {
      constexpr int LD = C::ROW / 4;          // row stride in floats
      const float* vt = reinterpret_cast<const float*>(
          smem + (vs - s_q)) + 2 * t * LD + g;
#pragma unroll
      for (int n = 0; n < C::NS; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[n][i] = ex2(fmaf(sc[n][i], c, i < 2 ? -ms0 : -ms1));
          (i < 2 ? ls0 : ls1) += sc[n][i];
        }
      }
#pragma unroll
      for (int j = 0; j < C::NS; ++j) {       // keys 8j .. 8j + 7
        // A fragment in the accumulator's key order: a0, a2 = (row g, keys
        // 2t, 2t+1), a1, a3 = row g + 8
        uint32_t ah[4], al[4];
        split(sc[j][0], ah[0], al[0]);
        split(sc[j][2], ah[1], al[1]);
        split(sc[j][1], ah[2], al[2]);
        split(sc[j][3], ah[3], al[3]);
        const float* vr = vt + 8 * j * LD;  // rows 8j + 2t, 8j + 2t + 1
#pragma unroll
        for (int n = 0; n < C::NO; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split(vr[8 * n], bh0, bl0);
          split(vr[LD + 8 * n], bh1, bl1);
          mma_3xtf32(oacc[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    } else {
      uint32_t pp[C::NS][2];                  // P rounded to bf16, packed
#pragma unroll
      for (int n = 0; n < C::NS; ++n) {
        pp[n][0] = pack_bf16(ex2(fmaf(sc[n][0], c, -ms0)),
                             ex2(fmaf(sc[n][1], c, -ms0)), ls0);
        pp[n][1] = pack_bf16(ex2(fmaf(sc[n][2], c, -ms1)),
                             ex2(fmaf(sc[n][3], c, -ms1)), ls1);
      }
#pragma unroll
      for (int j = 0; j < KT / 16; ++j) {     // keys 16j .. 16j + 15
        const uint32_t a[4] = {pp[2 * j][0], pp[2 * j][1], pp[2 * j + 1][0],
                               pp[2 * j + 1][1]};
#pragma unroll
        for (int dp = 0; dp < C::NO / 2; ++dp) {
          uint32_t bb[4];
          ldsm_x4_t(bb, vs + j * 16 * C::ROW + a_off + dp * 32);
          mma_bf16(oacc[2 * dp], a, bb[0], bb[1]);
          mma_bf16(oacc[2 * dp + 1], a, bb[2], bb[3]);
        }
      }
    }
    l0 = l0 * corr0 + ls0;
    l1 = l1 * corr1 + ls1;
  }
  cp_async_wait<0>();                         // no copy outlives the CTA

  // ---- epilogue ---------------------------------------------------------------
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f);
  const float den1 = fmaxf(l1, 1e-30f);
  T* ob = o + b * st.o[0] + h * st.o[1] + 2 * t;
  if (qp0 < Sq) {
    T* op = ob + qp0 * st.o[2];
#pragma unroll
    for (int n = 0; n < C::NO; ++n)
      store2(op + 8 * n, oacc[n][0] / den0, oacc[n][1] / den0);
  }
  if (qp0 + 8 < Sq) {
    T* op = ob + (qp0 + 8) * st.o[2];
#pragma unroll
    for (int n = 0; n < C::NO; ++n)
      store2(op + 8 * n, oacc[n][2] / den1, oacc[n][3] / den1);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int Sq, int Sk, const long long* strides,
             int causal, void* stream) {
  using C = Cfg<T, D>;
  const int tiles = (Sq + C::BQ - 1) / C::BQ;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::BYTES);
  if (err != cudaSuccess) return (int)err;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const dim3 grid(B * H, tiles);
  const float scale_log2 = LOG2E / sqrtf((float)D);
  flash_fwd_kernel<T, D><<<grid, C::THREADS, C::BYTES,
                           (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, H / Hkv, Sq, Sk, st,
      scale_log2, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int Hkv, int Sq, int Sk,
                              int D, const long long* strides, int causal,
                              void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  switch (D) {
    case 16:   // the smoke configs
      return launch_d<float, 16>(q, k, v, o, B, H, Hkv, Sq, Sk, strides,
                                 causal, stream);
    case 64:   // qwen1.5-0.5b
      return launch_d<float, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, strides,
                                 causal, stream);
    case 80:   // stablelm-3b
      return launch_d<float, 80>(q, k, v, o, B, H, Hkv, Sq, Sk, strides,
                                 causal, stream);
    case 128:  // qwen2.5-14b, mistral-large-123b
      return launch_d<float, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, strides,
                                  causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int Hkv, int Sq, int Sk,
                               int D, const long long* strides, int causal,
                               void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  switch (D) {   // 64 and 128 take flash_sm90
    case 16:   // the smoke configs
      return launch_d<__nv_bfloat16, 16>(q, k, v, o, B, H, Hkv, Sq, Sk,
                                         strides, causal, stream);
    case 80:   // stablelm-3b
      return launch_d<__nv_bfloat16, 80>(q, k, v, o, B, H, Hkv, Sq, Sk,
                                         strides, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
