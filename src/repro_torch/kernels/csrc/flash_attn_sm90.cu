// Flash attention forward on Hopper's tensor cores (sm_90a), bf16 in and
// out, head dims 64 and 128:
//
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h/G, j]) v[b, h/G, j]
//
// with scale = D^-1/2, G = H / Hkv query heads per kv head, and (causal)
// key j masked for query i when j > i.  The running max m, the normalizer l
// and the accumulator are float32; masked scores are -1e30 and the output
// is acc / max(l, 1e-30) in bf16, as in the TPU kernel.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash.py:27
// (_flash_kernel, behind flash_attention) for bf16 with D in {64, 128};
// csrc/flash_attn.cu keeps float32 and the other head dims.
//
// Bound: operations.  At (B, H, S, D) = (8, 16, 2048, 64) causal the two
// products are 68.7 GFLOP, 0.069 ms at the card's 989 TFLOP/s bf16 peak,
// against 134 MB of q, k, v and o (0.040 ms).  So both products run on the
// tensor cores (wgmma), and no thread spends instructions on copies (TMA):
//
// * CTA: one per (query tile of 128 rows, b*h), heaviest causal tiles
//   first.  Two consumer warpgroups own 64 query rows each; one producer
//   warp issues every copy.
// * Copies: TMA loads the q tile once, then k and v tiles of 128 keys into
//   a ring of stages (3 at D = 64, 2 at D = 128; 112 and 160 KB of shared
//   memory with q), each guarded by a "full" mbarrier (bytes landed)
//   and an "empty" one (both warpgroups done with it).  Tensor maps are 4-D
//   over (D, S, H, B) with the caller's strides, so gqa_attend's (B, S, H,
//   D) buffers are read in place; a box is 64 columns (128 B, the widest
//   the 128 B swizzle takes) by 128 rows, so D = 128 takes two boxes.
//   Rows past S are filled with zeros by TMA and masked here.  Key tiles
//   wholly above the causal diagonal are never loaded.
// * S = Q K^T: wgmma m64n128k16, A (q) and B (k) from shared memory, both
//   K-major in the 128 B swizzle that TMA wrote.  bf16 x bf16 products are
//   exact in float32; scale * log2(e) is applied to the float32 scores
//   (not to q in bf16), folded into one FMA with the row max before exp2.
//   Only the diagonal tile (and a ragged last tile) is masked.
// * Online softmax on the accumulator fragment: a thread holds parts of
//   two rows, so a row max is two __shfl_xor_sync within the quad.  At
//   D = 64 the exp2s of a tile cost about as much MUFU time as its two
//   products cost tensor-core time, so each warpgroup issues tile j's
//   Q K^T together with tile j-1's P V and runs tile j's softmax while the
//   P V product is in flight (two P fragments live at once; faster than
//   taking turns at the serving shape, but only with a third stage).  At
//   D = 128 that would spill, so there the products and the softmax take
//   turns.
// * O += P V: P is rounded to bf16 and fed to wgmma m64n64k16 as the
//   register A operand (the f32 accumulator layout of S is the A-fragment
//   layout of P, so it never goes through shared memory); B is v from
//   shared memory, MN-major (the transpose bit).  l is summed from the
//   rounded P, so numerator and denominator agree.  This rounding of P is
//   the only arithmetic that departs from the TPU kernel.
// * Epilogue: acc / max(l, 1e-30) to bf16, plain stores through o's
//   strides.
//
// Left for later: warp specialisation with setmaxnreg, ping-pong between
// the two consumer warpgroups (so one's softmax hides under the other's
// wgmma), a persistent grid, TMA stores of o.
//
// cuTensorMapEncodeTiled (a libcuda entry point) is looked up with dlsym in
// the libcuda.so.1 that the CUDA runtime has already loaded, so the library
// links against nothing beyond the runtime.
//
// Plain C interface, the signature of flash_attn_bf16: element strides of
// b, h, s for q, k, v and o (D contiguous); launched on the caller's stream;
// returns a cudaError_t (cudaErrorInvalidValue for another head dim or a
// tensor map that cuTensorMapEncodeTiled refuses).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace {

constexpr int BQ = 128;                 // query rows per CTA
constexpr int BK = 128;                 // keys per tile
constexpr int CONSUMERS = 256;          // two warpgroups
constexpr int THREADS = CONSUMERS + 32; // plus one producer warp
constexpr int BOX_BYTES = 128 * 128;    // 128 rows x 64 bf16 columns
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tiles {
  // Overlap tile j's softmax with tile j-1's PV product where it pays: at
  // D = 64 (the softmax costs as much as the products) with a third stage,
  // since the overlap holds two stages at once.  At D = 128 the two live P
  // fragments and the wider accumulator would spill.
  static constexpr bool OVERLAP = D == 64;
  static constexpr int STAGES = OVERLAP ? 3 : 2;        // k/v ring depth
  static constexpr int CH = D / 64;     // 64-column boxes per row
  static constexpr int TILE = CH * BOX_BYTES;           // byte offsets in smem
  static constexpr int Q = 0;
  __host__ __device__ static constexpr int K(int s) {
    return TILE * (1 + 2 * s);
  }
  __host__ __device__ static constexpr int V(int s) {
    return TILE * (2 + 2 * s);
  }
  static constexpr int BYTES = TILE * (1 + 2 * STAGES);
};

struct OStrides {
  long long b, h, s;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// returns once the phase of parity `parity` has completed; a wait of more
// than 2^33 cycles (seconds) traps, so a broken pipeline ends the launch
// with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1LL << 33))
      __trap();
  }
}

// ---- TMA -----------------------------------------------------------------
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ---------------------------------------------------------------
// Shared-memory matrix descriptor for the 128 B swizzle: start address,
// leading and stride byte offsets (16 B units) and layout type 1 (B128).
// Every tile here is 8-row groups of 128 B rows, so the stride from one
// 8-row group to the next is 1024 B.  The leading offset is unused for
// K-major swizzled operands and for an MN-major operand one swizzle atom
// (64 elements) wide, which is all this kernel issues; it is set to the
// same 1024 B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N commit groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d(64x128, f32) (+)= A(64x16, smem, K-major) * B(16x128, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d(64x64, f32) += A(64x16, registers) * B(16x64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 128 keys, f32) = Q K^T for this warpgroup's 64 rows: D/16
// steps of 16 columns, 32 B apart in a 128 B swizzled row, one commit group
template <int D>
__device__ __forceinline__ void issue_qk(float (&sacc)[64], uint32_t qa,
                                         uint32_t kb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss_n128(sacc, sw128_desc(qa + off), sw128_desc(kb + off), kk > 0);
  }
  wgmma_commit();
}

// O += P V: 8 steps of 16 keys (2 KB of v rows each), one n64 product per
// 64-column box of v, one commit group
template <int CH>
__device__ __forceinline__ void issue_pv(float (&oacc)[CH][32],
                                         const uint32_t (&p)[32],
                                         uint32_t vb) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
#pragma unroll
    for (int c = 0; c < CH; ++c)
      wgmma_rs_n64(oacc[c], p[4 * j], p[4 * j + 1], p[4 * j + 2],
                   p[4 * j + 3], sw128_desc(vb + c * BOX_BYTES + j * 2048));
  wgmma_commit();
}

struct Rows {          // what a thread needs to mask and scale its scores
  int qp0;             // query position of row r0 (r0 + 8 is qp0 + 8)
  int cq;              // its first key column in each group of 8
  int Sk, causal;
  float scale_log2;    // D^-1/2 * log2(e)
};

struct Softmax {       // running max (raw scores), this thread's share of
  float m0, m1;        // the normalizer, and the last rescale factors, for
  float l0, l1;        // rows r0 and r0 + 8
  float corr0, corr1;
};

// Online softmax of one tile in the exp2 domain: mask, row max (two
// shuffles within the quad), P = exp2(s * c - m * c) rounded to bf16 and
// packed as the A fragments of the PV product (the 16-key step j takes
// p[4j .. 4j+3]), l summed from the rounded P.  sacc[4i + j] is (row r0,
// key 8i + cq + j), sacc[4i + 2 + j] the same key for row r0 + 8.
__device__ __forceinline__ void softmax_tile(float (&sacc)[64],
                                             uint32_t (&p)[32], Softmax& sm,
                                             const Rows& r, int k0,
                                             bool masked) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + 8 * i + r.cq + j;
        if (key >= r.Sk || (r.causal && key > r.qp0)) sacc[4 * i + j] = NEG;
        if (key >= r.Sk || (r.causal && key > r.qp0 + 8))
          sacc[4 * i + 2 + j] = NEG;
      }
  }
  float t0 = NEG, t1 = NEG;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    t0 = fmaxf(t0, fmaxf(sacc[4 * i], sacc[4 * i + 1]));
    t1 = fmaxf(t1, fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
  }
  t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
  t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
  t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
  t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
  const float c = r.scale_log2;
  const float mn0 = fmaxf(sm.m0, t0);
  const float mn1 = fmaxf(sm.m1, t1);
  sm.corr0 = ex2((sm.m0 - mn0) * c);
  sm.corr1 = ex2((sm.m1 - mn1) * c);
  sm.m0 = mn0;
  sm.m1 = mn1;
  const float ms0 = mn0 * c;
  const float ms1 = mn1 * c;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const __nv_bfloat162 pa =
        __floats2bfloat162_rn(ex2(fmaf(sacc[4 * i], c, -ms0)),
                              ex2(fmaf(sacc[4 * i + 1], c, -ms0)));
    const __nv_bfloat162 pb =
        __floats2bfloat162_rn(ex2(fmaf(sacc[4 * i + 2], c, -ms1)),
                              ex2(fmaf(sacc[4 * i + 3], c, -ms1)));
    const float2 fa = __bfloat1622float2(pa);
    const float2 fb = __bfloat1622float2(pb);
    ls0 += fa.x + fa.y;
    ls1 += fb.x + fb.y;
    p[2 * i] = as_u32(pa);
    p[2 * i + 1] = as_u32(pb);
  }
  sm.l0 = sm.l0 * sm.corr0 + ls0;
  sm.l1 = sm.l1 * sm.corr1 + ls1;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, OStrides so, int H,
                  int group, int Sq, int Sk, float scale_log2, int causal) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * T::STAGES + 1];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle
  const uint32_t full0 = smem_u32(&bars[0]);          // full[s] = +8 s
  const uint32_t empty0 = smem_u32(&bars[T::STAGES]);  // empty[s] = +8 s
  const uint32_t qbar = smem_u32(&bars[2 * T::STAGES]);

  const int qt = gridDim.y - 1 - blockIdx.y;           // heaviest first
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = qt * BQ;
  const int k_tiles = (Sk + BK - 1) / BK;
  const int n_kt = causal ? min(qt + 1, k_tiles) : k_tiles;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {                        // producer warp
    if (lane == 0) {
      const int hk = h / group;
      mbar_expect_tx(qbar, T::TILE);
#pragma unroll
      for (int c = 0; c < T::CH; ++c)
        tma_load(base + T::Q + c * BOX_BYTES, &tq, qbar, c * 64, q0, h, b);
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % T::STAGES;
        mbar_wait(empty0 + 8 * s, ((it / T::STAGES) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * T::TILE);
#pragma unroll
        for (int c = 0; c < T::CH; ++c) {
          tma_load(base + T::K(s) + c * BOX_BYTES, &tk, full0 + 8 * s,
                   c * 64, it * BK, hk, b);
          tma_load(base + T::V(s) + c * BOX_BYTES, &tv, full0 + 8 * s,
                   c * 64, it * BK, hk, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns tile rows 64 wg .. 64 wg + 63 --------
  const int wg = warp / 4;
  const int r0 = wg * 64 + (warp & 3) * 16 + lane / 4;  // and r0 + 8
  const int cq = 2 * (lane & 3);                        // first column pair
  const uint32_t qa = base + T::Q + wg * 64 * 128;
  const Rows rows{q0 + r0, cq, Sk, causal, scale_log2};

  float sacc[64];
  float oacc[T::CH][32];
#pragma unroll
  for (int c = 0; c < T::CH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[c][i] = 0.f;
  Softmax sm{NEG, NEG, 0.f, 0.f, 1.f, 1.f};
  uint32_t p[32];                     // P of the tile whose PV is pending

  mbar_wait(qbar, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int s = it % T::STAGES;
    const int sp = (it + T::STAGES - 1) % T::STAGES;
    const bool pending = T::OVERLAP && it > 0;          // PV of tile it-1
    mbar_wait(full0 + 8 * s, (it / T::STAGES) & 1);
    reg_fence(sacc);
#pragma unroll
    for (int c = 0; c < T::CH; ++c) reg_fence(oacc[c]);
    reg_fence(p);
    wgmma_fence();
    issue_qk<D>(sacc, qa, base + T::K(s));
    if (pending) {
      issue_pv<T::CH>(oacc, p, base + T::V(sp));
      wgmma_wait<1>();                                  // S only
    } else {
      wgmma_wait<0>();
    }
    reg_fence(sacc);
    uint32_t pn[32];
    const int k0 = it * BK;
    softmax_tile(sacc, pn, sm, rows, k0,
                 (causal && it == n_kt - 1) || k0 + BK > Sk);
    if (pending) {
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < T::CH; ++c) reg_fence(oacc[c]);
      reg_fence(p);                   // p stays live until PV has read it
      mbar_arrive(empty0 + 8 * sp);                     // stage sp is free
    }
#pragma unroll
    for (int c = 0; c < T::CH; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        oacc[c][4 * i] *= sm.corr0;
        oacc[c][4 * i + 1] *= sm.corr0;
        oacc[c][4 * i + 2] *= sm.corr1;
        oacc[c][4 * i + 3] *= sm.corr1;
      }
    if (T::OVERLAP) {
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pn[i];
    } else {
#pragma unroll
      for (int c = 0; c < T::CH; ++c) reg_fence(oacc[c]);
      reg_fence(pn);
      wgmma_fence();
      issue_pv<T::CH>(oacc, pn, base + T::V(s));
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < T::CH; ++c) reg_fence(oacc[c]);
      reg_fence(pn);
      mbar_arrive(empty0 + 8 * s);                      // stage s is free
    }
  }
  if (T::OVERLAP) {                                     // PV of the last tile
    const int sl = (n_kt - 1) % T::STAGES;
#pragma unroll
    for (int c = 0; c < T::CH; ++c) reg_fence(oacc[c]);
    reg_fence(p);
    wgmma_fence();
    issue_pv<T::CH>(oacc, p, base + T::V(sl));
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < T::CH; ++c) reg_fence(oacc[c]);
    reg_fence(p);
  }

  // ---- epilogue ----------------------------------------------------------
  const int qp0 = rows.qp0;
  const int qp1 = qp0 + 8;
  float l0 = sm.l0, l1 = sm.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f);
  const float den1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + b * so.b + h * so.h + cq;
  if (qp0 < Sq) {
    __nv_bfloat16* op = ob + qp0 * so.s;
#pragma unroll
    for (int c = 0; c < T::CH; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(op + c * 64 + 8 * i) =
            __floats2bfloat162_rn(oacc[c][4 * i] / den0,
                                  oacc[c][4 * i + 1] / den0);
  }
  if (qp1 < Sq) {
    __nv_bfloat16* op = ob + qp1 * so.s;
#pragma unroll
    for (int c = 0; c < T::CH; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(op + c * 64 + 8 * i) =
            __floats2bfloat162_rn(oacc[c][4 * i + 2] / den1,
                                  oacc[c][4 * i + 3] / den1);
  }
}

// ---- host ------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// (D, S, H, B) view of a bf16 tensor with element strides st = {b, h, s};
// boxes of 64 columns x 128 rows in the 128 B swizzle
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int Hn, int Bn,
              const long long* st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)Hn,
                              (cuuint64_t)Bn};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, BK, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int Sq, int Sk, const long long* st, int causal,
             void* stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, Sq, H, B, st) ||
      !make_map(&tk, k, D, Sk, Hkv, B, st + 3) ||
      !make_map(&tv, v, D, Sk, Hkv, B, st + 6))
    return (int)cudaErrorInvalidValue;
  const int smem = Tiles<D>::BYTES + 1024;             // + alignment slack
  const cudaError_t err = cudaFuncSetAttribute(
      flash_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const OStrides so{st[9], st[10], st[11]};
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  const float scale_log2 = LOG2E / sqrtf((float)D);
  flash_sm90_kernel<D><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, so, H, H / Hkv, Sq, Sk, scale_log2,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_sm90_bf16(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int Hkv, int Sq, int Sk,
                               int D, const long long* strides, int causal,
                               void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  switch (D) {
    case 64:   // qwen1.5-0.5b
      return launch_d<64>(q, k, v, o, B, H, Hkv, Sq, Sk, strides, causal,
                          stream);
    case 128:  // qwen2.5-14b, mistral-large-123b
      return launch_d<128>(q, k, v, o, B, H, Hkv, Sq, Sk, strides, causal,
                           stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
