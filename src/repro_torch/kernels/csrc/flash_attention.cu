// Flash attention for prefill on Hopper (sm_90a): causal or full, GQA-aware.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (body _attn_kernel).  Same contract: q [B,Sq,H,hd], k/v [B,Skv,KV,hd],
// query head h reads kv head h / (H/KV) without a repeated copy; causal
// query rows sit at position row + (Skv - Sq); causally masked scores are
// -1e30 and columns past Skv -inf; m/l/acc are fp32 and the output is
// acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on an H100: both roofs are close.  At the qwen2-7b
// serving shape (batch 8 x 512 tokens, 28 heads, hd 128, causal, bf16) one
// layer needs about 1.5e10 FLOP (15 us at 989 TFLOP/s) and must move 67 MB
// of q, k, v and o (20 us at 3.35 TB/s): ~224 FLOP/byte, just under the
// ~295 ridge, because GQA makes q and o 7x larger than k and v.  Longer
// prompts move it onto the tensor cores' side (FLOP grow as S^2).  Only
// wgmma reaches the tensor cores' rate (989 TFLOP/s in bf16, against about
// 67 TFLOP/s on the FP32 FMA pipes).
//
// The bf16 instance (the serving path), what it does about that:
// * One block owns one (batch, query head, 128-row query tile): two
//   consumer warpgroups of 64 query rows each, and one producer warpgroup
//   whose elected thread starts every TMA load.  setmaxnreg moves the
//   registers: the producer drops to 24 a thread, the consumers rise to
//   240, enough for the S and O accumulators and P's fragments (at 168, the
//   even split of 384 threads, ptxas serialises the wgmmas at hd 128 and
//   spills at hd 256).
// * Q is loaded once by TMA; K and V stream through a ring of STAGES
//   shared-memory stages with mbarrier completion ("full", counted in
//   bytes) and release ("empty", one arrival per consumer thread).  The
//   tensor maps are 4-D (hd, heads, S, B) over the caller's strides, so a
//   tile's rows past S are zero-filled by TMA and never read from the next
//   batch.  Each 64-column box is written with the 128-byte swizzle that
//   wgmma's shared-memory descriptors read.  hd 112 loads two 64-column
//   boxes, the second zero-filled past column 112: it runs the hd-128
//   instance and stores 112 columns.
// * S = Q K^T is wgmma m64nBKVk16 with both operands in shared memory,
//   K-major (BKV = 128 for hd <= 128, 64 for hd 256).  The online softmax
//   runs in fp32 registers in the accumulator's layout: a row's max and sum
//   are reduced over the 4 lanes that share it.  The scale (with log2 e
//   folded in, for exp2) is applied to S in fp32.  Masks are applied only
//   on the diagonal tiles and the ragged last one; tiles wholly above the
//   causal diagonal are not loaded at all (about half the work at Sq ==
//   Skv), and heavy query tiles are scheduled first.
// * O += P V is wgmma with A = P from registers, rounded to bf16 (the
//   accumulator layout of S is the A-fragment layout), and B = V read
//   MN-major through the descriptor's transpose bit, so V is never
//   transposed in memory.  Rounding P to bf16 is what PyTorch's SDPA does
//   too; the bf16 tolerance of 2e-2 against the fp32 plain version covers
//   it (P's rounding is 2^-9 relative, the output's own bf16 rounding the
//   same).
// * The epilogue writes O / max(l, 1e-30) as bf16 from registers with row
//   and column masks.
// TMA needs a 16-byte-aligned base and 16-byte-multiple strides: the
// wrapper checks both and raises on a tensor that fails.
//
// The fp32 instance keeps the FP32-FMA body (64-row tiles, 4x4 register
// tiles, scalar loads).  Tensor cores cannot meet the fp32 tolerance of
// 2e-5 (TF32 keeps about 3 digits), and fp32 is used only by the fp32
// model checks, never by serving.  flash_attention_launch picks the body
// by dtype.
#include <atomic>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

struct Strides {
  int64_t b, s, h;  // in elements; the head_dim stride is 1
};

constexpr float NEG_INF = -1e30f;

// The dynamic shared-memory opt-in is a property of a kernel on a device:
// set it on the kernel's first launch on each device, not on every launch.
// `done` holds one bit per device index (indices 0-63).
template <typename Kern>
cudaError_t opt_in_smem(Kern kern, size_t smem, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return e;
}

// ===========================================================================
// fp32 instance: FP32 FMA products from fp32 shared-memory tiles.
namespace fp32 {

constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 64;       // key/value rows per tile
constexpr int THREADS = 256;  // a 16 x 16 thread grid over the 64 x 64 score tile
constexpr int RJ = BQ / 16;   // query rows per thread (ty + 16 i)
constexpr int CJ = BKV / 16;  // score columns per thread (tx + 16 j)
constexpr int PS = BKV + 16;  // row stride of the probability tile: two rows per warp on disjoint banks

// Reduce over the 16 lanes that share one query row (lanes differing in bits 0-3).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  // q and k tiles use a padded row stride HD + 1 so that a column read
  // (16 different rows, same d) hits 16 different banks.
  return sizeof(float) * (size_t)(BQ * (HD + 1) + BKV * (HD + 1) + BKV * HD + BQ * PS);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o, int Sq,
                            int Skv, int G, Strides qs, Strides ks, Strides vs, Strides os,
                            float scale, int causal) {
  static_assert(HD % 16 == 0, "each thread owns output columns tx + 16 j");
  constexpr int QS = HD + 1;
  constexpr int DJ = HD / 16;  // output columns per thread (tx + 16 j)
  extern __shared__ float smem[];
  float* sq = smem;            // [BQ][QS], pre-scaled
  float* sk = sq + BQ * QS;    // [BKV][QS]
  float* sv = sk + BKV * QS;   // [BKV][HD]
  float* sp = sv + BKV * HD;   // [BQ][PS] probabilities of the current tile

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int offset = Skv - Sq;  // causal: query row r sits at key position r + offset

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (q0 + r < Sq) x = qb[(int64_t)(q0 + r) * qs.s + d] * scale;
    sq[r * QS + d] = x;
  }

  float m[RJ], l[RJ], acc[RJ][DJ];
#pragma unroll
  for (int i = 0; i < RJ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // Keys past the last query row's position are masked for every row of
  // the tile: those tiles are skipped.
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, min(q0 + BQ, Sq) + offset);

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile is consumed (and sq is written)
    for (int i = tid; i < BKV * HD; i += THREADS) {
      const int c = i / HD, d = i % HD;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < Skv) {
        kx = kb[(int64_t)(k0 + c) * ks.s + d];
        vx = vb[(int64_t)(k0 + c) * vs.s + d];
      }
      sk[c * QS + d] = kx;
      sv[c * HD + d] = vx;
    }
    __syncthreads();

    float s[RJ][CJ];
#pragma unroll
    for (int i = 0; i < RJ; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RJ], kv[CJ];
#pragma unroll
      for (int i = 0; i < RJ; ++i) qv[i] = sq[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = sk[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < RJ; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RJ; ++i) {
      const int qpos = q0 + ty + 16 * i + offset;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tx + 16 * j;
        // Columns past Skv are not part of the problem: -inf gives them
        // probability 0 exactly.  Causally masked columns take the
        // reference's -1e30.
        if (col >= Skv) s[i][j] = -INFINITY;
        else if (causal && col > qpos) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[(ty + 16 * i) * PS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float pv[RJ];
#pragma unroll
      for (int i = 0; i < RJ; ++i) pv[i] = sp[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = sv[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RJ; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RJ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* ob = o + b * os.b + (int64_t)row * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[tx + 16 * j] = acc[i][j] / den;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Skv, int H, int KV, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, cudaStream_t stream) {
  auto kern = flash_attention_fp32_kernel<HD>;
  constexpr size_t smem = smem_bytes<HD>();
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t e = opt_in_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H / KV, qs, ks, vs, os,
      scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B,
                      int Sq, int Skv, int H, int KV, Strides qs, Strides ks, Strides vs,
                      Strides os, float scale, int causal, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, scale, causal, stream);
    case 112:
      return launch<112>(q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, scale, causal, stream);
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, scale, causal, stream);
    case 256:
      return launch<256>(q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace fp32

// ===========================================================================
// bf16 instance: wgmma fed by TMA.
namespace bf16 {

constexpr int BQ = 128;                  // query rows per block
constexpr int CONSUMERS = 256;           // two warpgroups of 64 query rows each
constexpr int THREADS = CONSUMERS + 128; // and one producer warpgroup
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 <= 65,536
constexpr int STAGES = 2;                // K/V ring depth
constexpr int BOX = 64;                  // columns of one TMA box: 128 bytes, the swizzle span
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One 4-D box (hd columns, heads, rows, batch) into shared memory; the
// barrier's transaction count falls by the box's bytes when it lands.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  For a K-major operand
// (Q, K) the leading offset is unused and the stride offset steps between
// groups of 8 rows (1024 bytes); for the MN-major V the leading offset
// steps between 64-column boxes and the stride offset between groups of 8
// rows along K.  Every box starts 1024-byte aligned, so base_offset is 0.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Tie registers to the surrounding asm so that the compiler neither reads
// an accumulator before wgmma.wait_group nor moves a write past the wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma m64nNk16, f32 += bf16 x bf16.  ss: A and B from shared memory, both
// K-major.  rs: A from registers, B from shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  else wgmma_ss_n128(d, a, b, scale_d);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// HDP: the padded head dim (64, 128 or 256); hd 112 runs HDP 128.
template <int HDP>
struct Cfg {
  static constexpr int SLABS = HDP / BOX;           // 64-column boxes per row
  static constexpr int BKV = HDP <= 128 ? 128 : 64;  // key rows per tile
  static constexpr uint32_t Q_SLAB = BQ * 128, KV_SLAB = BKV * 128;
  static constexpr uint32_t Q_BYTES = SLABS * Q_SLAB, KV_BYTES = SLABS * KV_SLAB;
  static constexpr size_t SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES) + 1024;
};

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ o, Strides os, int hd, int Sq, int Skv,
                            int G, float scale_log2, int causal) {
  using C = Cfg<HDP>;
  constexpr int BKV = C::BKV, SLABS = C::SLABS;
  extern __shared__ uint8_t smem_raw[];
  // shared memory: Q | K stages | V stages | barriers, the boxes 1024-byte
  // aligned (the 128-byte swizzle repeats every 8 rows of 128 bytes)
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;
  const uint32_t sV = sK + STAGES * C::KV_BYTES;
  const uint32_t q_bar = sV + STAGES * C::KV_BYTES;
  const uint32_t full_bar = q_bar + 8, empty_bar = full_bar + 8 * STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int offset = Skv - Sq;  // causal: query row r sits at key position r + offset
  // Keys past the last query row's position are masked for every row of
  // the block: those tiles are never loaded.
  const int kv_end = causal ? min(Skv, min(q0 + BQ, Sq) + offset) : Skv;
  const int ntiles = (kv_end + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_bar, C::Q_BYTES);
      for (int s = 0; s < SLABS; ++s) tma_load(sQ + s * C::Q_SLAB, &tq, q_bar, s * BOX, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int stage = t % STAGES;
        if (t >= STAGES) mbar_wait(empty_bar + 8 * stage, ((t / STAGES) - 1) & 1);
        const uint32_t full = full_bar + 8 * stage;
        mbar_expect_tx(full, 2 * C::KV_BYTES);
        const uint32_t k_dst = sK + stage * C::KV_BYTES, v_dst = sV + stage * C::KV_BYTES;
        for (int s = 0; s < SLABS; ++s) {
          tma_load(k_dst + s * C::KV_SLAB, &tk, full, s * BOX, kvh, t * BKV, b);
          tma_load(v_dst + s * C::KV_SLAB, &tv, full, s * BOX, kvh, t * BKV, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // The consumers.  In wgmma's accumulator layout a thread holds rows
  // r0 = 16 warp + lane/4 and r0 + 8 of its warpgroup's 64, and of each
  // row the columns 8 j + 2 (lane % 4) + {0, 1}: register i sits at row
  // r0 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (lane & 3) + (i & 1).
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int wg_row = q0 + 64 * wg;         // this warpgroup's first query row
  const int r0 = wg_row + 16 * warp + lane / 4;
  const bool wg_live = wg_row < Sq;
  const int wg_kv_end = causal ? min(Skv, min(wg_row + 64, Sq) + offset) : Skv;

  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's columns only

  mbar_wait(q_bar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int stage = t % STAGES;
    mbar_wait(full_bar + 8 * stage, (t / STAGES) & 1);
    const int k0 = t * BKV;
    if (wg_live && k0 < wg_kv_end) {
      const uint32_t k_tile = sK + stage * C::KV_BYTES, v_tile = sV + stage * C::KV_BYTES;
      // S = Q K^T over hd, 16 columns of hd a step
      float s[BKV / 2];
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl)
#pragma unroll
        for (int kk = 0; kk < BOX / 16; ++kk)
          mma_ss<BKV>(s, desc(sQ + sl * C::Q_SLAB + wg * 64 * 128 + kk * 32, 16, 1024),
                      desc(k_tile + sl * C::KV_SLAB + kk * 32, 16, 1024), sl | kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) s[i] *= scale_log2;
      // Columns past Skv take -inf (probability 0 exactly); causally masked
      // ones the reference's -1e30.  Only the ragged last tile and the
      // tiles crossing this warpgroup's diagonal need it.
      if (k0 + BKV > Skv || (causal && k0 + BKV - 1 > wg_row + offset)) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int row = r0 + 8 * ((i >> 1) & 1);
          if (col >= Skv) s[i] = -INFINITY;
          else if (causal && col > row + offset) s[i] = NEG_INF;
        }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

      // P in bf16 as wgmma's A fragments: 16 columns of S a step
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

      // O += P V: V's rows are the contraction, 16 a step (2048 bytes)
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint32_t v_rows = v_tile + kk * 16 * 128;
        if constexpr (HDP == 64) {
          wgmma_rs_n64(acc, pa[kk], desc(v_rows, C::KV_SLAB, 1024), 1);
        } else {
#pragma unroll
          for (int n = 0; n < HDP / 128; ++n)
            wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(acc + 64 * n), pa[kk],
                          desc(v_rows + 2 * n * C::KV_SLAB, C::KV_SLAB, 1024), 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(empty_bar + 8 * stage);
  }

  if (!wg_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const float inv = 1.f / fmaxf(quad_sum(l[r]), 1e-30f);
    if (row >= Sq) continue;
    __nv_bfloat16* ob = o + b * os.b + (int64_t)row * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(ob + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime so that no -lcuda is
// needed.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Launcher errors of our own, beside the cudaError_t codes.
constexpr int ERR_NO_ENCODER = 10000;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 20000;       // + the CUresult of a failed encode

// A map over [B, S, heads, hd] with the caller's element strides; boxes of
// 64 columns x `rows` rows of one head of one batch.
int encode(CUtensorMap* map, const void* base, int hd, int heads, int S, int B, Strides st,
           int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int H,
           int KV, int hd, Strides qs, Strides ks, Strides vs, Strides os, float scale,
           int causal, cudaStream_t stream) {
  using C = Cfg<HDP>;
  CUtensorMap tq, tk, tv;
  int e = encode(&tq, q, hd, H, Sq, B, qs, BQ);
  if (e == 0) e = encode(&tk, k, hd, KV, Skv, B, ks, C::BKV);
  if (e == 0) e = encode(&tv, v, hd, KV, Skv, B, vs, C::BKV);
  if (e != 0) return e;
  auto kern = flash_attention_bf16_kernel<HDP>;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t ce = opt_in_smem(kern, C::SMEM, smem_set);
  if (ce != cudaSuccess) return ce;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), os, hd,
                                           Sq, Skv, H / KV, scale * LOG2E, causal);
  return cudaGetLastError();
}

int launch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int Sq,
              int Skv, int H, int KV, Strides qs, Strides ks, Strides vs, Strides os,
              float scale, int causal, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, B, Sq, Skv, H, KV, hd, qs, ks, vs, os, scale, causal, stream);
    case 112:
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Skv, H, KV, hd, qs, ks, vs, os, scale, causal,
                         stream);
    case 256:
      return launch<256>(q, k, v, o, B, Sq, Skv, H, KV, hd, qs, ks, vs, os, scale, causal,
                         stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bf16
}  // namespace

// dtype: 0 = float32 (the FMA body), 1 = bfloat16 (the wgmma body).
// Strides are in elements; for bfloat16 the bases must be 16-byte aligned
// and the strides multiples of 8 elements (TMA).  Returns 0 on success, the
// cudaError_t of a failed launch, or one of the tensor-map errors above;
// the kernel runs on `stream` and nothing here synchronises.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int H,
    int KV, int hd, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, float scale, int causal, int dtype, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fp32::launch_hd(hd, q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, scale, causal, st);
  if (dtype == 1)
    return bf16::launch_hd(hd, q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, scale, causal, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int e) {
  static thread_local char msg[96];
  if (e == bf16::ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not available (libcuda older than CUDA 12)";
  if (e >= bf16::ERR_ENCODE) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)", e - bf16::ERR_ENCODE);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
