// Mamba2 SSD scan (chunked dual form) on Hopper (sm_90a), fp32 in and out,
// the chunk products on the tensor cores as 3xTF32.
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_scan_pallas (body
// _ssd_kernel).  Same contract: x [B,S,nh,hd], dt [B,S,nh] (softplus'd),
// A [nh] (< 0), Bm/Cm [B,S,ds], an optional init_state [B,nh,hd,ds]; it
// returns y [B,S,nh,hd] and the final state [B,nh,hd,ds], all fp32.  Per
// chunk of Q rows, with cs the cumulative sum of dt*A inside the chunk:
//   y     = (L o C B^T)(x dt) + exp(cs) (C state^T),  L[i,j] = exp(cs_i - cs_j), i >= j
//   state = state exp(cs_last) + sum_j exp(cs_last - cs_j) dt_j x_j (x) B_j
//
// What bounds it on an H100: at the serving shapes, bytes or operations on
// the tensor cores at fp32 accuracy.  x and y are 0.22 GB at zamba2-7b's
// shape (B 8, S 474, nh 112, hd 64, ds 64): 0.065 ms at 3.35 TB/s.  The
// least FLOP (the recurrence's 5 hd ds a row, or the dual form over its
// causal triangles) run at 495/3 TFLOP/s, the TF32 rate over three passes.
//
// What this design does about it:
// * C B^T once.  In Mamba2, B and C are shared by all heads, so C B^T of a
//   chunk is the same for every head and every slice of hd.  A first
//   kernel (ssd_cb_kernel, one block a (chunk, batch)) computes it on
//   mma.sync m16n8k8 TF32 over the 20 of its 32 tiles on or below the
//   diagonal, dealt so that each SM sub-partition gets six, into a scratch
//   of B * chunks * 64 * 64 floats (1 MB at zamba2-7b's shape, read back
//   from L2).  The scan kernel copies each chunk's C B^T into shared
//   memory beside its other tiles and applies L in place.
// * More blocks.  The state's hd rows are independent: y[:, p] and the
//   state's row p depend on x[:, p] only, while C B^T and L are shared by
//   all p.  So a block of the scan kernel owns one (batch, head, slice of
//   P of the hd columns); the wrapper picks P (ssd_scan.slice_plan).
//   Nothing but y and the final state goes to device memory: each block
//   walks its fixed 64-row chunks in order with its [P, ds] state in
//   registers (as wgmma accumulators).
// * Tensor cores.  The other three products of a chunk run on wgmma
//   m64nNk8 TF32 (two warpgroups):
//   y = (L o C B^T)(x dt) + (exp(cs) C) state^T, and the
//   state update state^T += (B w)^T (x dt).  wgmma takes TF32 operands from
//   shared memory only K-major, so each A operand (G, C, B^T rows) is read
//   into registers from the padded raw tiles, and the two B operands that
//   the tensor cores read from shared memory are written K-major with the
//   128-byte swizzle once per chunk: x dt as [p][j] (a pass while warp 0
//   sums the decay) and the entering state as [p][n] (from the state's
//   registers at the end of the previous chunk).  For y at P <= 32 the
//   warpgroups split each product's K and add their halves (Cfg::KSPLIT),
//   so that neither builds the other's A fragments; at P 64 they split
//   the columns.  For the state they split p (ds <= 64) or n (ds 128).
// * fp32 accuracy.  TF32 keeps 10 mantissa bits (about 5e-4), far from the
//   2e-6 against a float64 recurrence the port holds the SSD to.  Each
//   operand is split into hi = tf32(v) and lo = tf32(v - hi) (cvt.rna, round
//   to nearest), and a product is hi.hi + (hi.lo + lo.hi) (lo.lo, ~2^-22
//   relative, is dropped), the small terms in their own accumulator.  In
//   the mma.sync product the hi.hi term of each k-step of 8 comes from a
//   fresh accumulator and is added to the sum in fp32 with round-to-
//   nearest; the wgmma products do the same for each batch of four
//   k-steps (the worst case of chip_smoke's SSD sweep against float64 read
//   3.5e-7 of the largest value so, 9.8e-7 with hi.hi summed over all of K
//   in the tensor cores; H100).
// * Latency.  With one block of 8 warps an SM (shared memory), little
//   hides a dependent chain.  Every loop over k and over a warp's tiles is
//   unrolled without branches, so that the independent mmas of several
//   tiles and k-steps interleave; a wgmma batch (four k-steps) has its A
//   fragments built before it is issued and kept until it is done; the
//   elementwise passes (x dt's split, L) read all their shared-memory
//   values before they write any: the compiler cannot tell those reads
//   from the writes, and would otherwise run each element in turn.
// * Overlap.  The next chunk's x, dt, B and C are copied with cp.async
//   (16-byte copies where strides and bases allow, 4-byte ones otherwise)
//   into the other half of a double buffer while this chunk computes; its
//   C B^T lands in the G tile once this chunk's y has read G, while the
//   state update runs.
// * Ragged S.  Rows past S are zero-filled by the copies (dt = 0, x = B =
//   C = 0), so their decay is exp(0) = 1, their update 0, and their y rows
//   are not written.  Above the diagonal L's mask clears the bits of the
//   product, so an overflowing exp of a positive difference there (inf,
//   NaN with a zero C B^T) never reaches G.
//
// Precision of the decay: cs is summed in fp64.  With A down to -16, cs
// reaches about -1000 within a chunk; in fp32 each cs carries an absolute
// rounding of ~6e-5, which becomes the relative error of the L entries
// that matter (those near the diagonal).  From fp64 sums the differences
// are exact to fp32 precision before expf.
#include <atomic>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;          // chunk rows
constexpr int WARPS = 8;       // two warpgroups; the tile deals below assume 8
constexpr int THREADS = 32 * WARPS;
constexpr int GS = Q + 4;      // row stride of the L o C B^T tile
// The 20 tiles of G = L o C B^T on or below the diagonal (16-row tile rt,
// 8-column tile ct <= 2 rt + 1), dealt three to a warp with one row tile
// each, so that the two warps of every SM sub-partition (w and w + 4)
// compute six (a repeated tile is computed twice and stored twice).
__constant__ int8_t G_RT[WARPS] = {3, 3, 2, 1, 3, 2, 1, 0};
__constant__ int8_t G_CT[WARPS][3] = {{0, 1, 2}, {3, 4, 5}, {0, 1, 2}, {0, 1, 2},
                                      {6, 7, 7}, {3, 4, 5}, {3, 3, 3}, {0, 1, 1}};

struct Strides {
  int64_t b, s, h;  // in elements; the innermost stride is 1
};

struct Args {
  const float *x, *dt, *A, *Bm, *Cm, *s0;
  float *y, *sf;
  float* cb;  // [B][chunks][Q][Q] C B^T of each chunk (written by ssd_cb_kernel)
  int S, nh, hd;
  Strides xs, dts, bs, cs, ys;
  bool vec;  // 16-byte copies of x, B and C rows are aligned
};

// Shared memory.  Raw tiles as cp.async lands them (B, C and x double-
// buffered): B and C rows pad by 4 floats (fragment reads of 8 rows x 4
// columns hit 32 banks), x rows by 8 (4 rows x 8 columns).  The wgmma B
// operands are split into hi and lo copies, K-major with the 128-byte
// swizzle: x dt as [p][j] (K = the chunk's 64 rows, two slabs of 32) and
// the entering state as [p][n] (K = ds, ds / 32 slabs).
template <int P, int DS>
struct Cfg {
  static constexpr int BS = DS + 4, XS = P + 8;
  static_assert(XS % 32 == 8 || XS % 32 == 24, "x rows: 4 rows x 8 columns hit 32 banks");
  static constexpr int NSL = DS < 32 ? 1 : DS / 32;          // state slabs
  static constexpr uint32_t X_BYTES = P * 2 * 128, S_BYTES = P * NSL * 128;
  static constexpr size_t RAW = sizeof(double) * Q +
      sizeof(float) * (size_t)(2 * Q + 2 * Q + 2 * 2 * Q * BS + 2 * Q * XS + Q * GS);
  static constexpr size_t SMEM = RAW + 1024 + 2 * X_BYTES + 2 * S_BYTES;
  static_assert(SMEM <= 232448, "fits an SM's shared memory");
  // y: at P <= 32 each warpgroup takes all P columns over half of each
  // product's K (the chunk's rows, the state's n), so that neither builds
  // the other's A fragments, and the halves are added through shared
  // memory; at P 64 each takes half of the columns over all of K (all P
  // columns would need more registers than a thread has).
  static constexpr bool KSPLIT = P <= 32;
  static constexpr int NY = KSPLIT ? P : P / 2;     // y columns of a warpgroup
  static constexpr bool SPLIT_N = DS <= 64;         // state: split p, else n
  static constexpr int NS = SPLIT_N ? P / 2 : P;    // state columns of a warpgroup
  static_assert(DS <= 128 && (SPLIT_N || DS == 128), "64 state rows a warpgroup");
};

// ---------------------------------------------------------------------------
// 3xTF32.  Each operand is split into hi = tf32(v) and lo = tf32(v - hi),
// both rounded to nearest (cvt.rna); a product is hi.hi + (hi.lo + lo.hi).
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

template <int N>
struct Split {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int i, float v) {
    hi[i] = tf32(v);
    lo[i] = tf32(v - __uint_as_float(hi[i]));
  }
};

// mma.sync m16n8k8 TF32.  A fragment (16 x 8, row): a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4); B (8 x 8, col): b0 (k t, n g), b1 (k t+4,
// n g); C: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1); g = lane
// / 4, t = lane % 4.  wgmma's A fragment in registers has the same layout
// per warp (rows 16 w .. of the warpgroup's 64).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b (a zero accumulator).
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// A 16 x 8 tile summed over k-steps of 8 in 3xTF32: `big` the hi.hi terms,
// each k-step's from a fresh accumulator added with round-to-nearest;
// `small` the hi.lo and lo.hi terms, accumulated in the tensor cores.
struct Acc {
  float big[4], small[4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i) big[i] = small[i] = 0.f;
  }
  __device__ __forceinline__ void mma3(const Split<4>& a, const Split<2>& b) {
    float d[4];
    mma_tf32_zero(d, a.hi, b.hi);
    mma_tf32(small, a.lo, b.hi);
    mma_tf32(small, a.hi, b.lo);
#pragma unroll
    for (int i = 0; i < 4; ++i) big[i] += d[i];
  }
  __device__ __forceinline__ float operator[](int i) const { return big[i] + small[i]; }
};

// ---------------------------------------------------------------------------
// wgmma m64nNk8 TF32, A from registers, B from shared memory (K-major,
// 128-byte swizzle).
__device__ __forceinline__ void wgmma_tf32_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  if constexpr (N == 8) wgmma_tf32_n8(d, a, b, scale_d);
  else if constexpr (N == 16) wgmma_tf32_n16(d, a, b, scale_d);
  else wgmma_tf32_n32(d, a, b, scale_d);
  static_assert(N == 8 || N == 16 || N == 32, "a warpgroup's y or state columns");
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
// Tie registers to the surrounding asm: accumulators are not read before
// wgmma.wait_group, and A fragments stay untouched until it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row, k) of a K-major operand of `rows` rows with
// the 128-byte swizzle: slabs of 32 floats of K, each [rows][128 bytes];
// in a row the 16-byte chunk c sits at c ^ (row % 8).
__device__ __forceinline__ uint32_t kmaj(int row, int k, int rows) {
  return (uint32_t)((k >> 5) * rows * 128 + row * 128 +
                    ((((k & 31) >> 2) ^ (row & 7)) << 4) + ((k & 3) << 2));
}
// wgmma descriptor of rows row0.. (a multiple of 8) at k-step kb (8 floats).
__device__ __forceinline__ uint64_t kdesc(uint32_t base, int row0, int kb, int rows) {
  const uint32_t addr = base + (kb >> 2) * rows * 128 + row0 * 128 + (kb & 3) * 32;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// v split into its TF32 halves, stored at byte `off` of the hi and lo copies.
__device__ __forceinline__ void store_split(unsigned char* hi, unsigned char* lo, uint32_t off,
                                            float v) {
  const uint32_t h = tf32(v);
  *reinterpret_cast<uint32_t*>(hi + off) = h;
  *reinterpret_cast<uint32_t*>(lo + off) = tf32(v - __uint_as_float(h));
}

// acc (+)= a b over KB k-steps of 8 on the tensor cores in 3xTF32: `big`
// sums hi.hi, `small` hi.lo + lo.hi.  a_at(kb, frag) fills one k-step's
// A fragment; B is the hi/lo pair of K-major operands at rows row0...,
// from its k-step kb0 on.
// Four k-steps a batch: their A fragments are built first and stay
// untouched until the batch's wgmmas are done.  Each batch's hi.hi terms
// go to a fresh accumulator that is added to `big` in fp32, so the tensor
// cores' truncation compounds over 32 products at most.
template <int N, int KB, typename AFrag>
__device__ __forceinline__ void wg_product(float (&big)[N / 2], float (&small)[N / 2], AFrag a_at,
                                           uint32_t b_hi, uint32_t b_lo, int row0, int rows,
                                           bool accumulate, int kb0 = 0) {
  constexpr int G = KB < 4 ? KB : 4;
#pragma unroll
  for (int k0 = 0; k0 < KB; k0 += G) {
    Split<4> a[G];
#pragma unroll
    for (int u = 0; u < G; ++u) a_at(k0 + u, a[u]);
    float part[N / 2];
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int kb = k0 + u;
      wgmma_tf32<N>(part, a[u].hi, kdesc(b_hi, row0, kb0 + kb, rows), u > 0);
      wgmma_tf32<N>(small, a[u].lo, kdesc(b_hi, row0, kb0 + kb, rows), accumulate || kb > 0);
      wgmma_tf32<N>(small, a[u].hi, kdesc(b_lo, row0, kb0 + kb, rows), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
    fence_regs(small);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) big[i] = (accumulate || k0 > 0) ? big[i] + part[i] : part[i];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      fence_regs(a[u].hi);
      fence_regs(a[u].lo);
    }
  }
}

// ---------------------------------------------------------------------------
// Copy `bytes` (4 or 16) from src, or zero-fill them when !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `Q` rows x `COLS` floats (row stride `ld` in global memory, `lds` in
// shared), rows at or past `valid_rows` zero-filled.
template <int BYTES, int COLS>
__device__ __forceinline__ void copy_rows(float* dst, int lds, const float* src, int64_t ld,
                                          int valid_rows) {
  constexpr int V = BYTES / 4, PER_ROW = COLS / V;
  // kept rolled: unrolled, its addresses are hoisted out of the chunk loop
  // and cost the wgmma phases registers (spills at P 32, ds 128)
#pragma unroll 1
  for (int i = threadIdx.x; i < Q * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * V;
    const bool valid = r < valid_rows;
    cp_async<BYTES>(dst + r * lds + c, src + (valid ? (int64_t)r * ld : 0) + c, valid);
  }
}

// C B^T of one chunk from the raw tiles, mma.sync 3xTF32 over ds: warp
// `warp` computes the tiles (G_RT[warp], G_CT[warp][k]) into acc[k].
template <int DS>
__device__ __forceinline__ void cb_tiles(const float* cC, const float* cB, int warp, int gq, int tq,
                                         Acc (&acc)[3]) {
  constexpr int BS = DS + 4;
  const int rt = G_RT[warp];
  int ct[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) ct[k] = G_CT[warp][k];
#pragma unroll
  for (int k = 0; k < 3; ++k) acc[k].zero();
#pragma unroll 8
  for (int kb = 0; kb < DS / 8; ++kb) {
    Split<4> fa;
    const float* cr = cC + (16 * rt + gq) * BS + 8 * kb + tq;
    fa.set(0, cr[0]);
    fa.set(1, cr[8 * BS]);
    fa.set(2, cr[4]);
    fa.set(3, cr[8 * BS + 4]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      Split<2> fb;
      const float* br = cB + (8 * ct[k] + gq) * BS + 8 * kb + tq;
      fb.set(0, br[0]);
      fb.set(1, br[4]);
      acc[k].mma3(fa, fb);
    }
  }
}

// The first kernel: C B^T of every (batch, chunk), which all heads and all
// hd slices of that batch share, into g.cb [B][chunks][Q][Q]: the 20 tiles
// on or below the diagonal, zeros in the tiles above them.  One block a
// (chunk, batch); the raw tiles as the scan kernel reads them.
template <int DS>
__global__ void __launch_bounds__(THREADS, 1)
ssd_cb_kernel(Args g) {
  constexpr int BS = DS + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sB = reinterpret_cast<float*>(smem_raw);  // [Q][BS]
  float* sC = sB + Q * BS;                         // [Q][BS]
  const int ci = blockIdx.x, b = blockIdx.y, c0 = ci * Q;
  const int valid = min(Q, g.S - c0);
  const float* Bc = g.Bm + b * g.bs.b + c0 * g.bs.s;
  const float* Cc = g.Cm + b * g.cs.b + c0 * g.cs.s;
  if (g.vec) {
    copy_rows<16, DS>(sB, BS, Bc, g.bs.s, valid);
    copy_rows<16, DS>(sC, BS, Cc, g.cs.s, valid);
  } else {
    copy_rows<4, DS>(sB, BS, Bc, g.bs.s, valid);
    copy_rows<4, DS>(sC, BS, Cc, g.cs.s, valid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  Acc acc[3];
  cb_tiles<DS>(sC, sB, warp, gq, tq, acc);
  float* out = g.cb + ((int64_t)b * gridDim.x + ci) * Q * Q;
  const int rt = G_RT[warp];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int ct = G_CT[warp][k];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(16 * rt + gq + 8 * (e >> 1)) * Q + 8 * ct + 2 * tq + (e & 1)] = acc[k][e];
  }
  for (int i = threadIdx.x; i < Q * Q; i += THREADS)
    if ((i % Q) / 8 > 2 * ((i / Q) / 16) + 1) out[i] = 0.f;
}

template <int P, int DS>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(Args g) {
  using C = Cfg<P, DS>;
  constexpr int BS = C::BS, XS = C::XS, NY = C::NY, NS = C::NS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* scs = reinterpret_cast<double*>(smem_raw);  // [Q] cumulative log-decay
  float* sdt = reinterpret_cast<float*>(scs + Q);     // [2][Q] dt
  float* sw = sdt + 2 * Q;                            // [Q] exp(cs_last - cs_j)
  float* se = sw + Q;                                 // [Q] exp(cs_i)
  float* sB = se + Q;                                 // [2][Q][BS]
  float* sC = sB + 2 * Q * BS;                        // [2][Q][BS]
  float* sx = sC + 2 * Q * BS;                        // [2][Q][XS] this block's x columns
  float* sG = sx + 2 * Q * XS;                        // [Q][GS] C B^T, then L o C B^T
  // the split wgmma operands, 1024-byte aligned (the swizzle's period)
  const uint32_t xh = (smem_u32(sG + Q * GS) + 1023) & ~1023u, xl = xh + C::X_BYTES;
  const uint32_t sh = xl + C::X_BYTES, sl = sh + C::S_BYTES;
  auto at = [&](uint32_t addr) { return smem_raw + (addr - smem_u32(smem_raw)); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, wq = warp % 4;  // warpgroup, warp in it
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, thread in group
  const int p0 = blockIdx.x * P, h = blockIdx.y, b = blockIdx.z;
  const double a = g.A[h];
  const float* xb = g.x + b * g.xs.b + h * g.xs.h + p0;
  const float* dtb = g.dt + b * g.dts.b + h;
  const float* Bb = g.Bm + b * g.bs.b;
  const float* Cb = g.Cm + b * g.cs.b;
  float* yb = g.y + b * g.ys.b + h * g.ys.h + p0;
  const int64_t st_off = (((int64_t)b * g.nh + h) * g.hd + p0) * DS;  // [B,nh,hd,ds]

  auto prefetch = [&](int c0, int buf) {
    const int valid = min(Q, g.S - c0);
    if (g.vec) {
      copy_rows<16, DS>(sB + buf * Q * BS, BS, Bb + c0 * g.bs.s, g.bs.s, valid);
      copy_rows<16, DS>(sC + buf * Q * BS, BS, Cb + c0 * g.cs.s, g.cs.s, valid);
      copy_rows<16, P>(sx + buf * Q * XS, XS, xb + c0 * g.xs.s, g.xs.s, valid);
    } else {
      copy_rows<4, DS>(sB + buf * Q * BS, BS, Bb + c0 * g.bs.s, g.bs.s, valid);
      copy_rows<4, DS>(sC + buf * Q * BS, BS, Cb + c0 * g.cs.s, g.cs.s, valid);
      copy_rows<4, P>(sx + buf * Q * XS, XS, xb + c0 * g.xs.s, g.xs.s, valid);
    }
    if (threadIdx.x < Q) {
      const bool ok = (int)threadIdx.x < valid;
      cp_async<4>(sdt + buf * Q + threadIdx.x,
                  dtb + (ok ? (int64_t)(c0 + threadIdx.x) * g.dts.s : 0), ok);
    }
    cp_async_commit();
  };
  // the chunk's C B^T into sG, once its G of the chunk before is read
  const int n_chunks = (g.S + Q - 1) / Q;
  const float* cbb = g.cb + (int64_t)b * n_chunks * Q * Q;
  auto prefetch_cb = [&](int ci) {
    const float* src = cbb + (int64_t)ci * Q * Q;
#pragma unroll
    for (int u = 0; u < Q * Q / 4 / THREADS; ++u) {
      const int i = threadIdx.x + THREADS * u, r = i / (Q / 4), c = 4 * (i % (Q / 4));
      cp_async<16>(sG + r * GS + c, src + r * Q + c, true);
    }
    cp_async_commit();
  };

  // The state, transposed ([n][p]), in wgmma's accumulator layout: this
  // warpgroup's rows n0 + 16 wq + gq (+ 8) and columns q0 + 8 c + 2 tq (+ 1),
  // register i at row + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 tq + (i & 1).
  // ds <= 64: both warpgroups hold all n (rows past ds are zero), half of
  // p each; ds 128: half of n each, all p.
  const int n0 = C::SPLIT_N ? 0 : 64 * wg, q0 = C::SPLIT_N ? wg * NS : 0;
  auto st_n = [&](int i) { return n0 + 16 * wq + gq + 8 * ((i >> 1) & 1); };
  auto st_p = [&](int i) { return q0 + 8 * (i >> 2) + 2 * tq + (i & 1); };
  float st[NS / 2];
#pragma unroll
  for (int i = 0; i < NS / 2; ++i)
    st[i] = (g.s0 && st_n(i) < DS) ? g.s0[st_off + (int64_t)st_p(i) * DS + st_n(i)] : 0.f;
  // the entering state as the split wgmma operand [p][n]
  auto store_state = [&]() {
#pragma unroll
    for (int i = 0; i < NS / 2; ++i)
      if (st_n(i) < DS) store_split(at(sh), at(sl), kmaj(st_p(i), st_n(i), P), st[i]);
  };
  store_state();

  // Copy groups in flight at the top of chunk ci: its tiles (issued at the
  // top of ci - 1), its C B^T (after ci - 1's y) and the next tiles.
  prefetch(0, 0);
  prefetch_cb(0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * Q, buf = ci & 1;
    // The chunk's last row inside S: the state leaves from its cumulative
    // decay.  Rows past it add 0 to that decay, but the scan sums them in
    // another order, so reading scs[Q - 1] would put rounding on the
    // weight of the last row (exactly 1) of every ragged chunk.
    const int last = min(Q, g.S - c0) - 1;
    if (ci + 1 < n_chunks) {
      prefetch(c0 + Q, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk's tiles, C B^T and entering state are visible
    const float* cB = sB + buf * Q * BS;
    const float* cC = sC + buf * Q * BS;
    const float* cx = sx + buf * Q * XS;
    const float* cdt = sdt + buf * Q;

    // 1. warp 0: the cumulative log-decay in fp64 (two rows a lane; dt * A
    //    is exact in fp64) and the per-row weights.  The other warps
    //    meanwhile split x dt into the K-major wgmma operand [p][j].
    if (warp == 0) {
      const int r0 = 2 * lane, r1 = r0 + 1;
      const double a0 = (double)cdt[r0] * a, a1 = (double)cdt[r1] * a;
      double incl = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0;
      scs[r0] = excl + a0;
      scs[r1] = incl;
      __syncwarp();
      const double cl = scs[last];
#pragma unroll
      for (int r = r0; r <= r1; ++r) {
        sw[r] = expf((float)(cl - scs[r]));
        se[r] = expf((float)scs[r]);
      }
    } else {
      // A warp's lanes cover 4 rows j x 8 columns p: with XS = 8 or 24
      // mod 32 the reads of x and the swizzled writes hit 32 banks.  The
      // seven warps take full rounds of tiles unguarded, then the rest.
      // All reads come before the writes: the compiler cannot tell the
      // two apart in shared memory, so interleaved they would run in turn.
      constexpr int TILES = (Q / 4) * (P / 8), ROUNDS = TILES / (WARPS - 1);
      const int jl = lane & 3, pl = lane >> 2;
      auto tile_j = [&](int t) { return 4 * (t % (Q / 4)) + jl; };
      auto tile_p = [&](int t) { return 8 * (t / (Q / 4)) + pl; };
      float v[ROUNDS];
#pragma unroll
      for (int u = 0; u < ROUNDS; ++u) {
        const int t = warp - 1 + (WARPS - 1) * u;
        v[u] = cx[tile_j(t) * XS + tile_p(t)] * cdt[tile_j(t)];
      }
#pragma unroll
      for (int u = 0; u < ROUNDS; ++u) {
        const int t = warp - 1 + (WARPS - 1) * u;
        store_split(at(xh), at(xl), kmaj(tile_p(t), tile_j(t), P), v[u]);
      }
      const int t = warp - 1 + (WARPS - 1) * ROUNDS;
      if (t < TILES)
        store_split(at(xh), at(xl), kmaj(tile_p(t), tile_j(t), P),
                    cx[tile_j(t) * XS + tile_p(t)] * cdt[tile_j(t)]);
    }
    __syncthreads();

    // 2. G = L o C B^T in place: the chunk's C B^T scaled by its decay on
    //    or below the diagonal, +0 above it.  The mask is a bitwise and, so
    //    that the loop has no branch (the products above the diagonal are
    //    computed and dropped), and all reads come before the writes, so
    //    that the rows' work overlaps.
    {
      constexpr int U = Q * Q / THREADS;
      const int j = threadIdx.x % Q, i0 = threadIdx.x / Q;  // rows i0 + 4 u
      const double csj = scs[j];
      float gv[U];
      double csi[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + (THREADS / Q) * u;
        gv[u] = sG[i * GS + j];
        csi[u] = scs[i];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + (THREADS / Q) * u;
        const uint32_t keep = 0u - (uint32_t)(i >= j);
        sG[i * GS + j] = __uint_as_float(__float_as_uint(gv[u] * expf((float)(csi[u] - csj))) & keep);
      }
    }
    __syncthreads();

    // 3. y, wgmma, for all 64 rows: the chunk's own rows through G, plus
    //    the entering state through C (its rows scaled by exp(cs_i) first).
    //    KSPLIT: warpgroup wg sums over the chunk rows [32 wg, 32 wg + 32)
    //    and the state rows [DS/2 wg, DS/2 wg + DS/2) for all P columns;
    //    else over all rows for the columns [wg NY, wg NY + NY).
    {
      constexpr int KG = C::KSPLIT ? Q / 16 : Q / 8, KC = C::KSPLIT ? DS / 16 : DS / 8;
      const int kg0 = C::KSPLIT ? wg * KG : 0, kc0 = C::KSPLIT ? wg * KC : 0;
      const int col0 = C::KSPLIT ? 0 : wg * NY;
      float yb_[NY / 2], ys_[NY / 2];
      const int r = 16 * wq + gq;  // this thread's A rows r and r + 8
      wg_product<NY, KG>(
          yb_, ys_,
          [&](int kb, Split<4>& f) {
            const float* gr = sG + r * GS + 8 * (kg0 + kb) + tq;
            f.set(0, gr[0]);
            f.set(1, gr[8 * GS]);
            f.set(2, gr[4]);
            f.set(3, gr[8 * GS + 4]);
          },
          xh, xl, col0, P, false, kg0);
      const float e0 = se[r], e1 = se[r + 8];
      wg_product<NY, KC>(
          yb_, ys_,
          [&](int kb, Split<4>& f) {
            const float* cr = cC + r * BS + 8 * (kc0 + kb) + tq;
            f.set(0, cr[0] * e0);
            f.set(1, cr[8 * BS] * e1);
            f.set(2, cr[4] * e0);
            f.set(3, cr[8 * BS + 4] * e1);
          },
          sh, sl, col0, P, true, kc0);
      // warpgroup 1's half goes through the entering state's operand,
      // which every product has read by now: [64][P] floats fit in its
      // 2 P NSL 128 bytes
      float* half = reinterpret_cast<float*>(at(sh));
      if constexpr (C::KSPLIT) {
        __syncthreads();  // both warpgroups' products are done with sh
        if (wg == 1) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
#pragma unroll
            for (int c = 0; c < NY / 8; ++c)
              *reinterpret_cast<float2*>(half + (r + 8 * hr) * P + 8 * c + 2 * tq) =
                  make_float2(yb_[4 * c + 2 * hr] + ys_[4 * c + 2 * hr],
                              yb_[4 * c + 2 * hr + 1] + ys_[4 * c + 2 * hr + 1]);
        }
        __syncthreads();
      }
      if (!C::KSPLIT || wg == 0) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = r + 8 * hr;
          if (c0 + i >= g.S) continue;
          float* yr = yb + (int64_t)(c0 + i) * g.ys.s + col0;
#pragma unroll
          for (int c = 0; c < NY / 8; ++c) {
            float2 v = make_float2(yb_[4 * c + 2 * hr] + ys_[4 * c + 2 * hr],
                                   yb_[4 * c + 2 * hr + 1] + ys_[4 * c + 2 * hr + 1]);
            if constexpr (C::KSPLIT) {
              const float2 o = *reinterpret_cast<const float2*>(half + i * P + 8 * c + 2 * tq);
              v = make_float2(v.x + o.x, v.y + o.y);
            }
            *reinterpret_cast<float2*>(yr + 8 * c + 2 * tq) = v;
          }
        }
      }
    }
    __syncthreads();  // every read of G (and of the y half) is done: the next C B^T may land in sG
    if (ci + 1 < n_chunks) prefetch_cb(ci + 1);

    // 4. the state leaving the chunk, wgmma: state^T [n][p] = exp(cs_last)
    //    state^T + (B w)^T (x dt) over the chunk's rows j.
    {
      float ub[NS / 2], us[NS / 2];
      const int nr = n0 + 16 * wq + gq;  // this thread's A rows (n) nr and nr + 8
      wg_product<NS, Q / 8>(
          ub, us,
          [&](int kb, Split<4>& f) {
            const int j0 = 8 * kb + tq, j1 = j0 + 4;
            const float w0 = sw[j0], w1 = sw[j1];
            f.set(0, nr < DS ? cB[j0 * BS + nr] * w0 : 0.f);
            f.set(1, nr + 8 < DS ? cB[j0 * BS + nr + 8] * w0 : 0.f);
            f.set(2, nr < DS ? cB[j1 * BS + nr] * w1 : 0.f);
            f.set(3, nr + 8 < DS ? cB[j1 * BS + nr + 8] * w1 : 0.f);
          },
          xh, xl, q0, P, false);
      const float dec = expf((float)scs[last]);
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) st[i] = st[i] * dec + (ub[i] + us[i]);
    }
    __syncthreads();  // every read of the entering state and of this buffer is done
    store_state();
  }

#pragma unroll
  for (int i = 0; i < NS / 2; ++i)
    if (st_n(i) < DS) g.sf[st_off + (int64_t)st_p(i) * DS + st_n(i)] = st[i];
}

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

template <int P, int DS>
cudaError_t launch(const Args& g, int B, cudaStream_t stream) {
  auto cb_kern = ssd_cb_kernel<DS>;
  constexpr size_t cb_smem = sizeof(float) * 2 * Q * (DS + 4);
  static std::atomic<uint64_t> cb_smem_set{0};
  cudaError_t e = opt_in_smem(cb_kern, cb_smem, cb_smem_set);
  if (e != cudaSuccess) return e;
  cb_kern<<<dim3((g.S + Q - 1) / Q, B), THREADS, cb_smem, stream>>>(g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto kern = ssd_scan_kernel<P, DS>;
  constexpr size_t smem = Cfg<P, DS>::SMEM;
  static std::atomic<uint64_t> smem_set{0};
  e = opt_in_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid(g.hd / P, g.nh, B);
  kern<<<grid, THREADS, smem, stream>>>(g);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_ds(int ds, const Args& g, int B, cudaStream_t stream) {
  switch (ds) {
    case 16: return launch<P, 16>(g, B, stream);
    case 32: return launch<P, 32>(g, B, stream);
    case 64: return launch<P, 64>(g, B, stream);
    case 128:  // P 64 at ds 128 does not fit shared memory (slice_plan caps P)
      if constexpr (P <= 32) return launch<P, 128>(g, B, stream);
      else return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// All tensors fp32; strides in elements, the innermost stride of x, dt,
// Bm, Cm and y is 1 (y's strides even); s0 (may be null: a zero state) and
// sf are contiguous [B,nh,hd,ds]; cb is scratch of B * ceil(S / 64) * 64 * 64
// floats, 16-byte aligned.  P is the width of the hd slice a block
// owns (16, 32 or 64, dividing hd; at most 32 when ds is 128).  Returns the cudaError_t of the launches
// (0 on success); both kernels run on `stream` and nothing here
// synchronises.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, const void* s0, void* y, void* sf, void* cb, int B, int S,
                               int nh, int hd, int ds, int P, int64_t x_sb, int64_t x_ss,
                               int64_t x_sh, int64_t dt_sb, int64_t dt_ss, int64_t b_sb,
                               int64_t b_ss, int64_t c_sb, int64_t c_ss, int64_t y_sb,
                               int64_t y_ss, int64_t y_sh, void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || B > 65535 || nh > 65535) return cudaErrorInvalidValue;
  if ((hd != 16 && hd != 32 && hd != 64) || P < 16 || P > hd || hd % P != 0 ||
      (ds == 128 && P > 32))
    return cudaErrorInvalidValue;
  if (y_sb % 2 || y_ss % 2 || y_sh % 2 || reinterpret_cast<uintptr_t>(y) % 8 ||
      reinterpret_cast<uintptr_t>(cb) % 16)
    return cudaErrorInvalidValue;
  auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = al16(x) && al16(Bm) && al16(Cm) && x_sb % 4 == 0 && x_ss % 4 == 0 &&
                   x_sh % 4 == 0 && b_sb % 4 == 0 && b_ss % 4 == 0 && c_sb % 4 == 0 &&
                   c_ss % 4 == 0;
  const Args g{static_cast<const float*>(x),  static_cast<const float*>(dt),
               static_cast<const float*>(A),  static_cast<const float*>(Bm),
               static_cast<const float*>(Cm), static_cast<const float*>(s0),
               static_cast<float*>(y),        static_cast<float*>(sf),
               static_cast<float*>(cb),
               S, nh, hd,
               Strides{x_sb, x_ss, x_sh},     Strides{dt_sb, dt_ss, 1},
               Strides{b_sb, b_ss, 0},        Strides{c_sb, c_ss, 0},
               Strides{y_sb, y_ss, y_sh},     vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return launch_ds<16>(ds, g, B, st);
    case 32: return launch_ds<32>(ds, g, B, st);
    case 64: return launch_ds<64>(ds, g, B, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* ssd_scan_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
