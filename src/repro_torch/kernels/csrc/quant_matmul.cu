// Int8 GEMM with the dequantisation fused into its epilogue, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quant_matmul.py, quant_matmul_pallas (body
// _qmm_kernel), reached through ops.quant_matmul and ops.quant_linear.
// Contract: x_q [M,K] int8 times w_q [K,N] int8, accumulated exactly in
// int32; then out[m,n] = (float(acc) * x_scale[m]) * w_scale[n], each
// product rounded to fp32 in that order, written as fp32 or bf16 (round to
// nearest even).  That is the plain version's order, so the two agree bit
// for bit.  |acc| <= 128^2 K, so int32 cannot overflow up to K = 131,071
// (the wrapper refuses a larger K); a partial sum over part of K is bounded
// the same way.
//
// What bounds it on an H100: operations at a large M, bytes at a small one.
// At qwen2-7b-int8's MLP up-projection (K 3584 -> N 18944) the prefill of
// the serve batch (M 3792) is 515 G int8 operations, 0.26 ms at the card's
// 1,979 TOP/s; one decode step (M 8) must still read the 68 MB of w_q,
// 0.020 ms at 3.35 TB/s.
//
// Layouts.  wgmma takes 8-bit operands from shared memory only K-major (the
// transpose bits exist for 16-bit types only) and TMA moves bytes without
// transposing them.  So the kernel's native layout of w_q is K-major: a
// [K,N] tensor whose K stride is 1 (w.t().contiguous().t(), cuBLASLt's
// int8 layout), which is an [N,K] matrix with contiguous rows.  The wrapper
// picks one of three bodies from the layout and the alignment of what it
// is given (never on a failure):
//
// * "wgmma" (K-major w_q, 16-byte-aligned bases and row strides, M > 64):
//   a persistent grid of one block per SM walks 128 x 256 output tiles in
//   a grouped order (GROUP_M tile rows share the w_q tiles in flight, so
//   those come from L2).  One producer warpgroup (setmaxnreg down to 40)
//   has one thread issue TMA loads with the 128-byte swizzle, 128-byte K
//   boxes, into a ring of 4 stages of 48 KB (x 128 x 128, w 256 x 128); two
//   consumer warpgroups (setmaxnreg up to 232) run wgmma m64n256k32 s8 from
//   both operands in shared memory, 64 rows each, keeping one wgmma group in
//   flight and releasing a stage as soon as the group that read it is done.
//   The ring runs on across tiles, so the next tile's loads overlap this
//   tile's epilogue.  TMA zero-fills rows past M and N and columns past K,
//   so ragged edges add zeros; the epilogue masks the stores.
// * "wgmma_small" (the same layout and alignment, M <= 64: decode): the
//   operands swap, out^T = w_q^T x_q^T.  The K-major w_q is the A operand
//   (64 rows of N a tile) and the row-major x_q the B operand, MP = M
//   rounded up to 8/16/32/64 wide (wgmma m64nMPk32), so no zero rows are
//   multiplied.  There are only N/64 tiles, too few to keep HBM busy, so
//   the (tile, K step) iterations are cut into equal contiguous ranges, one
//   per block, as many blocks as fit on the card ("stream-K"): every block
//   streams the same number of w_q bytes through a TMA ring of 3 to 5
//   stages fed by one producer warp, a stage four 128-byte boxes side by
//   side (512 contiguous bytes of each w_q row).  Where a range ends or
//   crosses a tile, the block adds its int32 partial sums into a zeroed
//   [M,N] int32 scratch with atomics (integer sums are exact in any
//   order), and a second small kernel applies the epilogue.  The launch
//   counts as one.
// * "mma_sync" (a row-major w_q, or a K-major one whose base or row stride
//   is not a multiple of 16 bytes): mma.sync m16n8k32 s8.s8.s32 on
//   128 x 128 tiles over 64-deep K tiles staged in shared
//   memory through registers, the next tile's loads in flight during this
//   one's products.  A row-major w_q is transposed into K-contiguous rows
//   on its way into shared memory: each thread reads a 4 x 4 byte block
//   and transposes it with byte permutes (ldmatrix's .trans does not move
//   8-bit data); a K-major one is copied as it is.
#include <atomic>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The epilogue, in the plain version's rounding order.
__device__ __forceinline__ float dequant(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
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

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return n;
}

// ===========================================================================
// "mma_sync": mma.sync m16n8k32 from register-staged shared-memory tiles.
namespace mma {

constexpr int BM = 128, BN = 128, BK = 64;  // block tile
constexpr int THREADS = 256;                // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;             // warp tile
constexpr int MT = WM / 16, NT = WN / 8;    // mma tiles per warp: 4 x 4
// Shared-memory row stride in bytes: 16-byte aligned rows for the chunk
// stores, and the fragment reads (8 rows x 4 words) hit 32 different banks.
constexpr int LDS = BK + 16;
constexpr int A_CHUNKS = BM * BK / 16 / THREADS;  // 16-byte chunks of A a thread
constexpr int B_BLOCKS = BK * BN / 16 / THREADS;  // 16-byte pieces of B a thread
static_assert(A_CHUNKS * 16 * THREADS == BM * BK, "A tile split evenly");
static_assert(B_BLOCKS * 16 * THREADS == BK * BN, "B tile split evenly");
static_assert(A_CHUNKS == B_BLOCKS && BM == BN, "a K-major B tile loads as A does");
static_assert(BK == 64 && BN == 128, "the B block mapping assumes 16 k quads x 32 n quads");

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* xs;
  const float* ws;
  void* out;
  int M, N, K;
  int64_t ldx, ldw, ldo;  // strides in elements: x and out by row; w by k row
                          // (row-major) or by n column (K-major); the other is 1
  bool vec_x, vec_w;      // 16-byte chunks of x (and of a K-major w), or 4-byte
                          // words of a row-major w, may be loaded whole
};

__device__ __forceinline__ uint32_t byte_at(const int8_t* p) {
  return static_cast<uint32_t>(static_cast<uint8_t>(*p));
}

// 16 bytes of one row r of a row-major [rows, K] matrix, k .. k+15, zero past K or rows.
__device__ __forceinline__ uint4 load_chunk(const int8_t* base, int64_t ld, int rows, int K,
                                            bool vec, int r, int k) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (r >= rows) return v;
  const int8_t* src = base + (int64_t)r * ld + k;
  if (vec && k + 16 <= K) return *reinterpret_cast<const uint4*>(src);
  uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (k + j < K) wd[j / 4] |= byte_at(src + j) << (8 * (j % 4));
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// Row-major B: 4 bytes of one k row, n .. n+3, zero past N or K.
__device__ __forceinline__ uint32_t load_b_word(const Params& p, int k, int n) {
  if (k >= p.K) return 0u;
  const int8_t* src = p.w + (int64_t)k * p.ldw + n;
  if (p.vec_w && n + 4 <= p.N) return *reinterpret_cast<const uint32_t*>(src);
  uint32_t wd = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n + j < p.N) wd |= byte_at(src + j) << (8 * j);
  return wd;
}

// The row-major B block a thread owns for its i-th share: a k quad (0..15)
// and an n quad (0..31) of the tile.  Four neighbouring lanes take four k
// quads of one n quad, so each k row a warp reads is 32 contiguous bytes.
__device__ __forceinline__ void b_block(int i, int& kq, int& nq) {
  const int q = threadIdx.x + i * THREADS, lane = q % 32, wq = q / 32;
  kq = (lane % 4) + 4 * (wq % 4);
  nq = lane / 4 + 8 * (wq / 4);
}

// KM: w is K-major, so its tile loads as 16-byte chunks of n rows, as A's.
template <bool KM>
__device__ __forceinline__ void load_tiles(const Params& p, int m0, int n0, int k0,
                                           uint4 (&ra)[A_CHUNKS],
                                           uint32_t (&rb)[B_BLOCKS][4]) {
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / (BK / 16), k = k0 + (c % (BK / 16)) * 16;
    ra[i] = load_chunk(p.x, p.ldx, p.M, p.K, p.vec_x, m0 + r, k);
    if constexpr (KM) {
      const uint4 v = load_chunk(p.w, p.ldw, p.N, p.K, p.vec_w, n0 + r, k);
      rb[i][0] = v.x, rb[i][1] = v.y, rb[i][2] = v.z, rb[i][3] = v.w;
    }
  }
  if constexpr (!KM) {
#pragma unroll
    for (int i = 0; i < B_BLOCKS; ++i) {
      int kq, nq;
      b_block(i, kq, nq);
#pragma unroll
      for (int r = 0; r < 4; ++r) rb[i][r] = load_b_word(p, k0 + kq * 4 + r, n0 + nq * 4);
    }
  }
}

template <bool KM>
__device__ __forceinline__ void store_tiles(uint8_t* sa, uint8_t* sb, const uint4 (&ra)[A_CHUNKS],
                                            const uint32_t (&rb)[B_BLOCKS][4]) {
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int off = (c / (BK / 16)) * LDS + (c % (BK / 16)) * 16;
    *reinterpret_cast<uint4*>(sa + off) = ra[i];
    if constexpr (KM)
      *reinterpret_cast<uint4*>(sb + off) = make_uint4(rb[i][0], rb[i][1], rb[i][2], rb[i][3]);
  }
  if constexpr (!KM) {
#pragma unroll
    for (int i = 0; i < B_BLOCKS; ++i) {
      int kq, nq;
      b_block(i, kq, nq);
      // rows r0..r3 (k) of bytes j (n) -> words j of bytes r: a 4x4 byte transpose
      const uint32_t r0 = rb[i][0], r1 = rb[i][1], r2 = rb[i][2], r3 = rb[i][3];
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
      const uint32_t t1 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
      const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
      const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                               __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(sb + (nq * 4 + j) * LDS + kq * 4) = col[j];
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T, bool KM>
__global__ void __launch_bounds__(THREADS, 2) quant_matmul_mma_kernel(Params p) {
  __shared__ __align__(16) uint8_t sa[BM * LDS];  // [m][k]
  __shared__ __align__(16) uint8_t sb[BN * LDS];  // [n][k]

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 4) * WM, wn = (warp % 4) * WN;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group, thread in group

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  uint4 ra[A_CHUNKS];
  uint32_t rb[B_BLOCKS][4];
  const int n_k = (p.K + BK - 1) / BK;
  load_tiles<KM>(p, m0, n0, 0, ra, rb);
  for (int kt = 0; kt < n_k; ++kt) {
    store_tiles<KM>(sa, sb, ra, rb);
    __syncthreads();
    if (kt + 1 < n_k) load_tiles<KM>(p, m0, n0, (kt + 1) * BK, ra, rb);  // in flight meanwhile
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint8_t* row = sa + (wm + i * 16 + g) * LDS + ks + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(row);
        af[i][1] = *reinterpret_cast<const uint32_t*>(row + 8 * LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(row + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(row + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint8_t* col = sb + (wn + j * 8 + g) * LDS + ks + t * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(col);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(col + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // epilogue: c0, c1 at row g, columns 2t, 2t+1; c2, c3 at row g + 8
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + h * 8;
      if (m >= p.M) continue;
      const float xs = p.xs[m];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + t * 2 + e;
          if (n >= p.N) continue;
          out[(int64_t)m * p.ldo + n] = from_float<T>(dequant(acc[i][j][h * 2 + e], xs, p.ws[n]));
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, bool kmajor, cudaStream_t stream) {
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);  // M fastest
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  if (kmajor) quant_matmul_mma_kernel<T, true><<<grid, THREADS, 0, stream>>>(p);
  else quant_matmul_mma_kernel<T, false><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace mma

// ===========================================================================
// TMA, mbarrier and wgmma helpers (as in flash_attention.cu).
namespace hop {

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

// One 2-D box (128 bytes of K, `rows` rows) into shared memory; the
// barrier's transaction count falls by the box's bytes when it lands.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, groups of 8 rows 1024 bytes apart (the
// stride offset); the leading offset is unused.  Every tile starts
// 1024-byte aligned, so base_offset is 0; a k32 step advances 32 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Tie the accumulators to the surrounding asm so that the compiler neither
// reads one before wgmma.wait_group nor moves a write past the wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma m64nNk32, s32 += s8 x s8, A and B from shared memory, both K-major.
// scale_d 0 starts the accumulators from zero.
__device__ __forceinline__ void wgmma_s8_n8(int (&d)[4], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n16(int (&d)[8], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 8) wgmma_s8_n8(d, a, b, scale_d);
  else if constexpr (N == 16) wgmma_s8_n16(d, a, b, scale_d);
  else if constexpr (N == 32) wgmma_s8_n32(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_s8_n64(d, a, b, scale_d);
  else wgmma_s8_n256(d, a, b, scale_d);
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

// A map over a row-major int8 [rows, K] matrix with row stride `ld` bytes;
// boxes of 128 bytes of K by `box_rows` rows, 128-byte swizzle.  Boxes past
// the edges are zero-filled.
int encode(CUtensorMap* map, const void* base, int K, int rows, int64_t ld, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

}  // namespace hop

struct Epi {
  const float* xs;
  const float* ws;
  void* out;
  int M, N;
  int64_t ldo;
  bool pairs;  // two neighbouring outputs of a row may be stored as one
};

// out[m, n], out[m, n + 1] from two accumulators (n + 1 may lie past N).
template <typename T>
__device__ __forceinline__ void store_pair(const Epi& e, int m, int n, float xs, int a0, int a1) {
  T* o = static_cast<T*>(e.out) + (int64_t)m * e.ldo + n;
  const float v0 = dequant(a0, xs, e.ws[n]);
  if (n + 1 < e.N) {
    const float v1 = dequant(a1, xs, e.ws[n + 1]);
    if (e.pairs) {
      if constexpr (sizeof(T) == 4) *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      else *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      return;
    }
    o[1] = from_float<T>(v1);
  }
  o[0] = from_float<T>(v0);
}

// ===========================================================================
// "wgmma": persistent, warp-specialised, TMA ring, m64n256k32 (M > 64).
namespace big {

constexpr int BM = 128, BN = 256, BK = 128;  // output tile, K box (bytes)
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;               // two warpgroups of 64 rows each
constexpr int THREADS = CONSUMERS + 128;     // and one producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 <= 65,536
constexpr int GROUP_M = 16;                  // tile rows that share the w_q tiles in flight
constexpr uint32_t A_BYTES = BM * BK, STAGE_BYTES = A_BYTES + BN * BK;  // 16 + 32 KB
constexpr size_t SMEM = STAGES * STAGE_BYTES + 16 * STAGES + 1024;

// The grouped order: GROUP_M tile rows at a time, M fastest inside a group.
__device__ __forceinline__ void tile_at(int tile, int tiles_m, int tiles_n, int& m0, int& n0) {
  const int per_group = GROUP_M * tiles_n, group = tile / per_group;
  const int first = group * GROUP_M, rows = min(tiles_m - first, GROUP_M);
  const int in = tile - group * per_group;
  m0 = (first + in % rows) * BM;
  n0 = (in / rows) * BN;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
quant_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tw, Epi e, int K) {
  using namespace hop;
  extern __shared__ uint8_t smem_raw[];
  // shared memory: STAGES x (x tile | w tile) | full | empty barriers, the
  // tiles 1024-byte aligned (the 128-byte swizzle repeats every 8 rows)
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full_bar = ring + STAGES * STAGE_BYTES, empty_bar = full_bar + 8 * STAGES;
  const int tiles_m = (e.M + BM - 1) / BM, tiles_n = (e.N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n, nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
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
      uint32_t it = 0;  // the ring's position, running on across tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_at(tile, tiles_m, tiles_n, m0, n0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const uint32_t s = it % STAGES, stage = ring + s * STAGE_BYTES;
          if (it >= STAGES) mbar_wait(empty_bar + 8 * s, ((it / STAGES) - 1) & 1);
          mbar_expect_tx(full_bar + 8 * s, STAGE_BYTES);
          tma_load(stage, &tx, full_bar + 8 * s, kt * BK, m0);
          tma_load(stage + A_BYTES, &tw, full_bar + 8 * s, kt * BK, n0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // In wgmma's accumulator layout a thread holds rows r0 = 16 warp + lane/4
  // and r0 + 8 of its warpgroup's 64, and of each row the columns
  // 8 j + 2 (lane % 4) + {0, 1}: register i sits at row r0 + 8 ((i >> 1) & 1),
  // column 8 (i >> 2) + 2 (lane & 3) + (i & 1).
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  int acc[BN / 2];
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    tile_at(tile, tiles_m, tiles_n, m0, n0);
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const uint32_t s = it % STAGES, stage = ring + s * STAGE_BYTES;
      mbar_wait(full_bar + 8 * s, (it / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8<BN>(acc, desc(stage + wg * 64 * 128 + kk * 32), desc(stage + A_BYTES + kk * 32),
                     kt | kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's group is done: release it
      if (kt > 0) mbar_arrive(empty_bar + 8 * ((it - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty_bar + 8 * ((it - 1) % STAGES));

    const int r0 = m0 + wg * 64 + 16 * warp + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      if (m >= e.M) continue;
      const float xs = e.xs[m];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane & 3);
        if (n < e.N) store_pair<T>(e, m, n, xs, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const Epi& e, int K, int64_t ldx, int64_t ldw,
           cudaStream_t stream) {
  CUtensorMap tx, tw;
  int err = hop::encode(&tx, x, K, e.M, ldx, BM);
  if (err == 0) err = hop::encode(&tw, w, K, e.N, ldw, BN);
  if (err != 0) return err;
  auto kern = quant_matmul_wgmma_kernel<T>;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t ce = opt_in_smem(kern, SMEM, smem_set);
  if (ce != cudaSuccess) return ce;
  const int64_t tiles = (int64_t)((e.M + BM - 1) / BM) * ((e.N + BN - 1) / BN);
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  kern<<<(unsigned)(tiles < sms ? tiles : sms), THREADS, SMEM, stream>>>(tx, tw, e, K);
  return cudaGetLastError();
}

}  // namespace big

// ===========================================================================
// "wgmma_small": out^T = w^T x^T, stream-K over (N tile, K step), M <= 64.
// A stage holds KBOX boxes of 128 K bytes side by side; a k32 step reads
// 32 bytes of one box.
namespace small {

constexpr int BNW = 64;        // N rows of a tile: wgmma's M
constexpr int BOX = 128;       // K bytes of one TMA box (the swizzle span)
constexpr int KBOX = 4;        // boxes side by side along K in a stage
constexpr int BK = BOX * KBOX; // K bytes a stage: 512 contiguous bytes of each w row
constexpr int CONSUMERS = 128;           // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr uint32_t A_BOX = BNW * BOX, A_BYTES = KBOX * A_BOX;  // 32 KB of w a stage

template <int MP>
struct Cfg {
  static constexpr uint32_t B_BOX = MP * BOX;                   // MP rows of x
  static constexpr uint32_t STAGE_BYTES = A_BYTES + KBOX * B_BOX;
  static constexpr int STAGES = 196 * 1024 / STAGE_BYTES;       // 3 to 5
  static constexpr size_t SMEM = STAGES * STAGE_BYTES + 16 * STAGES + 1024;
};

template <int MP>
__global__ void __launch_bounds__(THREADS)
quant_matmul_small_kernel(const __grid_constant__ CUtensorMap tw,
                          const __grid_constant__ CUtensorMap tx, int* __restrict__ acc_out,
                          int M, int N, int K) {
  using namespace hop;
  using C = Cfg<MP>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full_bar = ring + STAGES * C::STAGE_BYTES, empty_bar = full_bar + 8 * STAGES;
  const int nk = (K + BK - 1) / BK;
  const int64_t total = (int64_t)((N + BNW - 1) / BNW) * nk;
  // this block's equal share of the (tile, K step) iterations
  const int64_t begin = total * blockIdx.x / gridDim.x;
  const int64_t end = total * (blockIdx.x + 1) / gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp
    if (threadIdx.x == CONSUMERS) {
      for (int64_t i = begin; i < end; ++i) {
        const uint32_t c = (uint32_t)(i - begin), s = c % STAGES;
        const uint32_t stage = ring + s * C::STAGE_BYTES;
        if (c >= STAGES) mbar_wait(empty_bar + 8 * s, ((c / STAGES) - 1) & 1);
        mbar_expect_tx(full_bar + 8 * s, C::STAGE_BYTES);
        const int tile = (int)(i / nk), kt = (int)(i % nk);
#pragma unroll
        for (int kb = 0; kb < KBOX; ++kb) {
          tma_load(stage + kb * A_BOX, &tw, full_bar + 8 * s, kt * BK + kb * BOX, tile * BNW);
          tma_load(stage + A_BYTES + kb * C::B_BOX, &tx, full_bar + 8 * s, kt * BK + kb * BOX, 0);
        }
      }
    }
    return;
  }

  // Accumulator rows are N (r0 = 16 warp + lane/4, r0 + 8), columns M.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int acc[MP / 2];
  uint32_t c = 0;
  for (int64_t i = begin; i < end;) {
    const int tile = (int)(i / nk);
    const int64_t tile_end = (int64_t)(tile + 1) * nk, seg_end = tile_end < end ? tile_end : end;
    for (int64_t i0 = i; i < seg_end; ++i, ++c) {
      const uint32_t s = c % STAGES, stage = ring + s * C::STAGE_BYTES;
      mbar_wait(full_bar + 8 * s, (c / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8<MP>(acc, desc(stage + (kk / 4) * A_BOX + (kk % 4) * 32),
                     desc(stage + A_BYTES + (kk / 4) * C::B_BOX + (kk % 4) * 32), (i != i0) | kk);
      wgmma_commit();
      wgmma_wait<1>();
      if (i != i0) mbar_arrive(empty_bar + 8 * ((c - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty_bar + 8 * ((c - 1) % STAGES));
    // add this range's partial sums of the tile (exact: integers)
    const int n_base = tile * BNW + 16 * warp + lane / 4;
#pragma unroll
    for (int r = 0; r < MP / 2; ++r) {
      const int n = n_base + 8 * ((r >> 1) & 1);
      const int m = 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      if (n < N && m < M) atomicAdd(acc_out + (int64_t)m * N + n, acc[r]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256) dequant_kernel(const int* __restrict__ acc, Epi e) {
  const int64_t total = (int64_t)e.M * e.N;
  for (int64_t i = blockIdx.x * 256ll + threadIdx.x; i < total; i += (int64_t)gridDim.x * 256) {
    const int m = (int)(i / e.N), n = (int)(i % e.N);
    static_cast<T*>(e.out)[(int64_t)m * e.ldo + n] = from_float<T>(dequant(acc[i], e.xs[m], e.ws[n]));
  }
}

template <int MP>
int launch_mp(const void* x, const void* w, int* scratch, int M, int N, int K, int64_t ldx,
              int64_t ldw, cudaStream_t stream) {
  using C = Cfg<MP>;
  CUtensorMap tw, tx;
  int err = hop::encode(&tw, w, K, N, ldw, BNW);
  if (err == 0) err = hop::encode(&tx, x, K, M, ldx, MP);
  if (err != 0) return err;
  auto kern = quant_matmul_small_kernel<MP>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t ce = opt_in_smem(kern, C::SMEM, smem_set);
  if (ce != cudaSuccess) return ce;
  // as many blocks as fit on the card at once, each an equal share
  static std::atomic<int> per_sm{0};
  int occ = per_sm.load(std::memory_order_relaxed);
  if (occ == 0) {
    ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, THREADS, C::SMEM);
    if (ce != cudaSuccess) return ce;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    per_sm.store(occ, std::memory_order_relaxed);
  }
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int64_t total = (int64_t)((N + BNW - 1) / BNW) * ((K + BK - 1) / BK);
  const int64_t blocks = (int64_t)sms * occ < total ? (int64_t)sms * occ : total;
  ce = cudaMemsetAsync(scratch, 0, sizeof(int) * (size_t)M * N, stream);
  if (ce != cudaSuccess) return ce;
  kern<<<(unsigned)blocks, THREADS, C::SMEM, stream>>>(tw, tx, scratch, M, N, K);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, int* scratch, const Epi& e, int K, int64_t ldx,
           int64_t ldw, cudaStream_t stream) {
  int err;
  if (e.M <= 8) err = launch_mp<8>(x, w, scratch, e.M, e.N, K, ldx, ldw, stream);
  else if (e.M <= 16) err = launch_mp<16>(x, w, scratch, e.M, e.N, K, ldx, ldw, stream);
  else if (e.M <= 32) err = launch_mp<32>(x, w, scratch, e.M, e.N, K, ldx, ldw, stream);
  else if (e.M <= 64) err = launch_mp<64>(x, w, scratch, e.M, e.N, K, ldx, ldw, stream);
  else return cudaErrorInvalidValue;
  if (err != 0) return err;
  const int64_t blocks = ((int64_t)e.M * e.N + 255) / 256;
  dequant_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(scratch, e);
  return cudaGetLastError();
}

}  // namespace small

constexpr int PATH_MMA = 0, PATH_WGMMA = 1, PATH_WGMMA_SMALL = 2;

template <typename T>
int launch(const mma::Params& p, bool kmajor, int path, int* scratch, cudaStream_t st) {
  if (path == PATH_MMA) return mma::launch<T>(p, kmajor, st);
  // the TMA paths: a K-major w, 16-byte-aligned bases and row strides
  const bool tma_ok = kmajor && reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(p.w) % 16 == 0 && p.ldx % 16 == 0 &&
                      p.ldw % 16 == 0;
  if (!tma_ok) return cudaErrorInvalidValue;
  const Epi e{p.xs, p.ws, p.out, p.M, p.N, p.ldo,
              p.ldo % 2 == 0 && reinterpret_cast<uintptr_t>(p.out) % (2 * sizeof(T)) == 0};
  if (path == PATH_WGMMA) return big::launch<T>(p.x, p.w, e, p.K, p.ldx, p.ldw, st);
  if (path == PATH_WGMMA_SMALL && scratch != nullptr)
    return small::launch<T>(p.x, p.w, scratch, e, p.K, p.ldx, p.ldw, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// w_kmajor: 1 if w_q [K,N] has K stride 1 (ldw is then its N stride), 0 if
// its N stride is 1 (ldw is its K stride).  path: 0 "mma_sync", 1 "wgmma",
// 2 "wgmma_small" (the wrapper's plan; the TMA paths need a K-major w_q and
// 16-byte-aligned bases and row strides, and "wgmma_small" M <= 64 and an
// int32 scratch of M*N, which it zeroes).  out_dtype: 0 = float32,
// 1 = bfloat16.  Strides are in elements, the scales contiguous.  Returns 0
// on success, the cudaError_t of a failed launch, or one of the tensor-map
// errors above; nothing here synchronises.
extern "C" int quant_matmul_launch(const void* x, const void* w, const void* xs, const void* ws,
                                   void* out, void* scratch, int M, int N, int K, int64_t ldx,
                                   int64_t ldw, int64_t ldo, int w_kmajor, int path,
                                   int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  mma::Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.xs = static_cast<const float*>(xs);
  p.ws = static_cast<const float*>(ws);
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.ldx = ldx;
  p.ldw = ldw;
  p.ldo = ldo;
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  p.vec_x = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (ldx % 16 == 0);
  p.vec_w = w_kmajor ? (wa % 16 == 0 && ldw % 16 == 0) : (wa % 4 == 0 && ldw % 4 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* acc = static_cast<int*>(scratch);
  if (out_dtype == 0) return launch<float>(p, w_kmajor != 0, path, acc, st);
  if (out_dtype == 1) return launch<__nv_bfloat16>(p, w_kmajor != 0, path, acc, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* quant_matmul_error_string(int e) {
  static thread_local char msg[96];
  if (e == hop::ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not available (libcuda older than CUDA 12)";
  if (e >= hop::ERR_ENCODE) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)", e - hop::ERR_ENCODE);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
