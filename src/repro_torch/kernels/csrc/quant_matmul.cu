// Int8 GEMM with the dequantisation fused into its epilogue, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quant_matmul.py, quant_matmul_pallas (body
// _qmm_kernel), reached through ops.quant_matmul and ops.quant_linear.
// Contract: x_q [M,K] int8 times w_q [K,N] int8, accumulated exactly in
// int32; then out[m,n] = (float(acc) * x_scale[m]) * w_scale[n], each
// product rounded to fp32 in that order, written as fp32 or bf16 (round to
// nearest even).  That is the plain version's order, so the two agree bit
// for bit.  |acc| <= 128^2 K, so int32 cannot overflow up to K = 131,071
// (the wrapper refuses a larger K).
//
// What bounds it on an H100: operations at a large M, bytes at a small one.
// At qwen2-7b-int8's MLP up-projection (K 3584 -> N 18944) the prefill of
// the serve batch (M 3792) is 515 G int8 operations, 0.26 ms at the card's
// 1,979 TOP/s; one decode step (M 8) must still read the 68 MB of w_q,
// 0.020 ms at 3.35 TB/s.
//
// What this design does about it: the products run on the int8 tensor
// cores (mma.sync m16n8k32 s8.s8.s32), one 128x128 output tile per block of
// 8 warps, each warp 64x32, over 64-deep K tiles staged in shared memory.
// The next K tile's loads from device memory are issued before the current
// tile's products, so they overlap.  The MMA wants B with K contiguous
// (.col) while w_q is [K,N] row-major, and ldmatrix's .trans does not move
// 8-bit data: each thread reads a 4x4 byte block (4 k rows of 4 n) and
// transposes it with byte permutes on its way into shared memory.  Blocks
// walk M fastest, so the blocks in flight share a few w_q tiles and the
// activations stay in L2.  Ragged edges are masked: rows and columns past
// M and N are zero-filled and not stored, and K is zero-filled up to the
// tile, so any M, N, K works.  What it leaves on the table: wgmma, TMA and
// a deeper pipeline (a later version); at decode only N/128 blocks run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;  // block tile
constexpr int THREADS = 256;                // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;             // warp tile
constexpr int MT = WM / 16, NT = WN / 8;    // mma tiles per warp: 4 x 4
// Shared-memory row stride in bytes: 16-byte aligned rows for the A
// stores, and the fragment reads (8 rows x 4 words) hit 32 different banks.
constexpr int LDS = BK + 16;
constexpr int A_CHUNKS = BM * BK / 16 / THREADS;  // 16-byte chunks of A a thread
constexpr int B_BLOCKS = BK * BN / 16 / THREADS;  // 4x4-byte blocks of B a thread
static_assert(A_CHUNKS * 16 * THREADS == BM * BK, "A tile split evenly");
static_assert(B_BLOCKS * 16 * THREADS == BK * BN, "B tile split evenly");
static_assert(BK == 64 && BN == 128, "the B block mapping assumes 16 k quads x 32 n quads");

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* xs;
  const float* ws;
  void* out;
  int M, N, K;
  int64_t ldx, ldw, ldo;  // row strides in elements; the inner stride is 1
  bool vec_x, vec_w;      // 16-byte rows of x, 4-byte words of w may be loaded whole
};

__device__ __forceinline__ uint32_t byte_at(const int8_t* p) {
  return static_cast<uint32_t>(static_cast<uint8_t>(*p));
}

// A: 16 bytes of one row, k .. k+15, zero past K or M.
__device__ __forceinline__ uint4 load_a_chunk(const Params& p, int m, int k) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (m >= p.M) return v;
  const int8_t* src = p.x + (int64_t)m * p.ldx + k;
  if (p.vec_x && k + 16 <= p.K) return *reinterpret_cast<const uint4*>(src);
  uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (k + j < p.K) wd[j / 4] |= byte_at(src + j) << (8 * (j % 4));
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// B: 4 bytes of one k row, n .. n+3, zero past N or K.
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

// The B block a thread owns for its i-th share: a k quad (0..15) and an n
// quad (0..31) of the tile.  Four neighbouring lanes take four k quads of
// one n quad, so each k row a warp reads is 32 contiguous bytes.
__device__ __forceinline__ void b_block(int i, int& kq, int& nq) {
  const int q = threadIdx.x + i * THREADS, lane = q % 32, wq = q / 32;
  kq = (lane % 4) + 4 * (wq % 4);
  nq = lane / 4 + 8 * (wq / 4);
}

__device__ __forceinline__ void load_tiles(const Params& p, int m0, int n0, int k0,
                                           uint4 (&ra)[A_CHUNKS],
                                           uint32_t (&rb)[B_BLOCKS][4]) {
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    ra[i] = load_a_chunk(p, m0 + c / (BK / 16), k0 + (c % (BK / 16)) * 16);
  }
#pragma unroll
  for (int i = 0; i < B_BLOCKS; ++i) {
    int kq, nq;
    b_block(i, kq, nq);
#pragma unroll
    for (int r = 0; r < 4; ++r) rb[i][r] = load_b_word(p, k0 + kq * 4 + r, n0 + nq * 4);
  }
}

__device__ __forceinline__ void store_tiles(uint8_t* sa, uint8_t* sb, const uint4 (&ra)[A_CHUNKS],
                                            const uint32_t (&rb)[B_BLOCKS][4]) {
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    *reinterpret_cast<uint4*>(sa + (c / (BK / 16)) * LDS + (c % (BK / 16)) * 16) = ra[i];
  }
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

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) quant_matmul_kernel(Params p) {
  __shared__ __align__(16) uint8_t sa[BM * LDS];  // [m][k]
  __shared__ __align__(16) uint8_t sb[BN * LDS];  // [n][k], transposed on the way in

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
  load_tiles(p, m0, n0, 0, ra, rb);
  for (int kt = 0; kt < n_k; ++kt) {
    store_tiles(sa, sb, ra, rb);
    __syncthreads();
    if (kt + 1 < n_k) load_tiles(p, m0, n0, (kt + 1) * BK, ra, rb);  // in flight meanwhile
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
          const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][h * 2 + e]), xs), p.ws[n]);
          out[(int64_t)m * p.ldo + n] = from_float<T>(v);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);  // M fastest
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  quant_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16.  Row strides are in elements, the
// inner strides are 1, the scales are contiguous.  Returns the cudaError_t
// of the launch (0 on success); nothing here synchronises.
extern "C" int quant_matmul_launch(const void* x, const void* w, const void* xs, const void* ws,
                                   void* out, int M, int N, int K, int64_t ldx, int64_t ldw,
                                   int64_t ldo, int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  Params p;
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
  p.vec_x = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (ldx % 16 == 0);
  p.vec_w = (reinterpret_cast<uintptr_t>(w) % 4 == 0) && (ldw % 4 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return launch<float>(p, st);
  if (out_dtype == 1) return launch<__nv_bfloat16>(p, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* quant_matmul_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
