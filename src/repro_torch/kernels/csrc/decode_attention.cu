// Split-KV flash-decode on Hopper (sm_90a): one new query token against a
// KV cache.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_pallas
// (body _decode_kernel), which computes the same function as the decode
// step's jnp attention (src/repro/models/layers.py, decode_attention).
// Contract: q [B,1,H,hd], caches [B,S,KV,hd], one int cache_len shared by
// the batch; positions >= cache_len take no part; G = H/KV <= 8; m/l/acc
// are fp32 and the output is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on an H100: bytes.  Each (batch, kv head) reads its K and
// V up to cache_len once and does 4*G FLOP per 4 bytes of bf16 K and V:
// with the GQA group G <= 8 that is at most 8 FLOP/byte, far under both
// the FP32 FMA roof and the tensor cores' (~295 FLOP/byte at the ridge).
// At the qwen2-7b serving shape (B 8, KV 4, hd 128, cache_len 528) that
// is 8.65 MB a call, 2.6 us at 3.35 TB/s.  So the products stay on the FP32
// FMA pipes, deliberately: bytes in flight are the whole game.
//
// What this design does about it:
// * Split-KV.  The host cuts [0, cache_len) into splits of split_len
//   positions (a multiple of 64; see split_plan in decode_attention.py) so
//   that splits x KV x B blocks reach two per SM where the cache allows.
//   The split kernel, grid (splits, KV, B), computes for its slice the
//   partial softmax (m, l, acc[G][hd]) of all G query heads of its kv head,
//   so a K/V row fetched from device memory serves G queries; the merge
//   kernel, grid (G, KV, B), rescales the partials by e^(m_i - m) and
//   writes acc / max(l, 1e-30).  With one split the split kernel writes o
//   itself.
// * A shard's share (decode_attention_partial_launch): a rank of a mesh
//   whose cache is sequence-sharded runs the same two kernels on its
//   shard, always through the merge, which then leaves o in fp32 and also
//   writes the log-sum-exp m + log(l) of each (batch, query head); the
//   ranks merge their shares (o, lse) with all-reduces.
// * Bytes in flight.  K and V stream through two shared-memory stages of
//   64 rows (32 for fp32 at hd 256, whose 64-row tiles do not fit twice)
//   with 16-byte cp.async copies, the next tile loading while the current
//   one is computed; rows past the split are zero-filled and masked.  A
//   split of one tile gets one stage: the smaller block lets more blocks,
//   and so more loads, share an SM (4 at qwen2-7b's shape, one wave of
//   288 blocks).  K's rows are padded by 16 bytes so that the score loop's
//   16-byte reads of 8 different rows fall on different banks.
// * Scores: thread (position, part) sums its part of hd's 16-byte chunks
//   for every query row, the parts are added through shared memory; warp g
//   runs row g's online-softmax step; thread (pair of hd columns, group of
//   positions) accumulates P V for every row in fp32 registers, so that
//   the work is spread the same at G = 1 as at G = 8, and the groups are
//   added once, at the end of the split.
#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps: warp g runs the softmax of query row g
constexpr int MAXG = 8;       // largest GQA group served
constexpr int STAGES = 2;     // K/V tiles in flight
constexpr float NEG_INF = -1e30f;

struct Strides {
  int64_t b, s, h;  // in elements; the head_dim stride is 1
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes from global to shared memory, asynchronously; `bytes` < 16
// zero-fills the rest (0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of T as floats.
__device__ __forceinline__ void unpack16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}
// two consecutive values of T as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, int HD>
struct Cfg {
  static constexpr int E = 16 / sizeof(T);                          // values per 16-byte chunk
  static constexpr int CH = HD / E;                                 // chunks per row
  static constexpr int TR = (sizeof(T) == 4 && HD == 256) ? 32 : 64;  // rows per tile
  static constexpr int PARTS = THREADS / TR;                        // score threads per column
  static constexpr int KROW = HD + E;                               // padded K row, in T
  static constexpr int PAIRS = HD / 2;                              // P V: column pairs
  static constexpr int CG = THREADS / PAIRS;                        // P V: position groups
  static constexpr int CPG = TR / CG;                               // positions per group
  static constexpr size_t SQ = sizeof(float) * MAXG * HD;
  static constexpr size_t SK = sizeof(T) * TR * KROW, SV = sizeof(T) * TR * HD;
  static constexpr size_t SP = sizeof(float) * PARTS * MAXG * TR;
  // shared memory: q | partial scores | `stages` K/V stages, sized at
  // launch: a split of one tile needs one stage, and the smaller block
  // lets more blocks (and their loads) share an SM
  static size_t smem(int stages) { return SQ + SP + stages * (SK + SV); }
  static_assert(HD % E == 0 && (HD * sizeof(T)) % 16 == 0, "16-byte chunks");
  static_assert(THREADS % TR == 0 && TR % 32 == 0, "score threads per column");
  static_assert(CPG % 4 == 0, "P is read 4 positions at a time");
  static_assert(sizeof(float) * CG * MAXG * HD <= SK + SV, "the group sums fit a stage");
};

// At most 80 registers a thread, so that 3 blocks share an SM: a one-tile
// split's block is small enough in shared memory for 4.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 3)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                    T* __restrict__ o, float* __restrict__ part, int cache_len, int split_len,
                    int stages, int G, Strides qs, Strides ks, Strides vs, Strides os,
                    float scale) {
  using C = Cfg<T, HD>;
  constexpr int E = C::E, CH = C::CH, TR = C::TR, PARTS = C::PARTS, KROW = C::KROW;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sq = reinterpret_cast<float*>(smem);                    // [MAXG][HD], pre-scaled
  float* sp = reinterpret_cast<float*>(smem + C::SQ);            // [PARTS][MAXG][TR]
  T* sk = reinterpret_cast<T*>(smem + C::SQ + C::SP);            // [stages][TR][KROW]
  T* sv = reinterpret_cast<T*>(smem + C::SQ + C::SP + stages * C::SK);  // [stages][TR][HD]
  __shared__ float sm[MAXG], sl[MAXG], scorr[MAXG];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int start = split * split_len, end = min(start + split_len, cache_len);
  const int ntiles = (end - start + TR - 1) / TR;
  const T* kb = kc + b * ks.b + kvh * ks.h;
  const T* vb = vc + b * vs.b + kvh * vs.h;

  auto load_tile = [&](int t) {
    T* kd = sk + (t % stages) * TR * KROW;
    T* vd = sv + (t % stages) * TR * HD;
    for (int i = tid; i < TR * CH; i += THREADS) {
      const int r = i / CH, j = i % CH;
      const int pos = start + t * TR + r;
      const int row = pos < end ? pos : start;  // a valid address; nothing is read
      const int bytes = pos < end ? 16 : 0;
      cp_async16(kd + r * KROW + j * E, kb + (int64_t)row * ks.s + j * E, bytes);
      cp_async16(vd + r * HD + j * E, vb + (int64_t)row * vs.s + j * E, bytes);
    }
  };
  load_tile(0);
  cp_async_commit();
  if (stages > 1) {
    if (ntiles > 1) load_tile(1);
    cp_async_commit();
  }

  const T* qb = q + b * qs.b + (int64_t)kvh * G * qs.h;  // query head kvh * G + g
  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    sq[g * HD + d] = to_float(qb[g * qs.h + d]) * scale;
  }
  if (tid < MAXG) {
    sm[tid] = NEG_INF;
    sl[tid] = 0.f;
  }
  // P V: this thread's column pair, every query row, and the tile's
  // positions [cg CPG, (cg + 1) CPG): the work is the same at any G
  const int pair = tid % C::PAIRS, cg = tid / C::PAIRS;
  float acc[MAXG][2];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (stages > 1) cp_async_wait<STAGES - 1>();
    else cp_async_wait<0>();
    __syncthreads();  // tile t has landed for every thread (and sq, sm, sl are written)
    const T* kt = sk + (t % stages) * TR * KROW;
    const T* vt = sv + (t % stages) * TR * HD;
    const int k0 = start + t * TR;

    {  // partial scores: column c, chunks p, p + PARTS, ...
      const int c = tid % TR, p = tid / TR;
      float s[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
      for (int j = p; j < CH; j += PARTS) {
        float kx[E];
        unpack16(kt + c * KROW + j * E, kx);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
          const float* qg = sq + g * HD + j * E;
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qg + e);
            s[g] = fmaf(qv.x, kx[e], s[g]);
            s[g] = fmaf(qv.y, kx[e + 1], s[g]);
            s[g] = fmaf(qv.z, kx[e + 2], s[g]);
            s[g] = fmaf(qv.w, kx[e + 3], s[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) sp[(p * MAXG + g) * TR + c] = s[g];
    }
    __syncthreads();
    for (int i = tid; i < G * TR; i += THREADS) {
      const int g = i / TR, c = i % TR;
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) s += sp[(p * MAXG + g) * TR + c];
      // positions past the split (or cache_len) take no part: -inf gives
      // them probability 0 exactly
      sp[g * TR + c] = k0 + c < end ? s : -INFINITY;
    }
    __syncthreads();

    if (warp < G) {  // online-softmax step of row `warp`, TR / 32 columns a lane
      float* row = sp + warp * TR;
      float x[TR / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < TR / 32; ++i) mx = fmaxf(mx, x[i] = row[lane + 32 * i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm[warp];
      const float m_new = fmaxf(m_old, mx);
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < TR / 32; ++i) {
        const float p = expf(x[i] - m_new);
        row[lane + 32 * i] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        scorr[warp] = corr;
        sl[warp] = sl[warp] * corr + rs;
        sm[warp] = m_new;
      }
    }
    __syncthreads();

    if (cg < C::CG) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        acc[g][0] *= scorr[g];
        acc[g][1] *= scorr[g];
      }
#pragma unroll 2
      for (int c = cg * C::CPG; c < (cg + 1) * C::CPG; c += 4) {
        float2 vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) vv[i] = load2(vt + (c + i) * HD + 2 * pair);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
          const float4 p = *reinterpret_cast<const float4*>(sp + g * TR + c);
          acc[g][0] = fmaf(p.x, vv[0].x, fmaf(p.y, vv[1].x, fmaf(p.z, vv[2].x,
                      fmaf(p.w, vv[3].x, acc[g][0]))));
          acc[g][1] = fmaf(p.x, vv[0].y, fmaf(p.y, vv[1].y, fmaf(p.z, vv[2].y,
                      fmaf(p.w, vv[3].y, acc[g][1]))));
        }
      }
    }
    __syncthreads();  // stage t % stages and sp are consumed
    if (t + stages < ntiles) load_tile(t + stages);
    cp_async_commit();
  }

  // Add the position groups' sums through the (now free) stage memory.
  float* red = reinterpret_cast<float*>(sk);  // [CG][MAXG][HD]
  if (cg < C::CG) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      red[(cg * MAXG + g) * HD + 2 * pair] = acc[g][0];
      red[(cg * MAXG + g) * HD + 2 * pair + 1] = acc[g][1];
    }
  }
  __syncthreads();
  // partials: acc [B][KV][splits][G][HD], then m and l [B][KV][splits][G]
  const int64_t first = (((int64_t)b * gridDim.y + kvh) * n_splits + split) * G;
  const int64_t total = (int64_t)gridDim.z * gridDim.y * n_splits * G;
  for (int e = tid; e < G * HD; e += THREADS) {
    const int g = e / HD, d = e % HD;
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < C::CG; ++i) a += red[(i * MAXG + g) * HD + d];
    if (part == nullptr)
      o[b * os.b + ((int64_t)kvh * G + g) * os.h + d] = from_float<T>(a / fmaxf(sl[g], 1e-30f));
    else
      part[(first + g) * HD + d] = a;
  }
  if (part != nullptr && tid < G) {
    part[total * HD + first + tid] = sm[tid];
    part[total * HD + total + first + tid] = sl[tid];
  }
}

// acc = sum_i e^(m_i - m) acc_i, l = sum_i e^(m_i - m) l_i with m the
// largest m_i; out = acc / max(l, 1e-30), and with `lse` also m + log(l)
// at [B][H].  Grid (G, KV, B), one thread per column of hd: many small
// blocks, so that the partials' reads spread over the SMs.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part, T* __restrict__ o,
                                    float* __restrict__ lse, int n_splits, Strides os) {
  const int g = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int G = gridDim.x, HD = blockDim.x;
  const int64_t total = (int64_t)gridDim.z * gridDim.y * n_splits * G;
  const int64_t first = ((int64_t)b * gridDim.y + kvh) * n_splits * G + g;  // split 0
  const float* ms = part + total * HD;
  const float* ls = ms + total;
  // unrolled, so that several loads are in flight at once
  float m = NEG_INF;
#pragma unroll 8
  for (int i = 0; i < n_splits; ++i) m = fmaxf(m, ms[first + i * G]);
  float l = 0.f, a = 0.f;
#pragma unroll 8
  for (int i = 0; i < n_splits; ++i) {
    const int64_t idx = first + i * G;
    const float w = expf(ms[idx] - m);
    l = fmaf(w, ls[idx], l);
    a = fmaf(w, part[idx * HD + d], a);
  }
  o[b * os.b + ((int64_t)kvh * G + g) * os.h + d] = from_float<T>(a / fmaxf(l, 1e-30f));
  if (lse != nullptr && d == 0) lse[((int64_t)b * gridDim.y + kvh) * G + g] = m + logf(l);
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

// With `lse` the merge always runs and writes o as fp32 (a shard's share);
// without it o is T, written by the split kernel alone when there is one
// split.
template <typename T, int HD>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* o, float* part,
                   float* lse, int B, int KV, int G, int cache_len, int split_len, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  auto kern = decode_split_kernel<T, HD>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t e = opt_in_smem(kern, C::smem(STAGES), smem_set);
  if (e != cudaSuccess) return e;
  const int n_splits = (cache_len + split_len - 1) / split_len;
  const int stages = min(STAGES, (split_len + C::TR - 1) / C::TR);
  const bool merged = lse != nullptr || n_splits > 1;
  kern<<<dim3(n_splits, KV, B), THREADS, C::smem(stages), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<T*>(o), merged ? part : nullptr, cache_len, split_len, stages, G, qs, ks, vs,
      os, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || !merged) return e;
  if (lse != nullptr)
    decode_merge_kernel<float><<<dim3(G, KV, B), HD, 0, stream>>>(
        part, static_cast<float*>(o), lse, n_splits, os);
  else
    decode_merge_kernel<T><<<dim3(G, KV, B), HD, 0, stream>>>(part, static_cast<T*>(o), nullptr,
                                                              n_splits, os);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* kc, const void* vc, void* o,
                      float* part, float* lse, int B, int KV, int G, int cache_len,
                      int split_len, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                      cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, kc, vc, o, part, lse, B, KV, G, cache_len, split_len, qs,
                           ks, vs, os, scale, stream);
    case 112:
      return launch<T, 112>(q, kc, vc, o, part, lse, B, KV, G, cache_len, split_len, qs,
                            ks, vs, os, scale, stream);
    case 128:
      return launch<T, 128>(q, kc, vc, o, part, lse, B, KV, G, cache_len, split_len, qs,
                            ks, vs, os, scale, stream);
    case 256:
      return launch<T, 256>(q, kc, vc, o, part, lse, B, KV, G, cache_len, split_len, qs,
                            ks, vs, os, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Enqueues the split kernel and, with more than one split, the merge
// kernel on `stream`.  dtype: 0 = float32, 1 = bfloat16.  Strides are in
// elements (q's and o's s stride is unused: one token); the caches' bases
// must be 16-byte aligned and their strides multiples of 16 bytes.
// `part` is fp32 scratch of B*KV*splits*G*(hd+2) values, splits =
// ceil(cache_len / split_len), unused with one split.  Returns the first
// cudaError_t (0 on success); nothing here synchronises.
extern "C" int decode_attention_launch(
    const void* q, const void* kc, const void* vc, void* o, void* part, int B, int H, int KV,
    int hd, int cache_len, int split_len, int64_t q_sb, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
    int64_t o_sh, float scale, int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > MAXG || cache_len <= 0 || split_len <= 0 ||
      split_len % 64 != 0)
    return cudaErrorInvalidValue;
  if (split_len < cache_len && part == nullptr) return cudaErrorInvalidValue;
  const Strides qs{q_sb, 0, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, 0, o_sh};
  const int G = H / KV;
  float* pf = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, kc, vc, o, pf, nullptr, B, KV, G, cache_len, split_len, qs, ks,
                            vs, os, scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, kc, vc, o, pf, nullptr, B, KV, G, cache_len, split_len,
                                    qs, ks, vs, os, scale, st);
  return cudaErrorInvalidValue;
}

// One cache shard's share of a decode step: as decode_attention_launch
// over the shard's first valid_len positions (1..S_local; an empty shard
// is decided on the host and launches nothing), but the merge always runs:
// o [B,1,H,hd] is fp32 (strides in elements), normalised over the shard,
// and lse [B,H] (contiguous, fp32) gets m + log(l) per (batch, query
// head).  `part` is fp32 scratch of B*KV*splits*G*(hd+2) values, needed
// with one split too.
extern "C" int decode_attention_partial_launch(
    const void* q, const void* kc, const void* vc, void* o, void* lse, void* part, int B, int H,
    int KV, int hd, int valid_len, int split_len, int64_t q_sb, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
    int64_t o_sh, float scale, int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > MAXG || valid_len <= 0 || split_len <= 0 ||
      split_len % 64 != 0 || part == nullptr || lse == nullptr || o == nullptr)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, 0, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, 0, o_sh};
  const int G = H / KV;
  float* pf = static_cast<float*>(part);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, kc, vc, o, pf, lf, B, KV, G, valid_len, split_len, qs, ks, vs,
                            os, scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, kc, vc, o, pf, lf, B, KV, G, valid_len, split_len, qs,
                                    ks, vs, os, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
