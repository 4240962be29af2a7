// Flash-decode on Hopper (sm_90a): one new query token against a KV cache.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_pallas
// (body _decode_kernel), which computes the same function as the decode
// step's jnp attention (src/repro/models/layers.py, decode_attention).
// Contract: q [B,1,H,hd], caches [B,S,KV,hd], one int cache_len shared by
// the batch; positions >= cache_len take no part; m/l/acc are fp32 and the
// output is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on an H100: bytes.  Each (batch, kv head) reads its K and
// V up to cache_len once and does 4*G FLOP per 4 bytes of bf16 K and V:
// with the GQA group G <= 8 that is at most 8 FLOP/byte, far under the
// card's ~295 FLOP/byte ridge.  At the qwen2-7b serving shape (B 8, KV 4,
// hd 128, cache_len 528) that is 8.65 MB a call, 2.6 us at 3.35 TB/s.
//
// What this design does about it: the cache is read once.  One block owns
// one (batch, kv head) and all G query heads of its group are the rows of
// each tile, so a K/V tile fetched from device memory serves G queries.
// Tiles of 64 positions stream through shared memory up to cache_len and
// no further, with an online softmax in fp32; the ragged last tile is
// masked, so any cache_len works.  The known limit: only B*KV blocks run
// (32 at the serving shape, against 132 SMs), so most of the card's
// memory bandwidth is idle.  Split-KV (partial softmax per cache slice,
// then a merge) is the fix, in a later version.
#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BKV = 64;       // cache positions per tile
constexpr int THREADS = 256;  // 8 warps: warp g runs the softmax of query row g
constexpr int MAXG = 8;       // largest GQA group served
constexpr float NEG_INF = -1e30f;
static_assert(BKV == 64, "the softmax step gives each lane two positions of a tile");

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

template <int HD>
constexpr size_t smem_bytes() {
  // the k tile uses a padded row stride HD + 1: 32 threads reading 32
  // different rows at the same d hit 32 different banks.
  return sizeof(float) * (size_t)(MAXG * HD + BKV * (HD + 1) + BKV * HD + MAXG * BKV);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, T* __restrict__ o, int cache_len, int G,
                        Strides qs, Strides ks, Strides vs, Strides os, float scale) {
  constexpr int KS = HD + 1;
  // accumulators per thread, rounded up: at hd 112 a group of 8 has 896
  // (row, d) outputs, 3.5 per thread; the loops below stop at G * HD.
  constexpr int R = (MAXG * HD + THREADS - 1) / THREADS;
  static_assert(R * THREADS >= MAXG * HD, "every (row, d) output needs a thread");
  extern __shared__ float smem[];
  float* sq = smem;              // [G][HD], pre-scaled
  float* sk = sq + MAXG * HD;    // [BKV][KS]
  float* sv = sk + BKV * KS;     // [BKV][HD]
  float* sp = sv + BKV * HD;     // [G][BKV] scores, then probabilities
  __shared__ float sm[MAXG], sl[MAXG], scorr[MAXG];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const T* qb = q + b * qs.b + (int64_t)kvh * G * qs.h;  // query head kvh * G + g
  const T* kb = kc + b * ks.b + kvh * ks.h;
  const T* vb = vc + b * vs.b + kvh * vs.h;

  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    sq[i] = to_float(qb[g * qs.h + d]) * scale;
  }
  if (tid < MAXG) {
    sm[tid] = NEG_INF;
    sl[tid] = 0.f;
  }
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < cache_len; k0 += BKV) {
    __syncthreads();  // the previous tile is consumed (and sq, sm, sl are written)
    for (int i = tid; i < BKV * HD; i += THREADS) {
      const int c = i / HD, d = i % HD;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < cache_len) {
        kx = to_float(kb[(int64_t)(k0 + c) * ks.s + d]);
        vx = to_float(vb[(int64_t)(k0 + c) * vs.s + d]);
      }
      sk[c * KS + d] = kx;
      sv[c * HD + d] = vx;
    }
    __syncthreads();

    for (int i = tid; i < G * BKV; i += THREADS) {
      const int g = i / BKV, c = i % BKV;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(sq[g * HD + d], sk[c * KS + d], s);
      // positions past cache_len take no part: -inf gives them probability 0
      sp[i] = (k0 + c < cache_len) ? s : -INFINITY;
    }
    __syncthreads();

    if (warp < G) {
      float* row = sp + warp * BKV;
      const float x0 = row[lane], x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm[warp];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      float rs = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        scorr[warp] = corr;
        sl[warp] = sl[warp] * corr + rs;
        sm[warp] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = tid + THREADS * r;
      if (e >= G * HD) break;
      const int g = e / HD, d = e % HD;
      const float* p = sp + g * BKV;
      float a = acc[r] * scorr[g];
#pragma unroll 8
      for (int c = 0; c < BKV; ++c) a = fmaf(p[c], sv[c * HD + d], a);
      acc[r] = a;
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = tid + THREADS * r;
    if (e >= G * HD) break;
    const int g = e / HD, d = e % HD;
    o[b * os.b + ((int64_t)kvh * G + g) * os.h + d] = from_float<T>(acc[r] / fmaxf(sl[g], 1e-30f));
  }
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

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* o, int B, int KV,
                   int G, int cache_len, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, HD>;
  constexpr size_t smem = smem_bytes<HD>();
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t e = opt_in_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid(KV, B);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(kc),
                                        static_cast<const T*>(vc), static_cast<T*>(o),
                                        cache_len, G, qs, ks, vs, os, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* kc, const void* vc, void* o, int B,
                      int KV, int G, int cache_len, Strides qs, Strides ks, Strides vs,
                      Strides os, float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, kc, vc, o, B, KV, G, cache_len, qs, ks, vs, os, scale, stream);
    case 112:
      return launch<T, 112>(q, kc, vc, o, B, KV, G, cache_len, qs, ks, vs, os, scale, stream);
    case 128:
      return launch<T, 128>(q, kc, vc, o, B, KV, G, cache_len, qs, ks, vs, os, scale, stream);
    case 256:
      return launch<T, 256>(q, kc, vc, o, B, KV, G, cache_len, qs, ks, vs, os, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements (q's and o's
// s stride is unused: one token).  Returns the cudaError_t of the launch
// (0 on success); nothing here synchronises.
extern "C" int decode_attention_launch(
    const void* q, const void* kc, const void* vc, void* o, int B, int H, int KV, int hd,
    int cache_len, int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_sh, float scale,
    int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > MAXG || cache_len <= 0) return cudaErrorInvalidValue;
  const Strides qs{q_sb, 0, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, 0, o_sh};
  const int G = H / KV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, kc, vc, o, B, KV, G, cache_len, qs, ks, vs, os, scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, kc, vc, o, B, KV, G, cache_len, qs, ks, vs, os,
                                    scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
