// Flash attention for prefill on Hopper (sm_90a): causal or full, GQA-aware.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (body _attn_kernel).  Same contract: q [B,Sq,H,hd], k/v [B,Skv,KV,hd],
// query head h reads kv head h / (H/KV) without a repeated copy; causal
// query rows sit at position row + (Skv - Sq); masked scores are -1e30;
// m/l/acc are fp32 and the output is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on an H100: both roofs are close.  At the qwen2-7b
// serving shape (batch 8 x 512 tokens, 28 heads, hd 128, causal, bf16) one
// layer needs about 1.5e10 FLOP (15 us at 989 TFLOP/s) and must move 67 MB
// of q, k, v and o (20 us at 3.35 TB/s): ~224 FLOP/byte, just under the
// ~295 ridge, because GQA makes q and o 7x larger than k and v.  Longer
// prompts move it onto the tensor cores' side (FLOP grow as S^2).
//
// What this design does about it (first, simple version): it keeps every
// score and probability on chip.  One block owns one (batch, head, 64-row
// query tile); it walks 64-row K/V tiles through shared memory with an
// online softmax, skips tiles wholly above the causal diagonal (about half
// of the work at Sq == Skv), and masks the ragged edge, so any S works
// (the TPU kernel's block-halving loop is not carried over).  Both
// products run on the FP32 FMA pipes from a 4x4 (QK^T) and 4x(hd/16) (PV)
// register tile per thread; moving them to wgmma with a TMA-fed ring is
// the next step, so this kernel sits far below the tensor-core roof.
#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 64;       // key/value rows per tile
constexpr int THREADS = 256;  // a 16 x 16 thread grid over the 64 x 64 score tile
constexpr int RJ = BQ / 16;   // query rows per thread (ty + 16 i)
constexpr int CJ = BKV / 16;  // score columns per thread (tx + 16 j)
constexpr int PS = BKV + 16;  // row stride of the probability tile: two rows per warp on disjoint banks
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

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                       int G, Strides qs, Strides ks, Strides vs, Strides os,
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

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (q0 + r < Sq) x = to_float(qb[(int64_t)(q0 + r) * qs.s + d]) * scale;
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
        kx = to_float(kb[(int64_t)(k0 + c) * ks.s + d]);
        vx = to_float(vb[(int64_t)(k0 + c) * vs.s + d]);
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
    T* ob = o + b * os.b + (int64_t)row * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[tx + 16 * j] = from_float<T>(acc[i][j] / den);
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Skv, int H, int KV, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, HD>;
  constexpr size_t smem = smem_bytes<HD>();
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t e = opt_in_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H / KV, qs, ks, vs, os, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B,
                      int Sq, int Skv, int H, int KV, Strides qs, Strides ks, Strides vs,
                      Strides os, float scale, int causal, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, scale, causal, stream);
    case 112:
      return launch<T, 112>(q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, scale, causal, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns the
// cudaError_t of the launch (0 on success); the kernel runs on `stream`
// and nothing here synchronises.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int H,
    int KV, int hd, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, float scale, int causal, int dtype, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, scale, causal, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Skv, H, KV, qs, ks, vs, os, scale,
                                    causal, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
