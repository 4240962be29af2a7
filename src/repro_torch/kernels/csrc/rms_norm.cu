// RMSNorm on Hopper (sm_90a), plain or SiLU-gated: bf16 or fp32 rows in,
// fp32 arithmetic in registers, the output rounded once.
//
// Replaces no TPU kernel: the JAX package normalises in jnp
// (src/repro/models/layers.py, rms_norm; src/repro/models/ssm.py, the gated
// norm before the out-projection), and so did the port, as a chain of ten
// PyTorch ops a call (the upcast, square, mean, + eps, rsqrt, the broadcast
// product, weight.to, 1 + w, the second product, the downcast; thirteen with
// the gate's SiLU and product), each a launch and, but for the mean, a
// full pass over the rows in fp32.
// Contract (ops.rms_norm, ref.rms_norm_ref): x [rows, d] (bf16 or fp32, rows
// 16-byte aligned), w [d], optionally a gate z [rows, d] and a group width g
// dividing d (g = d without a gate); in fp32, per group of g channels,
//   v = x  or  v = x * silu(z),   r = rsqrt(mean(v^2) + eps),
//   out = (v * r) * (1 + w),
// rounded once to the output's type (x's, or z's where gated).
//
// What bounds it on an H100: bytes.  The rows are read once and written
// once (x, z, out; w is [d] and stays in L2): 2 * 2 B * d a row in bf16,
// 0.46 MB at qwen2-7b's decode batch (32 x 3584), 0.54 GB for a prefill of
// 32,768 rows of 4,096 (160 us at 3.35 TB/s).  The work is ~6 FLOP an
// element.  At a decode batch the bound is a fraction of a microsecond and
// the launch itself (~2-3 us) is what is left to pay: one launch in place of
// ten to thirteen.
//
// What this design does about it:
// * One pass.  A thread loads its chunks of 8 elements (one 16-byte load of
//   bf16, two of fp32; z likewise), forms v in registers, adds its squares,
//   and after the group's reduction scales and stores the same registers:
//   no fp32 temporary reaches device memory.
// * The group decides the shape, nothing else.  A group of at most 32
//   chunks whose count is a power of two (g 8..256: Mamba2's per-head gated
//   norm at g 64 is 8 lanes) is reduced inside a warp with xor shuffles,
//   several groups a warp, 256 threads a block.  A wider group takes a block,
//   reduced by warp shuffles and one pass through shared memory.  Where the
//   groups fill the card (a prefill: 32,768 rows) the block has up to 256
//   threads, each holding N in {1, 2, 4, 8} chunks (N the least that fits,
//   so g up to 16,384): several blocks an SM and a thread's loads in
//   flight together.  Where they do not (a decode batch: 32 rows on 132
//   SMs) each block takes up to 1,024 threads of one chunk (g up to
//   8,192): a group's serial work (the gate's exp and division per element)
//   spread over four times the threads.  Consecutive threads load
//   consecutive 16 bytes.
// * Every load before the reduction.  The weight's chunks are loaded with
//   the row's, so the only wait after the reduction is the store; at a
//   decode batch (32 rows, 32 blocks) the call is a chain of latencies, and
//   this takes one memory round trip out of it.  256 threads a block leave
//   a thread room for 2 x 8 x N floats in registers.
// * The plain chain's roundings.  Each square, product and sum is rounded on
//   its own (__fmul_rn / __fadd_rn: no FMA contraction), the mean is the sum
//   times 1/g as PyTorch's CUDA mean computes it, and rsqrtf is PyTorch's
//   CUDA rsqrt; the kernel and the chain differ in the order the squares are
//   summed only, and from the chain on the CPU also in rsqrt's and silu's
//   last bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kChunk = 8;           // elements a thread loads at once
constexpr int kMaxThreads = 256;    // threads of a group's block where groups fill the card
constexpr int kWideThreads = 1024;  // threads of a group's block where they do not
constexpr int kWarpBlock = 256;     // threads of a block of warp-sized groups
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load_chunk(const void* base, int64_t at, bool bf16,
                                           float* v) {
  if (bf16) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + at);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < kChunk / 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(base) + at);
    const float4 a = p[0], b = p[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

__device__ __forceinline__ void store_chunk(void* base, int64_t at, bool bf16,
                                            const float* v) {
  if (bf16) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < kChunk / 2; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + at) = u;
  } else {
    float4* p = reinterpret_cast<float4*>(static_cast<float*>(base) + at);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// x / (1 + exp(-x)), as PyTorch's silu computes it
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
}

// One group of g channels per `lanes` threads: lanes <= 32 (a power of two,
// g / 8 of them) puts 256 / lanes groups in a block; otherwise the block is
// the group.  Thread `lane` of a group holds chunks lane, lane + lanes, ...
template <int N>
__global__ void __launch_bounds__(N == 1 ? kWideThreads : kMaxThreads)
rms_norm_kernel(const void* __restrict__ x, int64_t x_row, bool x_bf16,
                const void* __restrict__ z, int64_t z_row, bool z_bf16,
                const void* __restrict__ w, bool w_bf16, void* __restrict__ out,
                bool out_bf16, int64_t groups, int per_row, int g, int lanes, float inv_g,
                float eps) {
  const int lane = threadIdx.x % lanes;
  const int64_t grp = static_cast<int64_t>(blockIdx.x) * (blockDim.x / lanes) + threadIdx.x / lanes;
  const int64_t row = grp / per_row;
  const int col0 = static_cast<int>(grp % per_row) * g;
  const bool live_grp = grp < groups;

  float v[N][kChunk], wc[N][kChunk];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = (lane + i * lanes) * kChunk;
    if (live_grp && c < g) {
      load_chunk(x, row * x_row + col0 + c, x_bf16, v[i]);
      load_chunk(w, col0 + c, w_bf16, wc[i]);
      if (z != nullptr) {
        float zc[kChunk];
        load_chunk(z, row * z_row + col0 + c, z_bf16, zc);
#pragma unroll
        for (int k = 0; k < kChunk; ++k) v[i][k] = __fmul_rn(v[i][k], silu(zc[k]));
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) sum = __fadd_rn(sum, __fmul_rn(v[i][k], v[i][k]));
    }
  }
  if (lanes <= 32) {
    // a group's lanes are an aligned run of the warp: xor stays inside it
    for (int off = lanes / 2; off > 0; off /= 2) sum += __shfl_xor_sync(kFull, sum, off);
  } else {
    __shared__ float part[kWideThreads / 32];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(kFull, sum, off);
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = sum;
    __syncthreads();
    sum = 0.f;
    for (int k = 0; k < static_cast<int>(blockDim.x / 32); ++k) sum += part[k];
  }
  const float r = rsqrtf(__fadd_rn(__fmul_rn(sum, inv_g), eps));
  const int64_t out_at = row * static_cast<int64_t>(per_row) * g + col0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = (lane + i * lanes) * kChunk;
    if (live_grp && c < g) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        v[i][k] = __fmul_rn(__fmul_rn(v[i][k], r), __fadd_rn(1.f, wc[i][k]));
      store_chunk(out, out_at + c, out_bf16, v[i]);
    }
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  z may be null (no gate; g must be d).
// Strides are in elements; out is [rows, d], contiguous; sms: the card's SMs.
extern "C" int rms_norm_launch(const void* x, int64_t x_row, int x_dtype, const void* z,
                               int64_t z_row, int z_dtype, const void* w, int w_dtype,
                               void* out, int out_dtype, int rows, int d, int g, int sms,
                               float eps, void* stream) {
  if (rows <= 0 || d <= 0 || g <= 0 || d % g != 0 || g % kChunk != 0 ||
      (z == nullptr && g != d))
    return cudaErrorInvalidValue;
  for (int code : {x_dtype, z_dtype, w_dtype, out_dtype})
    if (code != 0 && code != 1) return cudaErrorInvalidValue;
  auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  auto row16 = [](int64_t stride, int code) { return (stride * (code ? 2 : 4)) % 16 == 0; };
  if (!al16(x) || !al16(w) || !al16(out) || !row16(x_row, x_dtype) ||
      (z != nullptr && (!al16(z) || !row16(z_row, z_dtype))))
    return cudaErrorInvalidValue;
  const int chunks = g / kChunk;
  const int per_row = d / g;
  const int64_t groups = static_cast<int64_t>(rows) * per_row;
  int n = 1, lanes, threads;
  int64_t blocks;
  if (chunks <= 32 && (chunks & (chunks - 1)) == 0) {
    lanes = chunks;
    threads = kWarpBlock;
    const int per_block = kWarpBlock / lanes;
    blocks = (groups + per_block - 1) / per_block;
  } else if (groups < 2 * static_cast<int64_t>(sms) && chunks <= kWideThreads) {
    threads = lanes = (chunks + 31) / 32 * 32;
    blocks = groups;
  } else {
    while ((chunks + n - 1) / n > kMaxThreads) {
      n *= 2;
      if (n > 8) return cudaErrorInvalidValue;
    }
    threads = lanes = ((chunks + n - 1) / n + 31) / 32 * 32;
    blocks = groups;
  }
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float inv_g = 1.0f / static_cast<float>(g);
#define RMS_NORM_LAUNCH(N)                                                                 \
  rms_norm_kernel<N><<<static_cast<unsigned>(blocks), threads, 0, st>>>(                   \
      x, x_row, x_dtype == 1, z, z_row, z_dtype == 1, w, w_dtype == 1, out, out_dtype == 1, \
      groups, per_row, g, lanes, inv_g, eps)
  switch (n) {
    case 1: RMS_NORM_LAUNCH(1); break;
    case 2: RMS_NORM_LAUNCH(2); break;
    case 4: RMS_NORM_LAUNCH(4); break;
    default: RMS_NORM_LAUNCH(8); break;
  }
#undef RMS_NORM_LAUNCH
  return cudaGetLastError();
}

extern "C" const char* rms_norm_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
