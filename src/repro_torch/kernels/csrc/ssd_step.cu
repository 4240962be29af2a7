// Mamba2 SSD decode step on Hopper (sm_90a): the fp32 recurrent state read
// once and written once, in place or into a second buffer, and y read from
// the new state, all fp32.
//
// Replaces no TPU kernel: the JAX package steps its decode state in jnp
// (src/repro/models/ssm.py, ssd_step), and so did the port, as five passes
// of PyTorch ops over the state (the rank-1 update, state * exp(dt A), the
// add, the product with C and, in graphed decode, a copy into the static
// buffer), about nine state-sized reads and writes a layer and step.
// Contract (ops.ssd_step, ref.ssd_step_ref): x [B,nh,hd], dt [B,nh]
// (softplus'd), A [nh] (< 0), Bm/Cm [B,ds], D [nh], state [B,nh,hd,ds];
// per (b, h) with dA = exp(dt A), for each state element
//   s'[p,n] = s[p,n] dA + (dt x[p]) B[n],   y[p] = sum_n s'[p,n] C[n] + D x[p].
//
// What bounds it on an H100: bytes.  The state is read and written once:
// 2 * 4 B * hd * ds per (b, h), 268 MB a layer at Granite-4.0-H's batch 32
// (nh 128, hd 64, ds 128), 80 us at 3.35 TB/s; x, dt, B, C and y add 1 %.
// The work is 5 FLOP an element, far below the card's rate.
//
// What this design does about it:
// * One pass.  Each thread loads its elements of the state, updates them,
//   stores them and adds their products with C into y, so no state-sized
//   temporary exists and the state crosses the memory bus twice.  In place
//   is safe: every element is read and written by the same thread, the
//   read before the write.
// * 16-byte accesses.  A state row (ds floats) is one warp at ds 128 (32
//   lanes x float4) or half a warp at ds 64; a pass of the block's 8 warps
//   covers 8 or 16 consecutive rows, 4 KB of contiguous bytes.  y of a row
//   is summed across its lanes with warp shuffles.
// * Loads in flight.  A block owns 64 consecutive rows (hd 64: one (b,
//   h)), so each thread issues all its 8 (ds 128) or 4 (ds 64) row loads
//   before its first store: 128 or 64 bytes a thread in flight, with 8
//   blocks of 256 threads resident on an SM.  B * nh * hd / 64 blocks:
//   4,096 at Granite's batch 32 for 132 SMs.
// * Streaming hints.  134 MB a layer never fits the 50 MB L2, so the state
//   is loaded and stored with the evict-first hint (ld/st.global.cs) and
//   leaves room in L2 for what is reused (B, C, x, the scalars).
// * The plain step's roundings.  The state's update is s dA and (dt x) B
//   each rounded, then their sum rounded (no FMA contraction), as the
//   plain step's separate ops compute it, so the two states agree but for
//   exp's last bit; y differs from the plain product with C by its order
//   of summation only.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;

template <int DS>
__global__ void __launch_bounds__(kThreads)
ssd_step_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ D,
                const float* s_in, float* s_out, float* __restrict__ y, int rows, int nh,
                int hd) {
  constexpr int kLanes = DS / 4;               // lanes a state row takes
  constexpr int kRowsPerWarp = 32 / kLanes;    // rows a warp covers a pass
  constexpr int kRowsPerPass = kWarps * kRowsPerWarp;
  constexpr int kPasses = kRowsPerBlock / kRowsPerPass;
  static_assert(DS % 4 == 0 && 32 % kLanes == 0 && kRowsPerBlock % kRowsPerPass == 0,
                "a row must fill whole lanes of a warp");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = (lane % kLanes) * 4;
  const int first = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp + lane / kLanes;

  // every load of the thread's rows before any store
  float4 s[kPasses];
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int r = first + i * kRowsPerPass;
    if (r < rows)
      s[i] = __ldcs(reinterpret_cast<const float4*>(s_in + static_cast<int64_t>(r) * DS + col));
  }
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int r = first + i * kRowsPerPass;
    const bool live = r < rows;
    float part = 0.f, xd = 0.f;
    if (live) {
      const int bh = r / hd, h = bh % nh, b = bh / nh;
      const float dtv = dt[bh];
      const float dA = expf(__fmul_rn(dtv, A[h]));
      const float xr = x[r];
      const float xdt = __fmul_rn(xr, dtv);
      const float4 bv = __ldg(reinterpret_cast<const float4*>(Bm + b * DS + col));
      const float4 cv = __ldg(reinterpret_cast<const float4*>(Cm + b * DS + col));
      float4 n;
      n.x = __fadd_rn(__fmul_rn(s[i].x, dA), __fmul_rn(xdt, bv.x));
      n.y = __fadd_rn(__fmul_rn(s[i].y, dA), __fmul_rn(xdt, bv.y));
      n.z = __fadd_rn(__fmul_rn(s[i].z, dA), __fmul_rn(xdt, bv.z));
      n.w = __fadd_rn(__fmul_rn(s[i].w, dA), __fmul_rn(xdt, bv.w));
      __stcs(reinterpret_cast<float4*>(s_out + static_cast<int64_t>(r) * DS + col), n);
      part = fmaf(n.w, cv.w, fmaf(n.z, cv.z, fmaf(n.y, cv.y, n.x * cv.x)));
      xd = __fmul_rn(xr, D[h]);
    }
    // the row's lanes are aligned groups of kLanes: xor stays inside one
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (live && lane % kLanes == 0) y[r] = __fadd_rn(part, xd);
  }
}

}  // namespace

extern "C" int ssd_step_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, const void* D, const void* s_in, void* s_out,
                               void* y, int B, int nh, int hd, int ds, void* stream) {
  if (B <= 0 || nh <= 0 || hd <= 0) return cudaErrorInvalidValue;
  const int64_t rows = static_cast<int64_t>(B) * nh * hd;
  if (rows > INT_MAX - kRowsPerBlock) return cudaErrorInvalidValue;
  auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (!al16(Bm) || !al16(Cm) || !al16(s_in) || !al16(s_out)) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fx = static_cast<const float*>(x), *fdt = static_cast<const float*>(dt),
              *fA = static_cast<const float*>(A), *fB = static_cast<const float*>(Bm),
              *fC = static_cast<const float*>(Cm), *fD = static_cast<const float*>(D),
              *fs = static_cast<const float*>(s_in);
  float *fo = static_cast<float*>(s_out), *fy = static_cast<float*>(y);
  switch (ds) {
    case 64:
      ssd_step_kernel<64><<<blocks, kThreads, 0, st>>>(fx, fdt, fA, fB, fC, fD, fs, fo, fy,
                                                       static_cast<int>(rows), nh, hd);
      break;
    case 128:
      ssd_step_kernel<128><<<blocks, kThreads, 0, st>>>(fx, fdt, fA, fB, fC, fD, fs, fo, fy,
                                                        static_cast<int>(rows), nh, hd);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* ssd_step_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
