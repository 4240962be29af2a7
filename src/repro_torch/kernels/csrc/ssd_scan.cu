// Mamba2 SSD scan (chunked dual form) on Hopper (sm_90a), fp32.
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_scan_pallas (body
// _ssd_kernel).  Same contract: x [B,S,nh,hd], dt [B,S,nh] (softplus'd),
// A [nh] (< 0), Bm/Cm [B,S,ds], an optional init_state [B,nh,hd,ds]; it
// returns y [B,S,nh,hd] and the final state [B,nh,hd,ds], all fp32.  Per
// chunk of Q rows, with cs the cumulative sum of dt*A inside the chunk:
//   y     = (L o C B^T)(x dt) + exp(cs) (C state^T),  L[i,j] = exp(cs_i - cs_j), i >= j
//   state = state exp(cs_last) + sum_j exp(cs_last - cs_j) dt_j x_j (x) B_j
//
// What bounds it on an H100: operations.  The least work for the function
// is the exact recurrence's ~5 hd ds FLOP per row (decay, the rank-1
// update, y = state . C), less than the dual form's even counted over its
// causal triangles only: at the zamba2-7b serving shape (B 8, S 474,
// nh 112, hd 64, ds 64) 8.7 GFLOP, 0.13 ms at 67 TFLOP/s of fp32 FMA,
// while x and y are 0.22 GB (0.065 ms at 3.35 TB/s).  This kernel does
// the dual form over full 64 x 64 squares, ~2.1 MFLOP per chunk and
// (batch, head): 8 chunks x 896 blocks, ~15 GFLOP.
//
// What this design does about it (first, simple version): nothing leaves
// the chip between chunks.  One block owns one (batch, head) and walks
// fixed 64-row chunks in order; the [hd, ds] state stays in shared memory
// in fp32, so the Pallas grid's sequential chunk axis becomes a loop in
// the block and no chunk state goes to device memory.  A ragged last chunk
// is masked rather than shrinking the chunk until it divides S (the
// Pallas rule, which gives a 79-row chunk at S = 474 and one row at a
// prime S): rows past S get dt = 0 and x = B = C = 0, so their decay is
// exp(0) = 1, their update 0, and their y rows are not written.  The mask
// of L sits on the exponent as in the reference (exp(-1e30) = 0), so a
// positive masked difference never reaches expf.  The three chained
// products of a chunk (C B^T; (L o .)(x dt) with C state^T; the state
// update) run on the FP32 FMA pipes from register tiles of a 16 x 16
// thread grid; tensor cores (TF32 or bf16 wgmma) and TMA-fed tiles are
// later work, so the kernel sits far below the card's roof.
//
// Precision: the cumulative log-decay cs is summed in fp64.  With A down to
// -16, cs reaches about -1000 within a chunk; in fp32 each cs carries an
// absolute rounding of ~6e-5, which becomes the relative error of the L
// entries that matter (those near the diagonal), and the fp32 dual form's
// y ends ~1e-5 (relative to its largest value) off the exact recurrence,
// against ~1e-7 for an fp32 recurrence.  From fp64 sums the differences
// are exact to fp32 precision; the products stay fp32.
#include <atomic>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;         // chunk rows
constexpr int THREADS = 256;  // a 16 x 16 thread grid
constexpr int RQ = Q / 16;    // chunk rows (or columns) per thread: t + 16 r
constexpr int GS = Q + 1;     // row stride of the L o C B^T tile (bank spread)
constexpr float NEG_INF = -1e30f;

struct Strides {
  int64_t b, s, h;  // in elements; the innermost stride is 1
};

template <int HD, int DS>
constexpr size_t smem_bytes() {
  // cs [Q] in fp64 (first, for its alignment); x dt [Q][HD]; B and C
  // [Q][DS + 1] (a padded row stride, so 16 rows read at the same n hit 16
  // banks); L o C B^T [Q][GS]; the state transposed [DS][HD]; the
  // state-update weights [Q].
  return sizeof(double) * Q +
         sizeof(float) * (size_t)(Q * HD + 2 * Q * (DS + 1) + Q * GS + DS * HD + Q);
}

template <int HD, int DS>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ sf, int S, int nh, Strides xs,
                Strides dts, Strides bs, Strides cs_, Strides ys) {
  static_assert(HD % 16 == 0 && DS % 16 == 0, "the thread grid tiles by 16");
  constexpr int BS = DS + 1;
  constexpr int PJ = HD / 16;  // state/output columns p per thread: tx + 16 j
  constexpr int NJ = DS / 16;  // state rows n per thread: ty + 16 a
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* scs = reinterpret_cast<double*>(smem_raw);  // [Q] cumulative log-decay
  float* sx = reinterpret_cast<float*>(scs + Q);       // [Q][HD]  x * dt
  float* sb = sx + Q * HD;      // [Q][BS]
  float* sc = sb + Q * BS;      // [Q][BS]
  float* sg = sc + Q * BS;      // [Q][GS]  L o C B^T
  float* sst = sg + Q * GS;     // [DS][HD] the state, transposed
  float* sw = sst + DS * HD;    // [Q] exp(cs_last - cs_j)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const double a = A[h];
  const float* xb = x + b * xs.b + h * xs.h;
  const float* dtb = dt + b * dts.b + h;
  const float* Bb = Bm + b * bs.b;
  const float* Cb = Cm + b * cs_.b;
  float* yb = y + b * ys.b + h * ys.h;
  const int64_t st_off = ((int64_t)b * nh + h) * HD * DS;

  for (int i = tid; i < HD * DS; i += THREADS) {
    const int p = i / DS, n = i % DS;
    sst[n * HD + p] = s0 ? s0[st_off + i] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    // The chunk's last row inside S: the state leaves from its cumulative
    // decay.  Rows past it add 0 to that decay, but the scan sums them in
    // another order, so reading scs[Q - 1] would put rounding on the
    // weight of the last row (exactly 1) of every ragged chunk.
    const int last = min(Q, S - c0) - 1;
    __syncthreads();  // the previous chunk is consumed (and the state written)

    // 1. cumulative log-decay in fp64 (warp 0, two rows a lane; dt * A is
    //    exact in fp64) and the tiles.
    if (tid < 32) {
      const int r0 = 2 * tid, r1 = r0 + 1;
      const double a0 = (c0 + r0 < S) ? dtb[(int64_t)(c0 + r0) * dts.s] * a : 0.0;
      const double a1 = (c0 + r1 < S) ? dtb[(int64_t)(c0 + r1) * dts.s] * a : 0.0;
      double incl = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double t = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += t;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0;
      scs[r0] = excl + a0;
      scs[r1] = incl;
    }
    for (int i = tid; i < Q * HD; i += THREADS) {
      const int r = i / HD, p = i % HD;
      float v = 0.f;
      if (c0 + r < S)
        v = xb[(int64_t)(c0 + r) * xs.s + p] * dtb[(int64_t)(c0 + r) * dts.s];
      sx[i] = v;
    }
    for (int i = tid; i < Q * DS; i += THREADS) {
      const int r = i / DS, n = i % DS;
      float bv = 0.f, cv = 0.f;
      if (c0 + r < S) {
        bv = Bb[(int64_t)(c0 + r) * bs.s + n];
        cv = Cb[(int64_t)(c0 + r) * cs_.s + n];
      }
      sb[r * BS + n] = bv;
      sc[r * BS + n] = cv;
    }
    __syncthreads();

    // 2. L o C B^T: rows i = ty + 16 r, columns j = tx + 16 k.
    {
      float s[RQ][RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int k = 0; k < RQ; ++k) s[r][k] = 0.f;
#pragma unroll 4
      for (int n = 0; n < DS; ++n) {
        float cv[RQ], bv[RQ];
#pragma unroll
        for (int r = 0; r < RQ; ++r) cv[r] = sc[(ty + 16 * r) * BS + n];
#pragma unroll
        for (int k = 0; k < RQ; ++k) bv[k] = sb[(tx + 16 * k) * BS + n];
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
          for (int k = 0; k < RQ; ++k) s[r][k] = fmaf(cv[r], bv[k], s[r][k]);
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int k = 0; k < RQ; ++k) {
          const int j = tx + 16 * k;
          sg[i * GS + j] = s[r][k] * expf(i >= j ? (float)(scs[i] - scs[j]) : NEG_INF);
        }
      }
      if (tid < Q) sw[tid] = expf((float)(scs[last] - scs[tid]));
    }
    __syncthreads();

    // 3. y rows i = ty + 16 r, columns p = tx + 16 j: the chunk's own
    //    rows through L o C B^T, plus the entering state through C.
    {
      float acc[RQ][PJ], off[RQ][PJ];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[r][j] = off[r][j] = 0.f;
#pragma unroll 4
      for (int jr = 0; jr < Q; ++jr) {
        float gv[RQ];
#pragma unroll
        for (int r = 0; r < RQ; ++r) gv[r] = sg[(ty + 16 * r) * GS + jr];
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const float xv = sx[jr * HD + tx + 16 * j];
#pragma unroll
          for (int r = 0; r < RQ; ++r) acc[r][j] = fmaf(gv[r], xv, acc[r][j]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < DS; ++n) {
        float cv[RQ];
#pragma unroll
        for (int r = 0; r < RQ; ++r) cv[r] = sc[(ty + 16 * r) * BS + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const float sv = sst[n * HD + tx + 16 * j];
#pragma unroll
          for (int r = 0; r < RQ; ++r) off[r][j] = fmaf(cv[r], sv, off[r][j]);
        }
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int i = ty + 16 * r;
        if (c0 + i >= S) continue;
        const float e = expf((float)scs[i]);
        float* yr = yb + (int64_t)(c0 + i) * ys.s;
#pragma unroll
        for (int j = 0; j < PJ; ++j) yr[tx + 16 * j] = acc[r][j] + off[r][j] * e;
      }
    }
    __syncthreads();  // every read of the entering state is done

    // 4. the state leaving the chunk: rows n = ty + 16 a, columns p = tx + 16 j.
    {
      const float dec = expf((float)scs[last]);
      float acc[NJ][PJ];
#pragma unroll
      for (int an = 0; an < NJ; ++an)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[an][j] = sst[(ty + 16 * an) * HD + tx + 16 * j] * dec;
#pragma unroll 4
      for (int jr = 0; jr < Q; ++jr) {
        const float w = sw[jr];
        float bv[NJ];
#pragma unroll
        for (int an = 0; an < NJ; ++an) bv[an] = sb[jr * BS + ty + 16 * an] * w;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const float xv = sx[jr * HD + tx + 16 * j];
#pragma unroll
          for (int an = 0; an < NJ; ++an) acc[an][j] = fmaf(bv[an], xv, acc[an][j]);
        }
      }
#pragma unroll
      for (int an = 0; an < NJ; ++an)
#pragma unroll
        for (int j = 0; j < PJ; ++j) sst[(ty + 16 * an) * HD + tx + 16 * j] = acc[an][j];
    }
  }
  __syncthreads();
  for (int i = tid; i < HD * DS; i += THREADS) {
    const int p = i / DS, n = i % DS;
    sf[st_off + i] = sst[n * HD + p];
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

struct Args {
  const float *x, *dt, *A, *Bm, *Cm, *s0;
  float *y, *sf;
  int B, S, nh;
  Strides xs, dts, bs, cs, ys;
};

template <int HD, int DS>
cudaError_t launch(const Args& g, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<HD, DS>;
  constexpr size_t smem = smem_bytes<HD, DS>();
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t e = opt_in_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid(g.nh, g.B);
  kern<<<grid, THREADS, smem, stream>>>(g.x, g.dt, g.A, g.Bm, g.Cm, g.s0, g.y, g.sf, g.S, g.nh,
                                        g.xs, g.dts, g.bs, g.cs, g.ys);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_ds(int ds, const Args& g, cudaStream_t stream) {
  switch (ds) {
    case 16: return launch<HD, 16>(g, stream);
    case 32: return launch<HD, 32>(g, stream);
    case 64: return launch<HD, 64>(g, stream);
    case 128: return launch<HD, 128>(g, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// All tensors fp32; strides in elements, the innermost stride of x, dt,
// Bm, Cm and y is 1; s0 (may be null: a zero state) and sf are contiguous
// [B,nh,hd,ds].  Returns the cudaError_t of the launch (0 on success); the
// kernel runs on `stream` and nothing here synchronises.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, const void* s0, void* y, void* sf, int B, int S,
                               int nh, int hd, int ds, int64_t x_sb, int64_t x_ss, int64_t x_sh,
                               int64_t dt_sb, int64_t dt_ss, int64_t b_sb, int64_t b_ss,
                               int64_t c_sb, int64_t c_ss, int64_t y_sb, int64_t y_ss,
                               int64_t y_sh, void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0) return cudaErrorInvalidValue;
  const Args g{static_cast<const float*>(x),  static_cast<const float*>(dt),
               static_cast<const float*>(A),  static_cast<const float*>(Bm),
               static_cast<const float*>(Cm), static_cast<const float*>(s0),
               static_cast<float*>(y),        static_cast<float*>(sf),
               B, S, nh,
               Strides{x_sb, x_ss, x_sh},     Strides{dt_sb, dt_ss, 1},
               Strides{b_sb, b_ss, 0},        Strides{c_sb, c_ss, 0},
               Strides{y_sb, y_ss, y_sh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_ds<16>(ds, g, st);
    case 32: return launch_ds<32>(ds, g, st);
    case 64: return launch_ds<64>(ds, g, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* ssd_scan_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
