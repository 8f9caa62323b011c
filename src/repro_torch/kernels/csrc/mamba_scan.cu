// Selective scan (K4, mamba1) for Hopper, float32.
//
// Replaces the Pallas TPU kernel `_kernel` / `mamba_scan_blocked` in
// src/repro/kernels/mamba_scan.py (reached through `ops.mamba_scan` from
// `models/ssm.py::mamba_block` when ssm_impl == "pallas").  For x, dt
// [B, S, D], A [D, N] and B, C [B, S, N] it computes, per batch row b and
// channel c, with h[c, :] = 0 before the first step,
//
//   h_t[c, n] = exp(dt_t[c] * A[c, n]) * h_{t-1}[c, n] + B_t[n] * (dt_t[c] * x_t[c])
//   y_t[c]    = sum_n C_t[n] * h_t[c, n]
//
// in float32.  Its rounding differs from the reference's in three places,
// each within float32's own error (ref.mamba_scan_design_ref computes the
// same arithmetic on the CPU):
//   - exp(dt*A) is ex2.approx.ftz of dt * (A * log2 e), A * log2 e rounded
//     once per thread when A is read;
//   - h = e*h + B*(dt*x) and the y sum are explicit fused multiply-adds
//     (__fmaf_rn, which the library's --fmad=false leaves alone);
//   - y sums each lane's states in order, then the lanes pairwise.
//
// What bounds it on an H100 (SXM): at the model's shape (B 2, S 1 024,
// D 8 192, N 16) it moves 201 MB (x, dt in, y out; 0.060 ms at 3.35 TB/s)
// and evaluates 268 M exponentials (0.064 ms at 16 per clock per SM on the
// special-function units of 132 SMs at 1.98 GHz): both, nearly equally.
//
// Design.  The time loop runs inside the block (the TPU kernel carried h
// across a sequential grid axis; blocks here run in no order).  A channel's
// N states are held by G lanes of K states each (G*K >= N; K = 8 from
// N 16 up, so y needs log2 G shuffle steps: one at N 16), and a block of
// 128 threads owns 128/G channels of one batch row (64 at N 16: 256 blocks,
// two per SM, one wave).  Per state and step the thread issues one
// multiply for the exponent's argument, one ex2 on the special-function
// unit, one multiply for B*(dt*x) and two fused multiply-adds.  Chunks of
// 32 time steps of x, dt (32 x 128/G) and of B, C (32 x G*K, read by each
// thread as float4 broadcasts) are staged in shared memory by 16-byte
// cp.async (4-byte where a row is not 16-byte aligned) into two buffers:
// the next chunk is in flight while this one steps, one wait and one
// __syncthreads per chunk.  y_t is staged beside them by the group's first
// lane and leaves a chunk at a time, coalesced, once the next chunk's
// barrier has passed.
//
// What holds it above the bound is not one resource: the special-function
// units run ex2 at their peak rate in isolation (the ex2 probe below), and in
// exploratory variants taking out the ex2, the B and C loads, the global
// loads, the y stores or the shuffle each left most of the time in place;
// what remains is the per-step instruction stream of two warps per
// scheduler.  Left for later: more independent work per warp, or a
// polynomial exp2 on the FMA pipe, and a backward kernel (the reference
// has none).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kSteps = 32;  // time steps per staged chunk

template <int G, int K>
struct Tile {
  static constexpr int NP = G * K;             // padded state dim
  static constexpr int CH = kThreads / G;      // channels per block
  static constexpr int ROW = 3 * CH + 2 * NP;  // floats staged per step: x, dt, y, B, C
  static constexpr size_t kSmem = 2 * (size_t)kSteps * ROW * sizeof(float);
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// cp.async of `bytes` (4 or 16) with `src_bytes` read and the rest of the
// destination zero-filled.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = in ? kBytes : 0;
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// K consecutive floats from shared memory, K * 4 bytes aligned.
template <int K>
__device__ __forceinline__ void load_states(const float* p, float* v) {
  if (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else if (K == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = p[i];
  }
}

// Stage `rows` x `width` floats of `src` (row stride `ld`, rows from `t0`,
// `avail` valid rows and `cols` valid columns) into dst[rows][width].
template <bool kVec>
__device__ __forceinline__ void stage(float* dst, const float* src, int64_t ld,
                                      int rows, int width, int avail, int64_t cols) {
  constexpr int kW = kVec ? 4 : 1;
  const int pieces = rows * (width / kW);
  for (int p = threadIdx.x; p < pieces; p += kThreads) {
    const int r = p / (width / kW);
    const int c = (p % (width / kW)) * kW;
    const bool in = r < avail && c < cols;
    cp_async<kW * 4>(dst + r * width + c, in ? src + r * ld + c : src, in);
  }
}

// kVec: D and N multiples of 4 and x, dt, y, B, C 16-byte aligned, so that
// every staged row moves 16 bytes at a time.
template <int G, int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
mamba_scan(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ bm,
           const float* __restrict__ cm, float* __restrict__ y, int64_t S,
           int64_t D, int N) {
  using Cfg = Tile<G, K>;
  constexpr int NP = Cfg::NP, CH = Cfg::CH, T = kSteps;
  extern __shared__ __align__(16) float smem[];
  // Two buffers, each xs[T][CH], ds[T][CH], ys[T][CH], bs[T][NP], cs[T][NP].
  auto xs = [&](int buf) { return smem + buf * T * Cfg::ROW; };
  auto ds = [&](int buf) { return xs(buf) + T * CH; };
  auto ys = [&](int buf) { return ds(buf) + T * CH; };
  auto bs = [&](int buf) { return ys(buf) + T * CH; };
  auto cs = [&](int buf) { return bs(buf) + T * NP; };

  const int tid = threadIdx.x;
  const int lane = tid % G;  // this thread's lane in its channel's group
  const int ch = tid / G;    // its channel in the block
  const int64_t c0 = (int64_t)blockIdx.x * CH;
  const int64_t b = blockIdx.y;
  const int64_t c = c0 + ch;
  const float* xb = x + b * S * D + c0;
  const float* db = dt + b * S * D + c0;
  const float* bb = bm + b * S * N;
  const float* cb = cm + b * S * N;
  float* yb = y + b * S * D;

  auto load_chunk = [&](int64_t t0, int buf) {
    const int avail = (int)(S - t0 < T ? S - t0 : T);
    stage<kVec>(xs(buf), xb + t0 * D, D, T, CH, avail, D - c0);
    stage<kVec>(ds(buf), db + t0 * D, D, T, CH, avail, D - c0);
    stage<kVec && NP % 4 == 0>(bs(buf), bb + t0 * N, N, T, NP, avail, N);
    stage<kVec && NP % 4 == 0>(cs(buf), cb + t0 * N, N, T, NP, avail, N);
    cp_async_commit();
  };
  load_chunk(0, 0);

  // Padded states (n >= N) and channels (c >= D) keep A = 0 and see
  // B = C = x = dt = 0: their h stays 0 and adds nothing to y.
  float a2[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = lane * K + k;
    a2[k] = (c < D && n < N) ? a[c * N + n] * kLog2e : 0.f;
    h[k] = 0.f;
  }

  // A chunk's y, staged in ys, goes out coalesced (16 bytes a thread where
  // rows are 16-byte aligned) once every thread has stepped it.
  auto store_y = [&](int64_t t0, int buf) {
    const int avail = (int)(S - t0 < T ? S - t0 : T);
    const float* src = ys(buf);
    if (kVec) {
      for (int p = tid; p < avail * (CH / 4); p += kThreads) {
        const int r = p / (CH / 4), cc = (p % (CH / 4)) * 4;
        if (c0 + cc < D)
          *reinterpret_cast<float4*>(yb + (t0 + r) * D + c0 + cc) =
              *reinterpret_cast<const float4*>(src + r * CH + cc);
      }
    } else {
      for (int p = tid; p < avail * CH; p += kThreads) {
        const int r = p / CH, cc = p % CH;
        if (c0 + cc < D) yb[(t0 + r) * D + c0 + cc] = src[r * CH + cc];
      }
    }
  };

  const int64_t chunks = (S + T - 1) / T;
  for (int64_t i = 0; i < chunks; ++i) {
    const int buf = (int)(i & 1);
    cp_async_wait_all();
    __syncthreads();  // chunk i staged; every thread is past chunk i - 1
    if (i + 1 < chunks) load_chunk((i + 1) * T, buf ^ 1);
    if (i > 0) store_y((i - 1) * T, buf ^ 1);
    const int64_t t0 = i * T;
    const int steps = (int)(S - t0 < T ? S - t0 : T);  // uniform: shuffles are safe
    const float* xr = xs(buf) + ch;
    const float* dr = ds(buf) + ch;
    const float* br = bs(buf) + lane * K;
    const float* cr = cs(buf) + lane * K;
#pragma unroll 2
    for (int r = 0; r < steps; ++r) {
      const float d = dr[r * CH];
      const float dx = d * xr[r * CH];
      float bv[K], cv[K];
      load_states<K>(br + r * NP, bv);
      load_states<K>(cr + r * NP, cv);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float e = ex2(d * a2[k]);
        h[k] = __fmaf_rn(e, h[k], bv[k] * dx);
        acc = __fmaf_rn(cv[k], h[k], acc);
      }
#pragma unroll
      for (int w = G / 2; w >= 1; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
      if (lane == 0) ys(buf)[r * CH + ch] = acc;
    }
  }
  __syncthreads();
  store_y((chunks - 1) * T, (int)((chunks - 1) & 1));
}

template <int G, int K, bool kVec>
cudaError_t launch_as(const float* x, const float* dt, const float* a, const float* bm,
                   const float* cm, float* y, int64_t B, int64_t S, int64_t D,
                   int64_t N, cudaStream_t stream) {
  using Cfg = Tile<G, K>;
  static bool sized = false;  // dynamic shared memory above 48 KB, once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba_scan<G, K, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::kSmem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid((unsigned)((D + Cfg::CH - 1) / Cfg::CH), (unsigned)B);
  mamba_scan<G, K, kVec><<<grid, kThreads, Cfg::kSmem, stream>>>(x, dt, a, bm, cm, y, S, D,
                                                                  (int)N);
  return cudaGetLastError();
}

template <int G, int K>
cudaError_t launch(const float* x, const float* dt, const float* a, const float* bm,
                   const float* cm, float* y, int64_t B, int64_t S, int64_t D,
                   int64_t N, cudaStream_t stream) {
  const bool vec = D % 4 == 0 && N % 4 == 0 &&
                   ((uintptr_t)x | (uintptr_t)dt | (uintptr_t)y | (uintptr_t)bm |
                    (uintptr_t)cm) % 16 == 0;
  return vec ? launch_as<G, K, true>(x, dt, a, bm, cm, y, B, S, D, N, stream)
             : launch_as<G, K, false>(x, dt, a, bm, cm, y, B, S, D, N, stream);
}

// Measurement probe (chip_smoke.py; not part of the scan's interface):
// each thread runs 16 independent chains of `iters` ex2, the throughput of
// the special-function units.
__global__ void ex2_probe(float* out, int iters) {
  float v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = -1e-3f * (float)(threadIdx.x + k);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = ex2(0.5f * v[k]) - 1.0f;
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) s += v[k];
  if (s == 12345.f) out[0] = s;  // keeps the chains live
}

}  // namespace

extern "C" {

// All tensors float32 and contiguous: x, dt, y [B, S, D]; a [D, N];
// bm, cm [B, S, N].  N <= 128.  Returns a cudaError_t.  The (G, K) plan
// for each N is `mamba_scan.scan_lanes` in the wrapper.
int mamba_scan_fwd(const void* x, const void* dt, const void* a, const void* bm,
                   const void* cm, void* y, int64_t B, int64_t S, int64_t D,
                   int64_t N, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || D <= 0 || N <= 0 || N > 128)
    return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(bm);
  const float* cf = static_cast<const float*>(cm);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 1) return launch<1, 1>(xf, df, af, bf, cf, yf, B, S, D, N, st);
  if (N <= 2) return launch<1, 2>(xf, df, af, bf, cf, yf, B, S, D, N, st);
  if (N <= 4) return launch<1, 4>(xf, df, af, bf, cf, yf, B, S, D, N, st);
  if (N <= 8) return launch<1, 8>(xf, df, af, bf, cf, yf, B, S, D, N, st);
  if (N <= 16) return launch<2, 8>(xf, df, af, bf, cf, yf, B, S, D, N, st);
  if (N <= 32) return launch<4, 8>(xf, df, af, bf, cf, yf, B, S, D, N, st);
  if (N <= 64) return launch<8, 8>(xf, df, af, bf, cf, yf, B, S, D, N, st);
  return launch<16, 8>(xf, df, af, bf, cf, yf, B, S, D, N, st);
}

// blocks x 256 threads x iters x 16 exponentials.
int mamba_scan_probe_ex2(void* out, int blocks, int iters, void* stream) {
  if (blocks <= 0 || iters <= 0) return cudaErrorInvalidValue;
  ex2_probe<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out),
                                                                   iters);
  return cudaGetLastError();
}

}  // extern "C"
