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
// in float32, with the products and sums rounded separately as the
// reference rounds them (the library is built with --fmad=false) and
// `expf`, not the fast intrinsic.
//
// What bounds it on an H100 (SXM): at the model's shape (B 2, S 1 024,
// D 8 192, N 16) it moves 201 MB (x, dt in, y out; 0.060 ms at 3.35 TB/s)
// and evaluates 268 M exponentials (0.064 ms at 16 per clock per SM on the
// special-function units of 132 SMs at 1.98 GHz): the exponentials, just.
//
// Design, kept simple.  The TPU kernel carries h [N, bd] in VMEM scratch
// across a sequential grid axis of time chunks; here blocks run in no
// order, so the whole time loop runs inside the block.  The independent
// recurrences are B x D x N (262 144 at the model's shape), one thread
// each: a group of G lanes (G = N rounded up to a power of two, at least
// 4, at most 32, each lane holding K states when N > 32) owns one
// channel, and a block owns 16 channels of one batch row.  A is read once
// into registers.  Chunks of T time steps of x and dt (T x 16 channels)
// and of B and C (T x N) are staged in shared memory with coalesced loads,
// so the S dependent steps never wait on a global load; y_t is a G-lane
// shuffle sum written to shared memory by lane 0 and stored a chunk at a
// time.  A later design overlaps the next chunk's loads with this chunk's
// steps, and shares the exponentials' argument work across states.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 16;  // channels per block

template <int G, int K>
struct Tile {
  static constexpr int NP = G * K;                     // padded state dim
  static constexpr int T = NP <= 32 ? 64 : 2048 / NP;  // steps per staged chunk
  static constexpr int kThreads = kChannels * G;
};

template <int G, int K>
__global__ void __launch_bounds__(Tile<G, K>::kThreads)
mamba_scan(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ bm,
           const float* __restrict__ cm, float* __restrict__ y, int64_t S,
           int64_t D, int N) {
  constexpr int NP = Tile<G, K>::NP;
  constexpr int T = Tile<G, K>::T;
  constexpr int NT = Tile<G, K>::kThreads;
  __shared__ float xs[T][kChannels];
  __shared__ float ds[T][kChannels];
  __shared__ float ys[T][kChannels];
  __shared__ float bs[T][NP];
  __shared__ float cs[T][NP];

  const int tid = threadIdx.x;
  const int lane = tid % G;  // this thread's state lane in its channel
  const int ch = tid / G;    // this thread's channel in the block
  const int64_t c0 = (int64_t)blockIdx.x * kChannels;
  const int64_t b = blockIdx.y;
  const int64_t c = c0 + ch;

  // Padded states (n >= N) and channels (c >= D) keep A = 0 and see
  // B = C = x = dt = 0: their h stays 0 and adds nothing to y.
  float av[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = lane + k * G;
    av[k] = (c < D && n < N) ? a[c * N + n] : 0.f;
    h[k] = 0.f;
  }
  const float* xb = x + b * S * D;
  const float* db = dt + b * S * D;
  const float* bb = bm + b * S * N;
  const float* cb = cm + b * S * N;
  float* yb = y + b * S * D;

  for (int64_t t0 = 0; t0 < S; t0 += T) {
    const int steps = (int)(S - t0 < T ? S - t0 : T);
    for (int i = tid; i < T * kChannels; i += NT) {
      const int r = i / kChannels, cc = i % kChannels;
      const bool in = r < steps && c0 + cc < D;
      const int64_t off = (t0 + r) * D + c0 + cc;
      xs[r][cc] = in ? xb[off] : 0.f;
      ds[r][cc] = in ? db[off] : 0.f;
    }
    for (int i = tid; i < T * NP; i += NT) {
      const int r = i / NP, n = i % NP;
      const bool in = r < steps && n < N;
      const int64_t off = (t0 + r) * N + n;
      bs[r][n] = in ? bb[off] : 0.f;
      cs[r][n] = in ? cb[off] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < steps; ++r) {  // `steps` is uniform: shuffles are safe
      const float d = ds[r][ch];
      const float dx = d * xs[r][ch];
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int n = lane + k * G;
        h[k] = expf(d * av[k]) * h[k] + bs[r][n] * dx;
        acc += cs[r][n] * h[k];
      }
#pragma unroll
      for (int w = G / 2; w >= 1; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
      if (lane == 0) ys[r][ch] = acc;
    }
    __syncthreads();  // ys complete; the next chunk's staging may overwrite inputs
    for (int i = tid; i < steps * kChannels; i += NT) {
      const int r = i / kChannels, cc = i % kChannels;
      if (c0 + cc < D) yb[(t0 + r) * D + c0 + cc] = ys[r][cc];
    }
  }
}

template <int G, int K>
cudaError_t launch(const void* x, const void* dt, const void* a, const void* bm,
                   const void* cm, void* y, int64_t B, int64_t S, int64_t D,
                   int64_t N, cudaStream_t stream) {
  const dim3 grid((unsigned)((D + kChannels - 1) / kChannels), (unsigned)B);
  mamba_scan<G, K><<<grid, Tile<G, K>::kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<float*>(y), S, D, (int)N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All tensors float32 and contiguous: x, dt, y [B, S, D]; a [D, N];
// bm, cm [B, S, N].  N <= 128.  Returns a cudaError_t.
int mamba_scan_fwd(const void* x, const void* dt, const void* a, const void* bm,
                   const void* cm, void* y, int64_t B, int64_t S, int64_t D,
                   int64_t N, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || D <= 0 || N <= 0 || N > 128)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 4) return launch<4, 1>(x, dt, a, bm, cm, y, B, S, D, N, st);
  if (N <= 8) return launch<8, 1>(x, dt, a, bm, cm, y, B, S, D, N, st);
  if (N <= 16) return launch<16, 1>(x, dt, a, bm, cm, y, B, S, D, N, st);
  if (N <= 32) return launch<32, 1>(x, dt, a, bm, cm, y, B, S, D, N, st);
  if (N <= 64) return launch<32, 2>(x, dt, a, bm, cm, y, B, S, D, N, st);
  return launch<32, 4>(x, dt, a, bm, cm, y, B, S, D, N, st);
}

}  // extern "C"
