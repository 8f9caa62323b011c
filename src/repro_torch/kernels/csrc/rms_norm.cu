// RMSNorm for Hopper: one read and one write of each row.
//
// Replaces no Pallas kernel: the reference's `rms_norm`
// (src/repro/models/layers.py) is a chain of jnp ops that XLA fuses into
// one pass, while PyTorch runs the same chain (`kernels/ref.py::
// rms_norm_ref`) as nine kernels, each reading or writing a float32 copy of
// the whole activation.  For x [rows, width] and weight [width] it computes
// what the chain computes, in the same order:
//
//   ms      = (sum_j float(x[r, j]) * float(x[r, j])) / width     (float32)
//   rstd    = rsqrtf(ms + eps)
//   y[r, j] = round((float(x[r, j]) * rstd) * float(w[j]))        (two multiplies)
//
// rounded once to x's type (round to nearest even).  Only the order of the
// row's sum differs from the chain's, so an output may sit one ulp of its
// type away from the plain version's.
//
// What bounds it on an H100 (SXM): bytes.  It reads each element of x once
// and writes each of y once (at 3 968 x 5 120 in bf16: 81.3 MB, 24 us at
// 3.35 TB/s); the weight is re-read by every row but stays in L2.
//
// Design.  A row is held in registers between the sum and the scaling, so
// it is never read twice: each thread of a row's group holds VPT packs of
// 16 bytes of x (8 bf16 or 4 float32), pack p = lane + i * lanes, loaded
// and stored by 16-byte vectors.  Narrow rows (at most 128 packs: 1 024
// bf16, the q/k norms' 128, internvl2's 896) take a warp each, four rows to
// a block; wider rows take a block each, of as many warps as 4 packs a
// thread need (5 120 bf16: 640 packs, 160 threads; 8 packs a thread past
// 512 threads), their squares summed by warp shuffles and then across warps
// through shared memory.  A width that is not a whole number of packs, or a
// base that is not 16-byte aligned, takes the scalar path of the same kernel
// (`vec` 0): the same packs, read and written element by element, the row's
// tail masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpRowsPerBlock = 4;   // narrow rows: a warp each
constexpr int kWarpMaxPacks = 128;     // = 32 lanes x 4 packs
constexpr int kBlockVpt = 4;           // wide rows: packs a thread (8 past 2 048 packs)
constexpr int kMaxThreads = 512;       // so that a thread may hold 128 registers

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N elements of U as one aligned value: a copy of it is one vector load or
// store (two for 32 bytes).
template <typename U, int N>
struct alignas(sizeof(U) * N >= 16 ? 16 : sizeof(U) * N) Pack {
  U v[N];
};

template <typename U, int N>
__device__ __forceinline__ void load_pack(const U* p, int64_t e, int64_t width, bool vec,
                                          float (&out)[N]) {
  if (vec) {
    if (e < width) {
      const Pack<U, N> pk = *reinterpret_cast<const Pack<U, N>*>(p + e);
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = to_f32(pk.v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = e + j < width ? to_f32(p[e + j]) : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// One row per group of `lanes` threads (32, or the whole block).
template <typename T, typename W, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_rows(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
              int64_t rows, int64_t width, int lanes, bool vec, float eps) {
  constexpr int kPack = 16 / sizeof(T);
  const int lane = threadIdx.x % lanes;
  const int64_t row = int64_t(blockIdx.x) * (blockDim.x / lanes) + threadIdx.x / lanes;
  if (row >= rows) return;   // narrow rows only: a wide row's block is one row
  const T* xr = x + row * width;
  T* yr = y + row * width;

  // The weight's loads go out with x's, so their latency overlaps the sum
  // (on an H100, 35.1 us at 3 968 x 5 120 bf16 against 40.6 us loaded
  // after it); at 8 packs a thread that would spill, so there they follow
  // the sum.
  constexpr bool kEarlyWeight = VPT <= 4;
  float v[VPT][kPack];
  float wf[kEarlyWeight ? VPT : 1][kPack];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int64_t e = int64_t(lane + i * lanes) * kPack;
    load_pack<T, kPack>(xr, e, width, vec, v[i]);
    if constexpr (kEarlyWeight) load_pack<W, kPack>(w, e, width, vec, wf[i]);
  }

  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i)
#pragma unroll
    for (int j = 0; j < kPack; ++j) s += v[i][j] * v[i][j];
  s = warp_sum(s);
  if (lanes > 32) {
    __shared__ float part[kMaxThreads / 32];
    const int l32 = threadIdx.x & 31;
    if (l32 == 0) part[threadIdx.x >> 5] = s;
    __syncthreads();
    // every warp sums the partials in the same order, so all hold one value
    s = warp_sum(l32 < int(blockDim.x >> 5) ? part[l32] : 0.f);
  }
  const float rstd = rsqrtf(s / float(width) + eps);

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int64_t e = int64_t(lane + i * lanes) * kPack;
    const int k = kEarlyWeight ? i : 0;
    if constexpr (!kEarlyWeight) load_pack<W, kPack>(w, e, width, vec, wf[0]);
    if (vec) {
      if (e < width) {
        Pack<T, kPack> pk;
#pragma unroll
        for (int j = 0; j < kPack; ++j) pk.v[j] = from_f32<T>((v[i][j] * rstd) * wf[k][j]);
        *reinterpret_cast<Pack<T, kPack>*>(yr + e) = pk;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPack; ++j)
        if (e + j < width) yr[e + j] = from_f32<T>((v[i][j] * rstd) * wf[k][j]);
    }
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* y, int64_t rows, int64_t width, bool vec,
           float eps, cudaStream_t st) {
  constexpr int kPack = 16 / sizeof(T);
  const int64_t packs = (width + kPack - 1) / kPack;
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* yp = static_cast<T*>(y);
  if (packs <= kWarpMaxPacks) {
    const unsigned grid = unsigned((rows + kWarpRowsPerBlock - 1) / kWarpRowsPerBlock);
    const int threads = 32 * kWarpRowsPerBlock;
    if (packs <= 32)
      rms_norm_rows<T, W, 1><<<grid, threads, 0, st>>>(xp, wp, yp, rows, width, 32, vec, eps);
    else if (packs <= 64)
      rms_norm_rows<T, W, 2><<<grid, threads, 0, st>>>(xp, wp, yp, rows, width, 32, vec, eps);
    else
      rms_norm_rows<T, W, 4><<<grid, threads, 0, st>>>(xp, wp, yp, rows, width, 32, vec, eps);
  } else {
    const int vpt = packs <= int64_t(kMaxThreads) * kBlockVpt ? kBlockVpt : 2 * kBlockVpt;
    const int64_t warps = (packs + 32 * vpt - 1) / (32 * vpt);
    if (warps * 32 > kMaxThreads) return cudaErrorInvalidValue;
    const int threads = int(warps * 32);
    if (vpt == kBlockVpt)
      rms_norm_rows<T, W, kBlockVpt><<<unsigned(rows), threads, 0, st>>>(
          xp, wp, yp, rows, width, threads, vec, eps);
    else
      rms_norm_rows<T, W, 2 * kBlockVpt><<<unsigned(rows), threads, 0, st>>>(
          xp, wp, yp, rows, width, threads, vec, eps);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: [rows, width], contiguous, of `x_dtype`; w: [width], contiguous, of
// `w_dtype` (0 = float32, 1 = bfloat16).  `vec` 1: x's and w's bases are
// 16-byte aligned (w's: aligned to its pack's bytes where that is less) and
// width is a whole number of x's 16-byte packs.  At most 512 * 8 * 16
// bytes of x a row.  Returns a cudaError_t.
int rms_norm_fwd(const void* x, const void* w, void* y, int64_t rows, int64_t width,
                 int64_t x_dtype, int64_t w_dtype, int64_t vec, float eps, void* stream) {
  if (rows <= 0 || width <= 0 || rows > 0x7fffffff) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  if (x_dtype == 0 && w_dtype == 0) return launch<float, float>(x, w, y, rows, width, v, eps, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, y, rows, width, v, eps, st);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, y, rows, width, v, eps, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, width, v, eps, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
