// Flash decode (K3) for Hopper: one query token against a KV cache,
// float32 state.
//
// Replaces the Pallas TPU kernel `_kernel` / `flash_decode_bhsd` in
// src/repro/kernels/decode_attention.py (reached through `ops.flash_decode`).
// For q [B, nq, 1, hd] and caches k, v [B, nkv, S, hd] it computes
//
//   out[b, h] = softmax_{j <= pos}( (q[b, h] * scale) . k[b, h / g, j] ) v[b, h / g, j]
//
// with g = nq / nkv: keys j <= pos count (inclusive), key tiles wholly
// after pos are never read, the softmax runs online over key tiles (m, l,
// acc in float32) with masked scores set to -1e30, the final divide is
// guarded by l > 0 (so pos < 0 gives zeros, as in the reference kernel),
// and the output is in q's type.  `pos` is a kernel argument.
//
// What bounds it on an H100 (SXM): bytes.  It reads each cache entry up to
// pos once (at B 4, nkv 8, hd 128, bf16, pos 600: 9.8 MB, 2.9 us at
// 3.35 TB/s) and does about one multiply-add per byte.
//
// Design, kept simple: one block of 128 threads per (q head, batch), so
// the g heads of a group each stream their kv head (the repeats mostly hit
// L2).  Per 32-key tile, k and v are staged in shared memory as float32;
// four threads share each key's dot product (interleaved over hd, padded
// rows, so the reads are conflict-free) and combine it with two shuffles;
// block-wide max and sum through shared memory; then each thread
// accumulates one (hd 128) or half of one (hd 64) output column over the
// tile's keys.  A later design splits the keys over more blocks and loads
// the tiles asynchronously.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // == decode_attention.NEG_INF
constexpr int kBK = 32;            // keys per tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {  // in elements; the head dim is contiguous
  int64_t b, h, s;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides qs,
             Strides ks, Strides vs, Strides os, int group, int64_t S,
             int64_t pos, float scale) {
  constexpr int KLD = HD + 4;         // 4 threads per key, interleaved: 32 banks
  constexpr int KSPLIT = kThreads / HD;  // threads per output column
  static_assert(KSPLIT * HD == kThreads, "hd must divide the block");
  __shared__ float Qs[HD];
  __shared__ float Ks[kBK * KLD];
  __shared__ float Vs[kBK * HD];
  __shared__ float Ps[kBK];
  __shared__ float red_max[kWarps];
  __shared__ float red_sum[kWarps];
  __shared__ float part[kThreads];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int d = tid; d < HD; d += kThreads) Qs[d] = to_f32(qb[d]) * scale;

  const int key = tid / 4;  // this thread's key within the tile (dot phase)
  const int part4 = tid % 4;
  const int col = tid % HD;  // this thread's output column (P.V phase)
  const int split = tid / HD;
  float m = kNegInf, l = 0.f, acc = 0.f;

  const int64_t kend = pos < S - 1 ? pos + 1 : S;  // keys [0, kend) count
  for (int64_t k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile is done with Ks, Vs and Ps
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int64_t kj = k0 + r;
      const bool in = kj < S;
      Ks[r * KLD + d] = in ? to_f32(kb[kj * ks.s + d]) : 0.f;
      Vs[i] = in ? to_f32(vb[kj * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s = 0.f;
#pragma unroll 8
    for (int d = part4; d < HD; d += 4) s = fmaf(Qs[d], Ks[key * KLD + d], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (k0 + key > pos || k0 + key >= S) s = kNegInf;

    float mx = s;
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    if (lane == 0) red_max[warp] = mx;
    __syncthreads();
    mx = red_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red_max[w]);
    const float m_new = fmaxf(m, mx);
    const float p = expf(s - m_new);
    const float alpha = expf(m - m_new);
    float sum = part4 == 0 ? p : 0.f;
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    if (lane == 0) red_sum[warp] = sum;
    if (part4 == 0) Ps[key] = p;
    __syncthreads();
    sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red_sum[w];
    l = alpha * l + sum;
    m = m_new;

    float pv = 0.f;
#pragma unroll 8
    for (int c = split; c < kBK; c += KSPLIT) pv = fmaf(Ps[c], Vs[c * HD + col], pv);
    acc = acc * alpha + pv;
  }

  if (KSPLIT > 1) {
    part[tid] = acc;
    __syncthreads();
    if (split != 0) return;
    for (int r = 1; r < KSPLIT; ++r) acc += part[r * HD + col];
  }
  const float safe = l > 0.f ? l : 1.f;
  o[b * os.b + h * os.h + col] = from_f32<T>(acc / safe);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides qs, Strides ks, Strides vs, Strides os, int64_t B,
                   int64_t nq, int64_t group, int64_t S, int64_t pos,
                   float scale, cudaStream_t stream) {
  dim3 grid((unsigned)nq, (unsigned)B);
  flash_decode<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os,
      (int)group, S, pos, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements (batch, head,
// sequence) for q, the k and v caches, and out; q and out have one
// position.  Returns a cudaError_t.
int flash_decode_fwd(const void* q, const void* k, const void* v, void* o,
                     int64_t B, int64_t nq, int64_t nkv, int64_t S, int64_t hd,
                     int64_t dtype, int64_t q_sb, int64_t q_sh, int64_t k_sb,
                     int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                     int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t pos,
                     float scale, void* stream) {
  if (nkv <= 0 || nq % nkv != 0 || S <= 0) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, 0}, ks{k_sb, k_sh, k_ss};
  const Strides vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, 0};
  const int64_t group = nq / nkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FD_LAUNCH(T, HD) \
  launch<T, HD>(q, k, v, o, qs, ks, vs, os, B, nq, group, S, pos, scale, st)
  if (dtype == 0 && hd == 64) return REPRO_FD_LAUNCH(float, 64);
  if (dtype == 0 && hd == 128) return REPRO_FD_LAUNCH(float, 128);
  if (dtype == 1 && hd == 64) return REPRO_FD_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) return REPRO_FD_LAUNCH(__nv_bfloat16, 128);
#undef REPRO_FD_LAUNCH
  return cudaErrorInvalidValue;
}

}  // extern "C"
