// Causal GQA flash attention (K2) for Hopper, float32 state.
//
// Replaces the Pallas TPU kernel `_kernel` / `flash_attention_bhsd` in
// src/repro/kernels/flash_attention.py (reached through `ops.flash_attention`
// from `models/attention.py::full_attention` when attn_impl == "pallas").
// For q [B, nq, Sq, hd] and k, v [B, nkv, Sk, hd] it computes
//
//   out[b, h, i] = softmax_j( (q[b, h, i] * scale) . k[b, h / g, j] ) v[b, h / g, j]
//
// with g = nq / nkv, keys j <= i only when causal, an online softmax over
// key tiles (m, l, acc in float32), masked scores set to -1e30 as in the
// reference, the final divide guarded by l > 0, and the output in q's type.
// q is scaled in float32 before the dot, as the reference does.
//
// What bounds it on an H100 (SXM): at the serving path's prefill shape
// (B 1, S 512, nq 32, nkv 8, hd 128, bf16) the bytes (q, k, v, out: 10.5 MB,
// 3.1 us at 3.35 TB/s) bound it, the causal FLOPs (2.2 GFLOP, 2.2 us at the
// bf16 tensor-core peak) just behind.  This first design runs on the CUDA
// cores in float32 and is far above that bound; wgmma and TMA come later.
//
// Design: one block of 256 threads per (q tile of 64 rows, q head, batch);
// the grid walks q tiles in reverse so the longest causal rows start first.
// The q tile (scaled, float32) stays in shared memory; each 64-key tile of
// k and v is staged there as float32, key tiles wholly above the diagonal
// are skipped.  Each thread owns a 4 x 4 block of the score tile (rows
// ty + 16i, columns tx + 16j) and the matching 4 rows x hd/16 columns of
// the accumulator, so row reductions are 16-lane shuffles.  Probabilities
// go through shared memory (over the k tile, which is done by then) into
// the P.V product.  Inputs may be strided in batch, head and sequence; the
// head dim must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // == flash_attention.NEG_INF
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;

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

template <int HD>
constexpr size_t smem_bytes() {
  // Qs [kBQ][HD] + Ks [kBK][HD + 1] (reused as Ps [kBQ][kBK + 1]) + Vs [kBK][HD]
  return sizeof(float) * (kBQ * HD + kBK * (HD + 1) + kBK * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, Strides qs, Strides ks,
          Strides vs, Strides os, int group, int64_t Sq, int64_t Sk,
          float scale, int causal) {
  constexpr int KLD = HD + 1;  // padded k rows: column reads hit 16 banks
  constexpr int PLD = kBK + 1;
  constexpr int NJ = HD / 16;
  static_assert(kBQ * PLD <= kBK * KLD, "P must fit over the k tile");
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * HD;
  float* Ps = Ks;
  float* Vs = Ks + kBK * KLD;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int64_t q0 = (int64_t)qt * kBQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int64_t qi = q0 + r;
    Qs[i] = qi < Sq ? to_f32(qb[qi * qs.s + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // Live key tiles: those starting before the q tile ends (reference:
  // j * bk < (i + 1) * bq); every row sees key 0 in the first one.
  const int64_t kend = causal ? (q0 + kBQ < Sk ? q0 + kBQ : Sk) : Sk;
  for (int64_t k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's P.V is done with Ps and Vs
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int64_t kj = k0 + r;
      const bool in = kj < Sk;
      Ks[r * KLD + d] = in ? to_f32(kb[kj * ks.s + d]) : 0.f;
      Vs[i] = in ? to_f32(vb[kj * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * HD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KLD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    __syncthreads();  // every thread is done reading Ks before P overwrites it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int64_t qi = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kj = k0 + tx + 16 * j;
        if (kj >= Sk) {
          s[i][j] = -INFINITY;  // past the end: no weight at all
        } else if (causal && kj > qi) {
          s[i][j] = kNegInf;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[r * PLD + tx + 16 * j] = p;
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float safe = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) ob[qi * os.s + tx + 16 * j] = from_f32<T>(acc[i][j] / safe);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides qs, Strides ks, Strides vs, Strides os, int64_t B,
                   int64_t nq, int64_t group, int64_t Sq, int64_t Sk,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // Above 48 KB (hd 128) dynamic shared memory must be opted into, per
  // device; the call is cheap beside the launch.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)nq, (unsigned)B);
  flash_fwd<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os,
      (int)group, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements (batch, head,
// sequence) for q, k, v and out.  Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int64_t B, int64_t nq, int64_t nkv, int64_t Sq,
                        int64_t Sk, int64_t hd, int64_t dtype, int64_t q_sb,
                        int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
                        int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                        int64_t o_sb, int64_t o_sh, int64_t o_ss, float scale,
                        int64_t causal, void* stream) {
  if (nkv <= 0 || nq % nkv != 0 || Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss};
  const Strides vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  const int64_t group = nq / nkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int c = causal != 0;
#define REPRO_FA_LAUNCH(T, HD) \
  launch<T, HD>(q, k, v, o, qs, ks, vs, os, B, nq, group, Sq, Sk, scale, c, st)
  if (dtype == 0 && hd == 64) return REPRO_FA_LAUNCH(float, 64);
  if (dtype == 0 && hd == 128) return REPRO_FA_LAUNCH(float, 128);
  if (dtype == 1 && hd == 64) return REPRO_FA_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) return REPRO_FA_LAUNCH(__nv_bfloat16, 128);
#undef REPRO_FA_LAUNCH
  return cudaErrorInvalidValue;
}

}  // extern "C"
