// Flash decode (K3) for Hopper: one query token against a KV cache, as a
// split-key decode with float32 state.
//
// Replaces the Pallas TPU kernel `_kernel` / `flash_decode_bhsd` in
// src/repro/kernels/decode_attention.py (reached through `ops.flash_decode`).
// For q [B, nq, 1, hd] and caches k, v [B, nkv, S, hd] it computes
//
//   out[b, h] = softmax_{j <= pos}( (q[b, h] * scale) . k[b, h / g, j] ) v[b, h / g, j]
//
// with g = nq / nkv: keys j <= pos count (inclusive) and keys after pos are
// never read, the softmax runs online (m, l, acc in float32), the final
// divide is guarded by l > 0 (so pos < 0 gives zeros, as in the reference
// kernel), and the output is in q's type.  `pos` is a kernel argument.
//
// What bounds it on an H100 (SXM): bytes.  It must read each cache entry up
// to pos once (at B 4, nkv 8, hd 128, bf16, pos 600: 9.8 MB, 2.9 us at
// 3.35 TB/s) and does about g multiply-adds per byte, so it stays on the
// CUDA cores in float32 and the design is about keeping enough bytes in
// flight.
//
// Design.  The live keys [0, min(pos + 1, S)) are cut into `splits`
// chunks of `chunk` keys, which the wrapper picks from pos + 1 and the SM
// count so that the grid has at least about two blocks per SM (10 chunks of
// 64 keys, 320 blocks, at the shape above).  `decode_split` runs one block
// of 128 threads per (chunk, kv head, batch) for all the g query heads of
// that kv head (at most 1024 / hd of them; more heads take more blocks), so
// each cache byte is read from device memory once.  Its chunk streams
// through a two-stage ring of 32-key tiles of k and v, loaded by 16-byte
// `cp.async` in the cache's own type, the next tile in flight while this
// one is used.  Per tile, each warp owns one head at a time (a lane per
// key: a 16-byte vector dot product against q, scaled in float32 as the
// reference does, then warp max and sum), and each thread accumulates two
// neighbouring columns of P.V for up to 4 heads, one load of a value pair
// serving all of them.  The block writes its per-head
// partials (m, l, acc[hd], float32) to a scratch tensor the wrapper
// allocated; `decode_merge` then rescales and sums the chunks per
// (q head, batch) and writes the output in q's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // == decode_attention.NEG_INF
constexpr int kTK = 32;            // keys per tile: one per lane
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kOutPerThread = 8;   // (head, column) outputs of P.V per thread

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

// 16 bytes of a key row against the matching float32 q values.
__device__ __forceinline__ float dot16(const float* kp, const float* qv, float acc) {
  const float4 kk = *reinterpret_cast<const float4*>(kp);
  const float4 qq = *reinterpret_cast<const float4*>(qv);
  acc = fmaf(qq.x, kk.x, acc);
  acc = fmaf(qq.y, kk.y, acc);
  acc = fmaf(qq.z, kk.z, acc);
  return fmaf(qq.w, kk.w, acc);
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* kp, const float* qv, float acc) {
  const uint4 raw = *reinterpret_cast<const uint4*>(kp);
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 kf = __bfloat1622float2(k2[i]);
    acc = fmaf(qv[2 * i], kf.x, acc);
    acc = fmaf(qv[2 * i + 1], kf.y, acc);
  }
  return acc;
}

// Two neighbouring values of a row, as float32.
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Strides {  // in elements; the head dim is contiguous
  int64_t b, h, s;
};

template <typename T, int HD>
struct Tiles {
  static constexpr int kHeads = kOutPerThread * kThreads / HD;  // q heads per block
  static constexpr int kPairs = HD / 2;                         // column pairs
  static constexpr int kSlots = kThreads / kPairs;              // threads per pair
  static constexpr int kPerThread = kHeads / kSlots;            // heads per thread
  static constexpr int kVec = HD * (int)sizeof(T) / 16;         // 16-byte vectors per row
  static constexpr int kRow = HD * (int)sizeof(T) + 16;         // padded: conflict-free rows
  static constexpr int kStage = 2 * kTK * kRow;                 // k then v
  // two stages, then q [kHeads][HD], P [kHeads][kTK], m, l, alpha [kHeads]
  static constexpr size_t kBytes =
      2 * kStage + sizeof(float) * (kHeads * HD + kHeads * kTK + 3 * kHeads);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             float* __restrict__ part, Strides qs, Strides ks, Strides vs, int group,
             int64_t kend, int64_t chunk, float scale) {
  using L = Tiles<T, HD>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* Qs = reinterpret_cast<float*>(smem + 2 * L::kStage);
  float* Ps = Qs + L::kHeads * HD;
  float* Ms = Ps + L::kHeads * kTK;
  float* Ls = Ms + L::kHeads;
  float* As = Ls + L::kHeads;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x, splits = gridDim.x;
  const int hblocks = (group + L::kHeads - 1) / L::kHeads;
  const int hk = blockIdx.y / hblocks;
  const int h0 = (blockIdx.y % hblocks) * L::kHeads;  // within the group
  const int nh = min(L::kHeads, group - h0);
  const int b = blockIdx.z;
  const int nq = gridDim.y / hblocks * group;
  const int64_t lo = split * chunk;
  const int64_t hi = min(lo + chunk, kend);
  const int n_t = hi > lo ? (int)((hi - lo + kTK - 1) / kTK) : 0;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  auto load = [&](int t) {
    const int64_t k0 = lo + (int64_t)t * kTK;
    const int rows = (int)min((int64_t)kTK, hi - k0);
    uint8_t* st = smem + (t & 1) * L::kStage;
    for (int i = tid; i < 2 * rows * L::kVec; i += kThreads) {
      const int which = i / (rows * L::kVec);  // 0: k, 1: v
      const int r = (i / L::kVec) % rows, c = i % L::kVec;
      const T* src = which ? vb + (k0 + r) * vs.s : kb + (k0 + r) * ks.s;
      cp_async16(st + which * kTK * L::kRow + r * L::kRow + 16 * c,
                 src + c * (16 / (int)sizeof(T)));
    }
    cp_async_commit();
  };
  if (n_t > 0) load(0);
  if (n_t > 1) load(1);

  for (int i = tid; i < nh * HD; i += kThreads) {
    const int hh = i / HD, d = i % HD;
    Qs[i] = to_f32(q[b * qs.b + (int64_t)(hk * group + h0 + hh) * qs.h + d]) * scale;
  }
  for (int i = tid; i < nh; i += kThreads) {
    Ms[i] = kNegInf;
    Ls[i] = 0.f;
  }
  // P.V: this thread's two columns (2 dp, 2 dp + 1) of the heads hs,
  // hs + kSlots, ...: one load of a value pair serves all of them.
  const int dp = tid % L::kPairs, hs = tid / L::kPairs;
  float acc[L::kPerThread][2];
#pragma unroll
  for (int r = 0; r < L::kPerThread; ++r) acc[r][0] = acc[r][1] = 0.f;

  for (int t = 0; t < n_t; ++t) {
    if (t + 1 < n_t) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile has landed for every thread; q, m, l are set
    const int rows = (int)min((int64_t)kTK, hi - (lo + (int64_t)t * kTK));
    const uint8_t* Kt = smem + (t & 1) * L::kStage;
    const T* Vt = reinterpret_cast<const T*>(Kt + kTK * L::kRow);

    for (int hh = warp; hh < nh; hh += kWarps) {
      float x = -INFINITY;  // lanes past the chunk's last key: no weight
      if (lane < rows) {
        const T* kr = reinterpret_cast<const T*>(Kt + lane * L::kRow);
        const float* qh = Qs + hh * HD;
        float x2[2] = {0.f, 0.f};  // two chains: half the dependent latency
#pragma unroll
        for (int c = 0; c < L::kVec; ++c)
          x2[c % 2] = dot16(kr + c * (16 / (int)sizeof(T)), qh + c * (16 / (int)sizeof(T)),
                            x2[c % 2]);
        x = x2[0] + x2[1];
      }
      const float m_old = Ms[hh];
      float mx = x;
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(x - m_new);
      float sum = p;
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      Ps[hh * kTK + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[hh] = alpha;
        Ls[hh] = alpha * Ls[hh] + sum;
        Ms[hh] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < L::kPerThread; ++r) {
      const int hh = hs + L::kSlots * r;
      if (hh < nh) {
        acc[r][0] *= As[hh];
        acc[r][1] *= As[hh];
      }
    }
#pragma unroll 4
    for (int key = 0; key < rows; ++key) {
      const float2 vv = pair_f32(Vt + key * (L::kRow / (int)sizeof(T)) + 2 * dp);
#pragma unroll
      for (int r = 0; r < L::kPerThread; ++r) {
        const int hh = hs + L::kSlots * r;
        if (hh < nh) {
          const float p = Ps[hh * kTK + key];
          acc[r][0] = fmaf(p, vv.x, acc[r][0]);
          acc[r][1] = fmaf(p, vv.y, acc[r][1]);
        }
      }
    }
    __syncthreads();  // every thread is done with this stage
    if (t + 2 < n_t) load(t + 2);
  }

  // Partials [B, nq, splits, 2 + hd]: m, l, acc.
  auto slot = [&](int hh) {
    return part + (((int64_t)b * nq + hk * group + h0 + hh) * splits + split) * (HD + 2);
  };
  for (int i = tid; i < nh; i += kThreads) {
    slot(i)[0] = Ms[i];
    slot(i)[1] = Ls[i];
  }
#pragma unroll
  for (int r = 0; r < L::kPerThread; ++r) {
    const int hh = hs + L::kSlots * r;
    if (hh < nh) {
      slot(hh)[2 + 2 * dp] = acc[r][0];
      slot(hh)[3 + 2 * dp] = acc[r][1];
    }
  }
}

// One block of hd threads per (q head, batch): out = sum_s e^(m_s - M) acc_s
// / sum_s e^(m_s - M) l_s, with M the largest m_s.  The chunks' m and l
// are read in parallel into shared memory (2 x splits floats) first.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_merge(const float* __restrict__ part, T* __restrict__ o, Strides os, int splits) {
  extern __shared__ float ml[];  // m [splits], then l [splits]
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const float* p = part + ((int64_t)b * gridDim.x + h) * splits * (HD + 2);
  for (int s = d; s < splits; s += HD) {
    ml[s] = p[s * (HD + 2)];
    ml[splits + s] = p[s * (HD + 2) + 1];
  }
  __syncthreads();
  float M = kNegInf;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, ml[s]);
  float l = 0.f, acc = 0.f;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const float w = expf(ml[s] - M);
    l = fmaf(w, ml[splits + s], l);
    acc = fmaf(w, p[s * (HD + 2) + 2 + d], acc);
  }
  o[b * os.b + h * os.h + d] = from_f32<T>(acc / (l > 0.f ? l : 1.f));
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* part,
                   Strides qs, Strides ks, Strides vs, Strides os, int64_t B, int64_t nq,
                   int64_t nkv, int64_t kend, int64_t splits, int64_t chunk, float scale,
                   cudaStream_t stream) {
  using L = Tiles<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      decode_split<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const int64_t group = nq / nkv;
  const int64_t hblocks = (group + L::kHeads - 1) / L::kHeads;
  dim3 grid((unsigned)splits, (unsigned)(nkv * hblocks), (unsigned)B);
  decode_split<T, HD><<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), part, qs,
      ks, vs, (int)group, kend, chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge<T, HD><<<dim3((unsigned)nq, (unsigned)B), HD, 2 * splits * sizeof(float),
                         stream>>>(
      part, static_cast<T*>(o), os, (int)splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements (batch, head,
// sequence) for q, the k and v caches, and out; q and out have one
// position.  `part` is float32 scratch of [B, nq, splits, hd + 2]; the
// live keys [0, min(pos + 1, S)) go in chunks of `chunk`, `splits` of
// them.  Returns a cudaError_t.
int flash_decode_fwd(const void* q, const void* k, const void* v, void* o, void* part,
                     int64_t B, int64_t nq, int64_t nkv, int64_t S, int64_t hd,
                     int64_t dtype, int64_t q_sb, int64_t q_sh, int64_t k_sb,
                     int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                     int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t pos,
                     int64_t splits, int64_t chunk, float scale, void* stream) {
  if (nkv <= 0 || nq % nkv != 0 || S <= 0 || splits <= 0 || chunk <= 0)
    return cudaErrorInvalidValue;
  const int64_t kend = pos < 0 ? 0 : (pos < S - 1 ? pos + 1 : S);
  if (splits * chunk < kend) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, 0}, ks{k_sb, k_sh, k_ss};
  const Strides vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
#define REPRO_FD_LAUNCH(T, HD) \
  launch<T, HD>(q, k, v, o, pt, qs, ks, vs, os, B, nq, nkv, kend, splits, chunk, scale, st)
  if (dtype == 0 && hd == 64) return REPRO_FD_LAUNCH(float, 64);
  if (dtype == 0 && hd == 128) return REPRO_FD_LAUNCH(float, 128);
  if (dtype == 1 && hd == 64) return REPRO_FD_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) return REPRO_FD_LAUNCH(__nv_bfloat16, 128);
#undef REPRO_FD_LAUNCH
  return cudaErrorInvalidValue;
}

}  // extern "C"
