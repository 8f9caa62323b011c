// Causal GQA flash attention (K2) for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` / `flash_attention_bhsd` in
// src/repro/kernels/flash_attention.py (reached through `ops.flash_attention`
// from `models/attention.py::full_attention` when attn_impl == "pallas").
// For q [B, nq, Sq, hd] and k, v [B, nkv, Sk, hd] it computes
//
//   out[b, h, i] = softmax_j( scale * q[b, h, i] . k[b, h / g, j] ) v[b, h / g, j]
//
// with g = nq / nkv, keys j <= i only when causal, an online softmax over
// key tiles (m, l, acc in float32), keys past Sk given no weight (-inf),
// keys above the diagonal -1e30 as in the reference, the final divide
// guarded by l > 0, and the output in q's type.
//
// What bounds it on an H100 (SXM): at the serving path's prefill shape
// (B 1, S 512, nq 32, nkv 8, hd 128, bf16) the bytes (q, k, v, out: 10.5 MB,
// 3.1 us at 3.35 TB/s), the causal FLOPs (2.2 GFLOP, 2.2 us at the bf16
// tensor-core peak) just behind.  Only the tensor cores come near either.
//
// bfloat16 (the serve path): tensor cores, fed by TMA.  One block of 160
// threads per (q head, 64-row q tile, batch), the longest causal rows
// launched first: 8 q tiles x 32 heads = 256 blocks at the prefill shape,
// two per SM, so the grid fills the 132 SMs at once and the 4 heads of a
// kv group re-read its k and v from L2.  Warp 4 is the producer: one lane
// loads the q tile once and then each 64-key tile of k and v by TMA (4-D
// tensor maps built on the host from the views' own strides; the ragged
// last tile is zero filled) into a ring of two stages guarded by
// full/empty mbarriers, so the next tile's loads overlap this tile's
// products.  Warps 0-3 are one consumer warpgroup: S = Q.K^T by `wgmma`
// (m64n64k16, both operands in shared memory, 128-byte swizzle as TMA
// wrote them); the online softmax on the accumulator fragment's own rows;
// then O += P.V by `wgmma` (m64n{hd}k16) with P from registers and V read
// transposed from shared memory.  Tiles wholly above the diagonal are
// never loaded; only the diagonal and ragged tiles are masked.
//
// With the products on the tensor cores, the softmax is the longest part
// of a tile, so it is written for latency: the scale enters after the
// product (bf16 products are exact in float32) together with the shift,
// in one fma per score, the row max is kept in the scaled log2 domain,
// exponentials are one `ex2.approx` each, and row maxima and sums go
// pairwise (4 deep, not 16), then across the quad by shuffles (with
// linear chains the softmax took most of each tile).  Issuing the next tile's
// S before this tile's softmax (FlashAttention-3's order) was slower
// here: ptxas serialises the products when the softmax reads scores while
// P.V is in flight.  Design decision: P enters the second product rounded
// to bf16, as FlashAttention does on this card; the scores, m, l and O
// stay float32, and l sums the unrounded P.
//
// float32: the exactness path, held to atol 2e-5 by the tests, which a TF32
// product would miss.  It keeps the first design on the CUDA cores: one
// block of 256 threads per (64-row q tile, q head, batch); q (scaled in
// float32 before the dot, as the reference does), k and v tiles staged in
// shared memory; each thread owns a 4 x 4 block of scores and 4 rows of
// the accumulator.  The serve path does not run it.
//
// Inputs may be strided in batch, head and sequence (the head dim
// contiguous); the bf16 path needs 16-byte aligned bases and strides for
// TMA, which the wrapper checks.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // == flash_attention.NEG_INF

struct Strides {  // in elements; the head dim is contiguous
  int64_t b, h, s;
};

// ---------------------------------------------------------------------------
// float32: CUDA cores.

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 256;

template <int HD>
constexpr size_t smem_bytes_f32() {
  // Qs [kBQ][HD] + Ks [kBK][HD + 1] (reused as Ps [kBQ][kBK + 1]) + Vs [kBK][HD]
  return sizeof(float) * (kBQ * HD + kBK * (HD + 1) + kBK * HD);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Strides qs,
              Strides ks, Strides vs, Strides os, int group, int64_t Sq,
              int64_t Sk, float scale, int causal) {
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
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int64_t qi = q0 + r;
    Qs[i] = qi < Sq ? qb[qi * qs.s + d] * scale : 0.f;
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
      Ks[r * KLD + d] = in ? kb[kj * ks.s + d] : 0.f;
      Vs[i] = in ? vb[kj * vs.s + d] : 0.f;
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
    for (int j = 0; j < NJ; ++j) ob[qi * os.s + tx + 16 * j] = acc[i][j] / safe;
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       Strides qs, Strides ks, Strides vs, Strides os, int64_t B,
                       int64_t nq, int64_t group, int64_t Sq, int64_t Sk,
                       float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_f32<HD>();
  // Above 48 KB (hd 128) dynamic shared memory must be opted into, per
  // device; the call is cheap beside the launch.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)nq, (unsigned)B);
  flash_fwd_f32<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os,
      (int)group, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma fed by TMA.

constexpr int kTile = 64;                      // q rows and keys per tile
constexpr int kStages = 2;                     // k/v ring depth
constexpr int kConsumers = 128;                // one warpgroup
constexpr int kThreadsTC = kConsumers + 32;    // + one producer warp
constexpr uint32_t kChunk = kTile * 128;       // [64 rows][64 bf16], 8 KB
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
constexpr size_t smem_bytes_tc() {
  // q, then kStages k tiles, then kStages v tiles, each HD / 64 chunks;
  // 1 KB of slack to align the swizzle atoms; the mbarriers.
  return (size_t)(1 + 2 * kStages) * (HD / 64) * kChunk + 1024 + 8 * (1 + 2 * kStages);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box [1][1][64 rows][64 columns] of a 4-D tensor map (columns, rows,
// heads, batch) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.  Every 8-row swizzle atom
// (1 KB) sits on a 1 KB boundary, so the base offset is 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&p);
}

// exp2 on the special-function unit (one instruction; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one key tile's raw scores sc (a consumer thread's
// accumulator fragment: rows r0 and r0 + 8), in place: masked entries are
// set first (keys past Sk -inf, keys above the diagonal -1e30; only the
// ragged and diagonal tiles have any), the row max m is kept in the scaled
// log2 domain and the scale enters with the shift in one fma.  Maxima and
// sums go pairwise, four deep instead of sixteen.  sc ends as P; alpha
// rescales the accumulator; l sums this thread's columns only.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int q0, int r0,
                                             int col, int Sk, int causal, float scale_log2) {
  if (k0 + kTile > Sk || (causal && k0 + kTile - 1 > q0)) {  // q0: the q tile's first row
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int kj = k0 + 8 * (e / 4) + col + e % 2, qi = r0 + 8 * ((e / 2) % 2);
      if (kj >= Sk) {
        sc[e] = -INFINITY;  // past the end: no weight at all
      } else if (causal && kj > qi) {
        sc[e] = kNegInf;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t[8];  // row i's 16 entries are sc[4n + 2i + j], n < 8, j < 2
#pragma unroll
    for (int n = 0; n < 8; ++n) t[n] = fmaxf(sc[4 * n + 2 * i], sc[4 * n + 2 * i + 1]);
#pragma unroll
    for (int w = 4; w >= 1; w /= 2)
#pragma unroll
      for (int n = 0; n < w; ++n) t[n] = fmaxf(t[n], t[n + w]);
    float mx = fmaxf(t[0], __shfl_xor_sync(0xffffffffu, t[0], 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx * scale_log2);
    alpha[i] = ex2(m[i] - m_new);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float& x0 = sc[4 * n + 2 * i];
      float& x1 = sc[4 * n + 2 * i + 1];
      x0 = ex2(fmaf(x0, scale_log2, -m_new));
      x1 = ex2(fmaf(x1, scale_log2, -m_new));
      t[n] = x0 + x1;
    }
#pragma unroll
    for (int w = 4; w >= 1; w /= 2)
#pragma unroll
      for (int n = 0; n < w; ++n) t[n] += t[n + w];
    l[i] = alpha[i] * l[i] + t[0];
    m[i] = m_new;
  }
}

// P as the bf16 A fragments of the four m64k16 steps of P.V.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4][4], const float (&sc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// Accumulator fragment of m64nN (f32): thread t of the warpgroup holds
// rows r = 16 (t / 32) + (t % 32) / 4 and r + 8, and of each 8-column
// block n the columns 8n + 2 (t % 4) and its neighbour:
//   d[4n + 2i + j] = D[r + 8i][8n + 2 (t % 4) + j].
// Two neighbouring blocks, converted to bf16, are exactly the register
// A fragment of one m64k16 step, so P never leaves the registers.
template <int HD>
__global__ void __launch_bounds__(kThreadsTC, 2)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
             Strides os, int group, int Sq, int Sk, float scale_log2, int causal) {
  constexpr int NC = HD / 64;  // 64-column chunks of a tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK0 = sQ + NC * kChunk;
  const uint32_t sV0 = sK0 + kStages * NC * kChunk;
  const uint32_t qbar = sV0 + kStages * NC * kChunk;
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest rows first
  const int b = blockIdx.z;
  const int hk = h / group;
  // Live key tiles: those starting before the q tile ends.
  const int kend = causal ? min(q0 + kTile, Sk) : Sk;
  const int n_kt = (kend + kTile - 1) / kTile;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp
    if (tid == kConsumers) {
      mbar_expect_tx(qbar, NC * kChunk);
      for (int c = 0; c < NC; ++c) tma_load(sQ + c * kChunk, &tq, 64 * c, q0, h, b, qbar);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty0 + 8 * s, ((t / kStages) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * NC * kChunk);
        for (int c = 0; c < NC; ++c) {
          tma_load(sK0 + (s * NC + c) * kChunk, &tk, 64 * c, t * kTile, hk, b, full);
          tma_load(sV0 + (s * NC + c) * kChunk, &tv, 64 * c, t * kTile, hk, b, full);
        }
      }
    }
    return;
  }

  // The consumer warpgroup.
  const int warp = tid / 32, lane = tid % 32;
  const int row = q0 + 16 * warp + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);             // within each 8-column block
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  // m: the row max in the scaled log2 domain; l: this thread's columns only.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_kt; ++t) {
    const int s = t % kStages;
    mbar_wait(full0 + 8 * s, (t / kStages) & 1);
    const uint32_t sK = sK0 + s * NC * kChunk, sV = sV0 + s * NC * kChunk;

    // S = Q.K^T over hd in steps of 16 (32 bytes within a 128-byte row).
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kChunk + (kk % 4) * 32;
      wgmma_ss_n64(sc, sw128_desc(sQ + off, 16, 1024), sw128_desc(sK + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    float alpha[2];
    softmax_tile(sc, m, l, alpha, t * kTile, q0, row, col, Sk, causal, scale_log2);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * n + 2 * i] *= alpha[i];
        acc[4 * n + 2 * i + 1] *= alpha[i];
      }

    // O += P.V over the tile's keys in steps of 16 (16 rows of 128 bytes).
    uint32_t pa[4][4];
    pack_p(pa, sc);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, pa[kk], sw128_desc(sV + kk * 2048, kChunk, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty0 + 8 * s);  // this tile's k and v may be overwritten
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int qi = row + 8 * i;
    if (qi >= Sq) continue;
    const float inv = 1.f / (li > 0.f ? li : 1.f);
    __nv_bfloat16* orow = o + b * os.b + h * os.h + (int64_t)qi * os.s + col;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, fetched once through the runtime (no
// link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// [B, H, S, hd] bf16 view with strides `st` (elements) as a 4-D tensor map
// (hd, S, H, B) of 64 x 64 boxes, 128-byte swizzle, out of bounds read as 0.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t H, int64_t S,
                     int64_t hd, Strides st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)kTile, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, Strides qs,
                      Strides ks, Strides vs, Strides os, int64_t B, int64_t nq, int64_t nkv,
                      int64_t Sq, int64_t Sk, float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, B, nq, Sq, HD, qs);
  if (err == cudaSuccess) err = make_map(&tk, k, B, nkv, Sk, HD, ks);
  if (err == cudaSuccess) err = make_map(&tv, v, B, nkv, Sk, HD, vs);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = smem_bytes_tc<HD>();
  err = cudaFuncSetAttribute(flash_fwd_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)nq, (unsigned)((Sq + kTile - 1) / kTile), (unsigned)B);
  flash_fwd_tc<HD><<<grid, kThreadsTC, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), os, (int)(nq / nkv), (int)Sq, (int)Sk,
      scale * kLog2e, causal);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int c = causal != 0;
  if (dtype == 0 && hd == 64)
    return launch_f32<64>(q, k, v, o, qs, ks, vs, os, B, nq, nq / nkv, Sq, Sk, scale, c, st);
  if (dtype == 0 && hd == 128)
    return launch_f32<128>(q, k, v, o, qs, ks, vs, os, B, nq, nq / nkv, Sq, Sk, scale, c, st);
  if (dtype == 1 && hd == 64)
    return launch_tc<64>(q, k, v, o, qs, ks, vs, os, B, nq, nkv, Sq, Sk, scale, c, st);
  if (dtype == 1 && hd == 128)
    return launch_tc<128>(q, k, v, o, qs, ks, vs, os, B, nq, nkv, Sq, Sk, scale, c, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
