// Time-slot planning scan (K1) for Hopper, float64, exact on any input.
//
// Replaces the Pallas TPU kernel `_build_pallas` in
// src/repro/kernels/ts_plan_device.py (reached through `pallas_scan` from
// `ts_plan.plan_scan_pallas`).  For each candidate row k it computes, over
// the W slots of its window:
//
//   resid[w] = 1 - max_l booked[k, l, w]
//   bw[w]    = resid[w] * cap[k]            (then min with bandwidth_cap)
//   cum[w]   = bw[0]*secs[0] + ... + bw[w]*secs[w]   (summed in order)
//   hit      = #{w : cum[w] < size[k] - EPS}
//
// and, for the wave form, the plan end of `_extract_end`
// (src/repro/kernels/ts_plan.py).  Three C entry points differ only in how
// `booked` and `secs` are gathered, and share one kernel template:
//
//   window   booked[k,l,w] = M[pad[k,l], off[k] + w]; secs = first_secs[k]
//            at w = 0 and dur elsewhere; plus the plan end (wave_scan)
//   columns  booked[k,l,j] = M[pad[k,l], cols[k,j]]; secs given (col_scan)
//   dense    booked given as [n, L, W]; secs given; optional bandwidth cap
//            (plan_scan)
//
// Exactness.  The TPU kernel computed in float32 with a Hillis-Steele
// prefix sum, which agrees with the numpy reference only on float64-safe
// inputs (values exact at both precisions, where summation order does not
// matter).  This kernel reproduces numpy bit for bit on any input: every
// value is float64, the product bw*secs is rounded before it is added
// (numpy materialises it), and the prefix sum is one __dadd_rn at a time
// in slot order.  The file is built with --fmad=false and uses the _rn
// intrinsics, so no multiply-add is ever contracted.  max/min follow
// numpy's NaN propagation.
//
// What bounds it on an H100 (SXM, 3.35 TB/s): the bytes moved, n*L*W*8
// gathered from the mirror plus 3*n*W*8 written (resid, bw, cum), and the
// dependent chain of W float64 adds, which no reordering may shorten: each
// add waits for the one before.  On the reroute engine's launches (a few
// rows of W = 64..1024) the chain and the launch itself are all there is.
//
// Design.  Each row is served by TPR threads (a warp or more, 32..256) and
// a block holds RPB rows, chosen so that the grid still has a block per SM
// where the rows allow (few rows: one row per block, spread over the
// SMs).  Rows of up to 256 slots take one slot a thread; longer rows four,
// in tiles of TILE = 4 * TPR = 1 024 slots, the accumulator carried from
// tile to tile.  Per tile:
//   1. gather: each thread loads its slots' columns (or secs) and the
//      row's mirror-row indices, eight links at a time into registers,
//      then all eight links' booked cells at once, read along the mirror
//      row (window, dense) or along `cols` (columns): two round trips to
//      memory for L <= 8.  It writes resid and bw (coalesced) and stages
//      d = bw * secs in shared memory;
//   2. chain: one lane runs the in-order sum over the staged tile, its
//      shared-memory loads issued a group of 8 ahead of the adds, and
//      writes each prefix back in place;
//   3. write-back: the row's threads store cum (coalesced) and count hit.
// The window form extracts the plan end in the same launch, reading the
// last tile's cum and bw from shared memory.  What is left is mostly the
// launch itself: at the reroute engine's usual launch (n 9, L 6, W 64) an
// empty launch takes about two thirds of the time.  Left for later:
// overlapping a tile's gather with the previous tile's chain (rows longer
// than a tile are rare on the paths), and the host's per-call copies and
// mirror syncs around the launch, which cost the paths far more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kEps = 1e-9;  // == ts_plan.EPS
constexpr int kMaxThreads = 256;
constexpr int kPadSlots = 8;  // the chain reads a group of 8 ahead
constexpr int kLinks = 8;     // mirror rows gathered per round trip

enum Gather { kWindow = 0, kColumns = 1, kDense = 2 };

struct ScanArgs {
  const double* __restrict__ src;         // window/columns: mirror [rows, ld]; dense: [n, L, W]
  int64_t ld;                             // mirror row stride (window/columns)
  const int64_t* __restrict__ pad;        // [n, L] mirror rows (window/columns)
  const int64_t* __restrict__ off;        // [n] first mirror column (window)
  const int64_t* __restrict__ cols;       // [n, W] mirror columns (columns)
  const double* __restrict__ secs;        // [n, W] usable seconds (columns/dense)
  const double* __restrict__ first_secs;  // [n] seconds of the first slot (window)
  const double* __restrict__ caps;        // [n] bottleneck capacity
  const double* __restrict__ sizes;       // [n] bytes to move
  const int64_t* __restrict__ szslot;     // [n] absolute scan-base slot (window)
  const double* __restrict__ t0;          // [n] earliest start (window)
  double dur;                             // slot duration (window)
  double bw_cap;                          // bandwidth cap (dense, when has_cap)
  int has_cap;
  int64_t n, L, W;
  double* __restrict__ resid;             // [n, W]
  double* __restrict__ bw;                // [n, W]
  double* __restrict__ cum;               // [n, W]
  int64_t* __restrict__ hit;              // [n]
  double* __restrict__ end;               // [n] (window)
};

// np.maximum / np.minimum: the first argument on ties, NaN propagates.
__device__ __forceinline__ double np_max(double a, double b) {
  return (a >= b || a != a) ? a : b;
}
__device__ __forceinline__ double np_min(double a, double b) {
  return (a <= b || a != a) ? a : b;
}

// The in-order sum over s[j0, cnt), carried in acc, each prefix written
// back in place.  Loads run a group of 8 ahead of the adds (s holds
// kPadSlots readable slots past the tile); j0 is even, s 16-byte aligned.
__device__ __forceinline__ double chain(double* s, int j0, int cnt, double acc) {
  int j = j0;
  if (j + 8 <= cnt) {
    double2 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = reinterpret_cast<const double2*>(s + j)[i];
#pragma unroll 1
    for (; j + 8 <= cnt; j += 8) {
      double2 nx[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) nx[i] = reinterpret_cast<const double2*>(s + j + 8)[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double a0 = __dadd_rn(acc, v[i].x);
        acc = __dadd_rn(a0, v[i].y);
        reinterpret_cast<double2*>(s + j)[i] = make_double2(a0, acc);
        v[i] = nx[i];
      }
    }
  }
  for (; j < cnt; ++j) {
    acc = __dadd_rn(acc, s[j]);
    s[j] = acc;
  }
  return acc;
}

template <int G, int kSlotsPerThread>
__global__ void __launch_bounds__(kMaxThreads)
ts_plan_scan_kernel(const ScanArgs a, int tpr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rpb = blockDim.x / tpr;
  const int tile = kSlotsPerThread * tpr;
  const int row = threadIdx.x / tpr;  // this thread's row in the block
  const int tr = threadIdx.x % tpr;   // its place among the row's threads
  const int64_t k = (int64_t)blockIdx.x * rpb + row;
  const bool valid = k < a.n;
  const int64_t W = a.W;
  const int64_t L = a.L;
  double* sd = reinterpret_cast<double*>(smem_raw) + row * (tile + kPadSlots);
  double* sbw = reinterpret_cast<double*>(smem_raw) + (rpb + row) * (tile + kPadSlots);
  int* shit = reinterpret_cast<int*>(reinterpret_cast<double*>(smem_raw) +
                                     2 * rpb * (tile + kPadSlots));
  if (tr == 0) shit[row] = 0;

  const int64_t kk = valid ? k : 0;
  const double cap = a.caps[kk];
  const double size = a.sizes[kk];
  const double target = __dsub_rn(size, kEps);
  const int64_t off = (G == kWindow) ? a.off[kk] : 0;
  const double first = (G == kWindow) ? a.first_secs[kk] : 0.0;
  const double t0 = (G == kWindow) ? a.t0[kk] : 0.0;
  const int64_t szslot = (G == kWindow) ? a.szslot[kk] : 0;
  double* resid = a.resid + kk * W;
  double* bwo = a.bw + kk * W;
  double* cum = a.cum + kk * W;

  double acc = 0.0;  // the chain lane's running sum, carried across tiles
  int hits = 0;      // this thread's slots with cum < size - EPS
  int64_t w0 = 0;
  for (; w0 < W; w0 += tile) {
    const int cnt = (int)((W - w0 < tile) ? (W - w0) : tile);
    // 1. gather, residue, bandwidth, d = bw * secs.  The row's mirror rows
    // are read kLinks at a time into registers, so that one round trip
    // brings the indices and a second all kLinks x 4 booked cells.
    if (valid) {
      double m[kSlotsPerThread], sec[kSlotsPerThread];
      int64_t col[kSlotsPerThread];
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) {
        const int j = tr + i * tpr;
        const bool in = j < cnt;
        col[i] = (G == kColumns && in) ? a.cols[kk * W + w0 + j] : 0;
        sec[i] = (G != kWindow && in) ? a.secs[kk * W + w0 + j] : 0.0;
        m[i] = 0.0;
      }
      for (int64_t l0 = 0; l0 < L; l0 += kLinks) {
        const double* src[kLinks];
#pragma unroll
        for (int q = 0; q < kLinks; ++q) {
          const int64_t l = (l0 + q < L) ? l0 + q : l0;
          if (G == kWindow) {
            src[q] = a.src + a.pad[kk * L + l] * a.ld + off + w0;
          } else if (G == kColumns) {
            src[q] = a.src + a.pad[kk * L + l] * a.ld;
          } else {
            src[q] = a.src + (kk * L + l) * W + w0;
          }
        }
        double v[kLinks][kSlotsPerThread];  // all loads issued before any is used
#pragma unroll
        for (int q = 0; q < kLinks; ++q) {
#pragma unroll
          for (int i = 0; i < kSlotsPerThread; ++i) {
            const int j = tr + i * tpr;
            v[q][i] = (j < cnt && l0 + q < L) ? src[q][(G == kColumns) ? col[i] : (int64_t)j]
                                              : 0.0;
          }
        }
#pragma unroll
        for (int q = 0; q < kLinks; ++q) {
#pragma unroll
          for (int i = 0; i < kSlotsPerThread; ++i) {
            if (l0 + q < L) m[i] = (l0 + q == 0) ? v[q][i] : np_max(m[i], v[q][i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) {
        const int j = tr + i * tpr;
        if (j < cnt) {
          const int64_t w = w0 + j;
          const double r = __dsub_rn(1.0, m[i]);
          double b = __dmul_rn(r, cap);
          if (G == kDense && a.has_cap) b = np_min(b, a.bw_cap);
          const double s = (G == kWindow) ? ((w == 0) ? first : a.dur) : sec[i];
          resid[w] = r;
          bwo[w] = b;
          if (G == kWindow) sbw[j] = b;
          sd[j] = __dmul_rn(b, s);
        }
      }
    }
    __syncthreads();
    // 2. the in-order prefix sum (numpy's add.accumulate: out[0] is in[0],
    // then one rounded add per slot), on one lane per row.
    if (valid && tr == 0) {
      int j0 = 0;
      if (w0 == 0) {
        acc = sd[0];
        if (cnt > 1) {
          acc = __dadd_rn(acc, sd[1]);
          sd[1] = acc;
        }
        j0 = 2;
      }
      acc = chain(sd, j0, cnt, acc);
    }
    __syncthreads();
    // 3. write cum back and count hit.
    if (valid) {
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) {
        const int j = tr + i * tpr;
        if (j < cnt) {
          const double c = sd[j];
          cum[w0 + j] = c;
          hits += (c < target) ? 1 : 0;
        }
      }
    }
    if (w0 + tile < W) __syncthreads();  // the next tile overwrites sd
  }
  w0 -= tile;  // the last tile's first slot

  // hit: a warp lies within one row (tpr is a multiple of 32).
  hits = __reduce_add_sync(0xffffffffu, hits);
  if ((threadIdx.x & 31) == 0 && valid) atomicAdd(&shit[row], hits);
  __syncthreads();
  if (!valid || tr != 0) return;
  const int64_t h = shit[row];
  a.hit[k] = h;

  if (G == kWindow) {
    // _extract_end: end = t_in + (size - before) / bw[min(hit, W-1)];
    // unfit rows (hit == W) -> inf; empty transfers (size <= 0) -> t0.
    const int64_t hidx = (h < W - 1) ? h : W - 1;
    const double before =
        (h > 0) ? ((h - 1 >= w0) ? sd[h - 1 - w0] : cum[h - 1]) : 0.0;
    const double b = (hidx >= w0) ? sbw[hidx - w0] : bwo[hidx];
    const double t_in =
        np_max(t0, __dmul_rn((double)(szslot + h), a.dur));
    double e = __dadd_rn(t_in, __ddiv_rn(__dsub_rn(size, before), b));
    if (!(h < W)) e = __longlong_as_double(0x7ff0000000000000LL);  // +inf
    if (size <= 0.0) e = t0;
    a.end[k] = e;
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        count <= 0)
      count = 132;
  }
  return count;
}

template <int G, int kSlotsPerThread>
int launch_with(const ScanArgs& a, void* stream) {
  // Threads per row: a power of two covering W at kSlotsPerThread slots a
  // thread, 32..256.  Rows per block: as many as fit in 256 threads while
  // the grid keeps a block per SM.
  int tpr = 32;
  while (tpr < kMaxThreads && (int64_t)tpr * kSlotsPerThread < a.W) tpr *= 2;
  int rpb = 1;
  while (rpb * 2 * tpr <= kMaxThreads && (int64_t)rpb * 2 * sm_count() <= a.n) rpb *= 2;
  const int tile = kSlotsPerThread * tpr;
  const size_t smem = (size_t)2 * rpb * (tile + kPadSlots) * sizeof(double) +
                      (size_t)rpb * sizeof(int);
  const int64_t blocks = (a.n + rpb - 1) / rpb;
  ts_plan_scan_kernel<G, kSlotsPerThread><<<(unsigned int)blocks, rpb * tpr, smem,
                                            (cudaStream_t)stream>>>(a, tpr);
  return (int)cudaGetLastError();
}

// Rows of up to 256 slots: one slot a thread (the most loads in flight per
// slot); longer rows: four a thread, in tiles of 1 024.
template <int G>
int launch(const ScanArgs& a, void* stream) {
  if (a.n <= 0 || a.W <= 0 || a.L <= 0) return (int)cudaErrorInvalidValue;
  return a.W <= kMaxThreads ? launch_with<G, 1>(a, stream) : launch_with<G, 4>(a, stream);
}

// Measurement probes (chip_smoke.py; not part of the scan's interface).
// dadd_chain_probe: one thread runs `iters` dependent __dadd_rn and writes
// the SM cycles and the globaltimer nanoseconds they took -- the latency of
// the in-order sum's chain, per add.  empty_probe: the floor of any launch.
__global__ void dadd_chain_probe(const double* in, double* out, int64_t* t,
                                 int64_t iters) {
  double acc = in[0];
  const double x = in[1];
  uint64_t g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
#pragma unroll 1
  for (int64_t i = 0; i < iters; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = __dadd_rn(acc, x);
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[0] = acc;
  t[0] = (int64_t)(c1 - c0);
  t[1] = (int64_t)(g1 - g0);
}

__global__ void empty_probe() {}

}  // namespace

extern "C" {

int ts_plan_window(const double* M, int64_t ld, const int64_t* pad,
                   const int64_t* off, const double* caps,
                   const double* first_secs, const double* sizes,
                   const int64_t* szslot, const double* t0, double dur,
                   int64_t n, int64_t L, int64_t W, double* resid, double* bw,
                   double* cum, int64_t* hit, double* end, void* stream) {
  ScanArgs a = {};
  a.src = M;
  a.ld = ld;
  a.pad = pad;
  a.off = off;
  a.caps = caps;
  a.first_secs = first_secs;
  a.sizes = sizes;
  a.szslot = szslot;
  a.t0 = t0;
  a.dur = dur;
  a.n = n;
  a.L = L;
  a.W = W;
  a.resid = resid;
  a.bw = bw;
  a.cum = cum;
  a.hit = hit;
  a.end = end;
  return launch<kWindow>(a, stream);
}

int ts_plan_columns(const double* M, int64_t ld, const int64_t* pad,
                    const int64_t* cols, const double* caps,
                    const double* secs, const double* sizes, int64_t n,
                    int64_t L, int64_t W, double* resid, double* bw,
                    double* cum, int64_t* hit, void* stream) {
  ScanArgs a = {};
  a.src = M;
  a.ld = ld;
  a.pad = pad;
  a.cols = cols;
  a.caps = caps;
  a.secs = secs;
  a.sizes = sizes;
  a.n = n;
  a.L = L;
  a.W = W;
  a.resid = resid;
  a.bw = bw;
  a.cum = cum;
  a.hit = hit;
  return launch<kColumns>(a, stream);
}

int ts_plan_dense(const double* booked, const double* caps, const double* secs,
                  const double* sizes, double bw_cap, int has_cap, int64_t n,
                  int64_t L, int64_t W, double* resid, double* bw, double* cum,
                  int64_t* hit, void* stream) {
  ScanArgs a = {};
  a.src = booked;
  a.caps = caps;
  a.secs = secs;
  a.sizes = sizes;
  a.bw_cap = bw_cap;
  a.has_cap = has_cap;
  a.n = n;
  a.L = L;
  a.W = W;
  a.resid = resid;
  a.bw = bw;
  a.cum = cum;
  a.hit = hit;
  return launch<kDense>(a, stream);
}

int ts_plan_probe_dadd(const double* in, double* out, int64_t* t, int64_t iters,
                       void* stream) {
  if (iters <= 0 || iters % 8) return (int)cudaErrorInvalidValue;
  dadd_chain_probe<<<1, 1, 0, (cudaStream_t)stream>>>(in, out, t, iters);
  return (int)cudaGetLastError();
}

int ts_plan_probe_empty(void* stream) {
  empty_probe<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
