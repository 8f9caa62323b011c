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
// dependent chain of W float64 adds of Phase B, which no reordering may
// shorten.  Design: one block per candidate row.  Phase A: the block's
// threads stride over the slots, reading along the mirror row (coalesced),
// and stage d = bw*secs in the cum output.  Phase B: thread 0 runs the
// in-order sum over the staged row, counts hit, and extracts the plan end.
// At the wavefront's shapes (W = 16..4096) the rows are short and a launch
// covers ~10^3 rows, so the chain is short beside the launch itself.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kEps = 1e-9;  // == ts_plan.EPS

enum Gather { kWindow = 0, kColumns = 1, kDense = 2 };

struct ScanArgs {
  const double* src;         // window/columns: mirror [rows, ld]; dense: [n, L, W]
  int64_t ld;                // mirror row stride (window/columns)
  const int64_t* pad;        // [n, L] mirror rows (window/columns)
  const int64_t* off;        // [n] first mirror column (window)
  const int64_t* cols;       // [n, W] mirror columns (columns)
  const double* secs;        // [n, W] usable seconds (columns/dense)
  const double* first_secs;  // [n] seconds of the first slot (window)
  const double* caps;        // [n] bottleneck capacity
  const double* sizes;       // [n] bytes to move
  const int64_t* szslot;     // [n] absolute scan-base slot (window)
  const double* t0;          // [n] earliest start (window)
  double dur;                // slot duration (window)
  double bw_cap;             // bandwidth cap (dense, when has_cap)
  int has_cap;
  int64_t n, L, W;
  double* resid;             // [n, W]
  double* bw;                // [n, W]
  double* cum;               // [n, W]
  int64_t* hit;              // [n]
  double* end;               // [n] (window)
};

// np.maximum / np.minimum: the first argument on ties, NaN propagates.
__device__ __forceinline__ double np_max(double a, double b) {
  return (a >= b || a != a) ? a : b;
}
__device__ __forceinline__ double np_min(double a, double b) {
  return (a <= b || a != a) ? a : b;
}

template <int G>
__global__ void ts_plan_scan_kernel(ScanArgs a) {
  const int64_t k = blockIdx.x;
  const int64_t W = a.W;
  const int64_t L = a.L;
  const double cap = a.caps[k];
  double* resid = a.resid + k * W;
  double* bw = a.bw + k * W;
  double* cum = a.cum + k * W;

  // Phase A: gather, residue, bandwidth, d = bw * secs (staged in cum).
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x) {
    double m = 0.0;
    for (int64_t l = 0; l < L; ++l) {
      double v;
      if (G == kWindow) {
        v = a.src[a.pad[k * L + l] * a.ld + a.off[k] + w];
      } else if (G == kColumns) {
        v = a.src[a.pad[k * L + l] * a.ld + a.cols[k * W + w]];
      } else {
        v = a.src[(k * L + l) * W + w];
      }
      m = (l == 0) ? v : np_max(m, v);
    }
    const double r = __dsub_rn(1.0, m);
    double b = __dmul_rn(r, cap);
    if (G == kDense && a.has_cap) b = np_min(b, a.bw_cap);
    double s;
    if (G == kWindow) {
      s = (w == 0) ? a.first_secs[k] : a.dur;
    } else {
      s = a.secs[k * W + w];
    }
    resid[w] = r;
    bw[w] = b;
    cum[w] = __dmul_rn(b, s);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  // Phase B: the in-order prefix sum (numpy's add.accumulate: out[0] is
  // in[0], then one rounded add per slot) and the hit count.
  const double size = a.sizes[k];
  const double target = __dsub_rn(size, kEps);
  double acc = cum[0];
  int64_t h = (acc < target) ? 1 : 0;
#pragma unroll 8
  for (int64_t w = 1; w < W; ++w) {
    acc = __dadd_rn(acc, cum[w]);
    cum[w] = acc;
    h += (acc < target) ? 1 : 0;
  }
  a.hit[k] = h;

  if (G == kWindow) {
    // _extract_end: end = t_in + (size - before) / bw[min(hit, W-1)];
    // unfit rows (hit == W) -> inf; empty transfers (size <= 0) -> t0.
    const double t0 = a.t0[k];
    const int64_t hidx = (h < W - 1) ? h : W - 1;
    const double before = (h > 0) ? cum[h - 1] : 0.0;
    const double t_in =
        np_max(t0, __dmul_rn((double)(a.szslot[k] + h), a.dur));
    double e = __dadd_rn(t_in, __ddiv_rn(__dsub_rn(size, before), bw[hidx]));
    if (!(h < W)) e = __longlong_as_double(0x7ff0000000000000LL);  // +inf
    if (size <= 0.0) e = t0;
    a.end[k] = e;
  }
}

int threads_for(int64_t W) {
  int64_t t = ((W + 31) / 32) * 32;
  return (int)(t < 32 ? 32 : (t > 256 ? 256 : t));
}

template <int G>
int launch(const ScanArgs& a, void* stream) {
  if (a.n <= 0 || a.W <= 0 || a.L <= 0) return (int)cudaErrorInvalidValue;
  ts_plan_scan_kernel<G><<<(unsigned int)a.n, threads_for(a.W), 0,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

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

}  // extern "C"
