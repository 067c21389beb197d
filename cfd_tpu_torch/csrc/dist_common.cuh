// Shared pieces of the shard-local kernels K11 (lane_dist.cu) and K12
// (strided_dist.cu): one shard's line of a distributed compact solve.
//
// A line of a shard holds n = c.n points f[0 .. n) and the w = c.K halo
// rows of its neighbours, f[-w .. 0) and f[n .. n + w). Its local block T_r
// is a plain tridiagonal block, never cyclic: under a periodic scheme the
// ring of shards closes in the reduced interface system (parallel/
// compact.py), so there is no Sherman–Morrison term here. The end shards of
// a non-periodic line carry the closure rows: `first` forms rows 0 ..
// n_rows-1 and `last` rows n-1 .. n-n_rows from f itself, in the difference
// (or second-difference) form of compact_common.cuh, and never read their
// open-side halo. Every other row is the interior stencil, reading halo rows
// where it crosses the shard's ends.
#pragma once

#include "compact_common.cuh"

// Per-point table of a shard's block, float32 (5, n), one row each:
#define DIST_TAB_W 0     // Thomas forward multipliers
#define DIST_TAB_INVD 1  // 1 / pivots
#define DIST_TAB_DU 2    // superdiagonal
#define DIST_TAB_SUH 3   // unit load of the left neighbour's coupling
#define DIST_TAB_SLH 4   // unit load of the right neighbour's coupling

// The scaled right-hand side of a shard's line, row after row: `next(i)`
// for i = 0, 1, ..., n - 1. `src(m)` returns f[m] for -w <= m < n + w and 0
// outside (the read-ahead runs to m = n + CFD_AHEAD).
template <class Src>
struct DistRhs {
  const Coef& c;
  const bool first, last;
  float cl[CFD_MAX_ROWS], cr[CFD_MAX_ROWS];
  float b1, b2, b3;  // f[i-1], f[i-2], f[i-3]
  Ahead<Src> a;      // f[i .. i + CFD_AHEAD]
  __device__ __forceinline__ DistRhs(const Coef& c_, Src src, bool first_, bool last_)
      : c(c_), first(first_), last(last_), a(src) {
    const int n = c.n;
#pragma unroll
    for (int j = 0; j < CFD_MAX_ROWS; ++j) {
      cl[j] = first && j < c.n_rows ? c.scale * closure_row(c, src, j) : 0.f;
      cr[j] = last && j < c.n_rows ? c.scale * closure_row(c, src, n - 1 - j) : 0.f;
    }
    b1 = src(-1);
    b2 = src(-2);
    b3 = src(-3);
  }
  __device__ __forceinline__ float next(int i) {
    const int n = c.n;
    const float* ahead = a.a;
    const float fi = ahead[0];
    float r;
    if (first && i < c.n_rows) {
      r = pick3(cl, i);
    } else if (last && i >= n - c.n_rows) {
      r = pick3(cr, n - 1 - i);
    } else {
      r = c.center * fi;
      r += c.w[0] * ((ahead[1] - fi) + c.sign * (b1 - fi));
      r += c.w[1] * ((ahead[2] - fi) + c.sign * (b2 - fi));
      r += c.w[2] * ((ahead[3] - fi) + c.sign * (b3 - fi));
      r *= c.scale;
    }
    b3 = b2;
    b2 = b1;
    b1 = fi;
    a.next(i);
    return r;
  }
};

// The Thomas sweeps of the acyclic block against the (5, n) table.
struct BlockSweep {
  const float* tab;
  int n;
  float z = 0.f, x = 0.f;
  __device__ __forceinline__ BlockSweep(const float* __restrict__ t, int n_) : tab(t), n(n_) {}
  __device__ __forceinline__ float forward(int i, float r) {
    z = r - __ldg(tab + DIST_TAB_W * n + i) * z;
    return z;
  }
  __device__ __forceinline__ float last() {
    x = z * __ldg(tab + DIST_TAB_INVD * n + n - 1);
    return x;
  }
  __device__ __forceinline__ float backward(int i, float zi) {
    x = (zi - __ldg(tab + DIST_TAB_DU * n + i) * x) * __ldg(tab + DIST_TAB_INVD * n + i);
    return x;
  }
};

// Solve one shard line: y[i * stride] receives the forward sweep and
// `store(i, x_i)` the solution, under the same contract as solve_line in
// compact_common.cuh (y may be the storage that src reads for 0 <= m < n).
template <class Src, class Store>
__device__ __forceinline__ void solve_dist_line(const Coef& c, const float* __restrict__ tab,
                                                Src src, bool first, bool last, float* y,
                                                long long stride, Store store) {
  const int n = c.n;
  DistRhs<Src> rhs(c, src, first, last);
  BlockSweep s(tab, n);
  for (int i = 0; i < n; ++i) y[i * stride] = s.forward(i, rhs.next(i));
  Behind zb(y, stride, n);
  store(n - 1, s.last());
  for (int i = n - 2; i >= 0; --i) store(i, s.backward(i, zb.next(i)));
}

// The rank-2 interface update of row i: a * suh[i] + b * slh[i].
__device__ __forceinline__ float dist_update(const float* __restrict__ tab, int n, int i, float a,
                                             float b) {
  return a * __ldg(tab + DIST_TAB_SUH * n + i) + b * __ldg(tab + DIST_TAB_SLH * n + i);
}
