// Shared pieces of the compact-derivative kernels: the scheme coefficients,
// the right-hand side T f' = B f / dx**order, and the tridiagonal sweeps
// that every kernel runs along a line.
//
// Tables are built in float64 on the host (cfd_tpu_torch/ops/_native.py,
// whose ctypes `Coef` mirrors the struct below field by field) and read here
// as float32. They are generic in the scheme: first and second derivatives
// and filters differ only in their numbers.
#pragma once

#include <cuda_runtime.h>

#define CFD_MAX_K 3     // widest interior offset
#define CFD_MAX_ROWS 3  // closure rows per edge
#define CFD_MAX_TAPS 8  // taps per closure row
// Rows the forward sweep reads ahead of the row it solves (so each value of
// f is read once, not 2K + 1 times), and the backward sweep below its row.
// The window shifts by register moves, and a move waits for the load it
// copies, so it does not hide the memory latency: measured on an H100, a
// sweep still waits about one load latency per row (PERF.md).
#define CFD_AHEAD 8
#define CFD_BEHIND 8

struct Coef {
  int n;         // line length
  int K;         // widest interior offset (<= CFD_MAX_K)
  int periodic;  // 1: cyclic line, no closure rows
  int n_rows;    // closure rows per edge
  int n_taps;    // taps per closure row (zero-padded)
  int diff2;     // 1: closure rows are weights of second differences (d2)
  float w[CFD_MAX_K];  // interior weight of offset k at w[k-1] (0 for gaps)
  float sign;          // sign of the f[i-k] term: -1 odd order, +1 even
  float center;        // f[i] weight in difference form: c0 + (1+sign)*sum(w)
  float scale;         // 1 / dx**order
  float v0, vn, inv_denom;  // Sherman–Morrison scalars (periodic lines)
  float left[CFD_MAX_ROWS][CFD_MAX_TAPS];   // row j: weights of f[m]
  float left_sum[CFD_MAX_ROWS];             // sum of row j's weights
  float right[CFD_MAX_ROWS][CFD_MAX_TAPS];  // row n-1-j: weights of f[n-1-m]
  float right_sum[CFD_MAX_ROWS];
};

// Per-point table `tab`, float32 (5, n), one row each:
#define CFD_TAB_W 0     // Thomas forward multipliers
#define CFD_TAB_INVD 1  // 1 / pivots
#define CFD_TAB_DU 2    // superdiagonal
#define CFD_TAB_Q 3     // Sherman–Morrison q = A'^{-1} u (0 if not periodic)
#define CFD_TAB_P 4     // row 0 of U^{-1} (0 if not periodic)

// Every RHS row is formed from differences to the row's own value f[i]:
// sum_m c_m (f_m - f_i) + (sum_m c_m) f_i. For a derivative each row
// annihilates constants, so the last term is zero and f's mean never
// enters the sum; a wall row of SCHEME6 (six taps, weights up to 5) formed
// from the raw values loses about 3e-5 of a unit-scale f' in float32. A
// filter's rows keep constants: the last term is (1 + 2 alpha) f_i on the
// interior (`center`) and f_i on its identity closure rows (`left_sum` =
// 1, one tap of weight 1 at m = i), which therefore return f_i exactly.
//
// A second derivative's row annihilates linear functions too, and its
// value is O(dx^2 f'') against taps of O(f): on a smooth field at n = 256
// the first-difference form of a d2 wall row (weights up to 26) still loses
// ~5e-4 of f''. Its closure rows are therefore given (diff2 = 1) as weights
// d_m of the second differences f_m - 2 f_{m+1} + f_{m+2}, each formed as
// (f_m - f_{m+1}) + (f_{m+2} - f_{m+1}), as the interior rows are.

// Closure row i (before the 1/dx**order scale), `get(m)` returning f[m].
template <class Get>
__device__ __forceinline__ float closure_row(const Coef& c, Get get, int i) {
  const int n = c.n;
  const bool left = i < c.n_rows;
  const int j = left ? i : n - 1 - i;
  const float* wt = left ? c.left[j] : c.right[j];
  auto at = [&](int m) { return get(left ? m : n - 1 - m); };  // from the wall
  float r = 0.f;
  if (c.diff2) {
    for (int m = 0; m < c.n_taps; ++m) {
      const float mid = at(m + 1);
      r += wt[m] * ((at(m) - mid) + (at(m + 2) - mid));
    }
    return r;
  }
  const float fi = get(i);
  r = (left ? c.left_sum[j] : c.right_sum[j]) * fi;
  for (int m = 0; m < c.n_taps; ++m) r += wt[m] * (at(m) - fi);
  return r;
}

__device__ __forceinline__ float pick3(const float* v, int j) {
  return j == 0 ? v[0] : (j == 1 ? v[1] : v[2]);
}

// The values src(i .. i + CFD_AHEAD) of a line, read ahead of the row that
// consumes them: `next(i)` returns src(i) and loads src(i + CFD_AHEAD + 1).
template <class Src>
struct Ahead {
  Src src;
  float a[CFD_AHEAD + 1];
  __device__ __forceinline__ explicit Ahead(Src s) : src(s) {
#pragma unroll
    for (int k = 0; k <= CFD_AHEAD; ++k) a[k] = src(k);
  }
  __device__ __forceinline__ float next(int i) {
    const float v = a[0];
#pragma unroll
    for (int k = 0; k < CFD_AHEAD; ++k) a[k] = a[k + 1];
    a[CFD_AHEAD] = src(i + CFD_AHEAD + 1);
    return v;
  }
};

// The scaled right-hand side B f / dx**order of a line, row after row:
// `next(i)` for i = 0, 1, ..., n - 1. `src(m)` returns f[m] for
// 0 <= m <= n + CFD_AHEAD (wrapped for periodic lines; any finite value past
// n otherwise). The closure rows are formed first, and f[i-1..i-3] stay in
// registers, so each f[m] is read once.
template <class Src>
struct LineRhs {
  const Coef& c;
  float cl[CFD_MAX_ROWS], cr[CFD_MAX_ROWS];
  float b1 = 0.f, b2 = 0.f, b3 = 0.f;  // f[i-1], f[i-2], f[i-3]
  Ahead<Src> a;                          // f[i .. i + CFD_AHEAD]
  __device__ __forceinline__ LineRhs(const Coef& c_, Src src) : c(c_), a(src) {
    const int n = c.n;
    const bool walls = !c.periodic;
#pragma unroll
    for (int j = 0; j < CFD_MAX_ROWS; ++j) {
      const bool on = walls && j < c.n_rows;
      cl[j] = on ? c.scale * closure_row(c, src, j) : 0.f;
      cr[j] = on ? c.scale * closure_row(c, src, n - 1 - j) : 0.f;
    }
    if (!walls) {  // n >= 3 for every scheme
      b1 = src(n - 1);
      b2 = src(n - 2);
      b3 = src(n - 3);
    }
  }
  __device__ __forceinline__ float next(int i) {
    const int n = c.n;
    const bool walls = !c.periodic;
    const float* ahead = a.a;
    const float fi = ahead[0];
    float r;
    if (walls && i < c.n_rows) {
      r = pick3(cl, i);
    } else if (walls && i >= n - c.n_rows) {
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

// One Thomas sweep pair against the table `tab` (plus the Sherman–Morrison
// rank-1 term on periodic lines). The caller stores each forward value z_i
// (`forward`) and hands it back, from i = n - 2 down, to `backward`, which
// returns the solution x_i; `last()` returns x_{n-1}.
//
// Periodic lines: the solution is x = y - q * inv_denom * (v0 y_0 + vn y_{n-1})
// with y the solve against the acyclic core A'. y_{n-1} is the first value
// of the backward sweep, and y_0 = sum_i P[i] z_i is accumulated during the
// forward sweep from row 0 of U^{-1}, so the rank-1 term is applied as the
// backward sweep goes, with no third pass over the line.
struct Sweep {
  const float* tab;
  int n;
  float z = 0.f, y0 = 0.f, x = 0.f, corr = 0.f;
  __device__ __forceinline__ Sweep(const Coef& c, const float* __restrict__ t)
      : tab(t), n(c.n) {}
  __device__ __forceinline__ float forward(int i, float r) {
    z = r - __ldg(tab + CFD_TAB_W * n + i) * z;
    y0 += __ldg(tab + CFD_TAB_P * n + i) * z;
    return z;
  }
  __device__ __forceinline__ float last(const Coef& c) {
    x = z * __ldg(tab + CFD_TAB_INVD * n + n - 1);
    corr = c.periodic ? c.inv_denom * (c.v0 * y0 + c.vn * x) : 0.f;
    return x - __ldg(tab + CFD_TAB_Q * n + n - 1) * corr;
  }
  __device__ __forceinline__ float backward(int i, float zi) {
    x = (zi - __ldg(tab + CFD_TAB_DU * n + i) * x) * __ldg(tab + CFD_TAB_INVD * n + i);
    return x - __ldg(tab + CFD_TAB_Q * n + i) * corr;
  }
};

// The stored forward values y[m * stride] read back below the row the
// backward sweep solves: `next(i)` for i = n - 2, n - 3, ..., 0 returns
// z_i and loads z_{i - CFD_BEHIND}.
struct Behind {
  const float* y;
  long long stride;
  float zb[CFD_BEHIND];  // z[i], z[i-1], ...
  __device__ __forceinline__ Behind(const float* y_, long long s, int n) : y(y_), stride(s) {
#pragma unroll
    for (int k = 0; k < CFD_BEHIND; ++k) zb[k] = n - 2 - k >= 0 ? y[(n - 2 - k) * stride] : 0.f;
  }
  __device__ __forceinline__ float next(int i) {
    const float zi = zb[0];
#pragma unroll
    for (int k = 0; k < CFD_BEHIND - 1; ++k) zb[k] = zb[k + 1];
    zb[CFD_BEHIND - 1] = i - CFD_BEHIND >= 0 ? y[(i - CFD_BEHIND) * stride] : 0.f;
    return zi;
  }
};

// Solve one line: y[i * stride] receives the forward sweep, and
// `store(i, x_i)` the solution (by default into y[i * stride] as well).
// `src` is as for LineRhs. y may be the storage that src reads: the sweep
// reads each f[m] before it writes row m. store(i, .) is called after the
// backward sweep has read row i of y and never reads a row above it again,
// so it may overwrite y[i * stride].
template <class Src, class Store>
__device__ __forceinline__ void solve_line(const Coef& c,
                                           const float* __restrict__ tab,
                                           Src src, float* y, long long stride,
                                           Store store) {
  const int n = c.n;
  LineRhs<Src> rhs(c, src);
  Sweep s(c, tab);
  for (int i = 0; i < n; ++i) y[i * stride] = s.forward(i, rhs.next(i));
  Behind zb(y, stride, n);
  store(n - 1, s.last(c));
  for (int i = n - 2; i >= 0; --i) store(i, s.backward(i, zb.next(i)));
}

// solve_line for a right-hand side that is already formed: `src(m)` returns
// r[m] for 0 <= m <= n + CFD_AHEAD (any finite value past n). It repeats
// solve_line's sweeps rather than sharing them: routing solve_line through
// a shared body by reference measured K1 8.6% slower on an H100 (different
// register allocation of the same arithmetic; PERF.md).
template <class Src, class Store>
__device__ __forceinline__ void solve_formed(const Coef& c,
                                             const float* __restrict__ tab,
                                             Src src, float* y, long long stride,
                                             Store store) {
  const int n = c.n;
  Ahead<Src> rhs(src);
  Sweep s(c, tab);
  for (int i = 0; i < n; ++i) y[i * stride] = s.forward(i, rhs.next(i));
  Behind zb(y, stride, n);
  store(n - 1, s.last(c));
  for (int i = n - 2; i >= 0; --i) store(i, s.backward(i, zb.next(i)));
}

template <class Src>
__device__ __forceinline__ void solve_line(const Coef& c,
                                           const float* __restrict__ tab,
                                           Src src, float* y, long long stride) {
  solve_line(c, tab, src, y, stride, [=](int i, float v) { y[i * stride] = v; });
}

// Lines staged in shared memory (K1, K3's x phase). Line l of a block sits
// at tile + l * cfd_line_ld(n): n values, then CFD_AHEAD + 1 slots that
// repeat its first values for the periodic wrap (wrap_line). The stride is
// rounded up to odd, so the 32 lines a warp walks sit in 32 different banks.
__host__ __device__ __forceinline__ int cfd_line_ld(int n) { return (n + CFD_AHEAD + 1) | 1; }

#define CFD_STAGE_BATCH 8  // coalesced loads (stores) each thread keeps in flight

// Stage `count` values, the block's lines of length n back to back, into NT
// tiles with coalesced loads: load(e, v) fills v[0 .. NT) for element e.
template <int NT, class Load>
__device__ __forceinline__ void stage_lines(float* const (&tiles)[NT], int count, int n,
                                            Load load) {
  const int ld = cfd_line_ld(n);
  for (int e0 = threadIdx.x; e0 < count; e0 += CFD_STAGE_BATCH * blockDim.x) {
    float v[CFD_STAGE_BATCH][NT];
#pragma unroll
    for (int u = 0; u < CFD_STAGE_BATCH; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < count) load(e, v[u]);
    }
#pragma unroll
    for (int u = 0; u < CFD_STAGE_BATCH; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < count) {
        const int l = e / n;
#pragma unroll
        for (int t = 0; t < NT; ++t) tiles[t][l * ld + (e - l * n)] = v[u][t];
      }
    }
  }
}

__device__ __forceinline__ void wrap_line(float* line, int n) {
  for (int k = 0; k <= CFD_AHEAD; ++k) line[n + k] = line[k % n];
}
