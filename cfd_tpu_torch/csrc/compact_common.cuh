// Shared pieces of the compact-derivative kernels: the scheme coefficients,
// the right-hand side T f' = B f / dx**order, and the tridiagonal sweeps
// that both kernels run along a line.
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
// from the raw values loses about 3e-5 of a unit-scale f' in float32.

// Closure row i (before the 1/dx**order scale), `get(m)` returning f[m].
template <class Get>
__device__ __forceinline__ float closure_row(const Coef& c, Get get, int i) {
  const int n = c.n;
  const float fi = get(i);
  if (i < c.n_rows) {
    float r = c.left_sum[i] * fi;
    for (int m = 0; m < c.n_taps; ++m) r += c.left[i][m] * (get(m) - fi);
    return r;
  }
  const int j = n - 1 - i;
  float r = c.right_sum[j] * fi;
  for (int m = 0; m < c.n_taps; ++m) r += c.right[j][m] * (get(n - 1 - m) - fi);
  return r;
}

__device__ __forceinline__ float pick3(const float* v, int j) {
  return j == 0 ? v[0] : (j == 1 ? v[1] : v[2]);
}

// Solve one line: y[i * stride] receives first the forward sweep and then
// f'[i]. `src(m)` returns f[m] for 0 <= m <= n + CFD_AHEAD (wrapped for
// periodic lines; any finite value past n otherwise). y may be the storage
// that src reads: the sweep reads each f[m] before it writes row m, keeps
// f[i-1..i-3] in registers and forms the closure rows first.
//
// Periodic lines: the solution is x = y - q * inv_denom * (v0 y_0 + vn y_{n-1})
// with y the solve against the acyclic core A'. y_{n-1} is the first value
// of the backward sweep, and y_0 = sum_i P[i] z_i is accumulated during the
// forward sweep from row 0 of U^{-1}, so the rank-1 term is applied as the
// backward sweep writes, with no third pass over the line.
template <class Src>
__device__ __forceinline__ void solve_line(const Coef& c,
                                           const float* __restrict__ tab,
                                           Src src, float* y, long long stride) {
  const int n = c.n;
  const float* tw = tab + CFD_TAB_W * n;
  const float* tinvd = tab + CFD_TAB_INVD * n;
  const float* tdu = tab + CFD_TAB_DU * n;
  const float* tq = tab + CFD_TAB_Q * n;
  const float* tp = tab + CFD_TAB_P * n;
  const bool walls = !c.periodic;

  float cl[CFD_MAX_ROWS], cr[CFD_MAX_ROWS];
#pragma unroll
  for (int j = 0; j < CFD_MAX_ROWS; ++j) {
    const bool on = walls && j < c.n_rows;
    cl[j] = on ? c.scale * closure_row(c, src, j) : 0.f;
    cr[j] = on ? c.scale * closure_row(c, src, n - 1 - j) : 0.f;
  }
  // f[i-1], f[i-2], f[i-3]; n >= 3 for every scheme
  float b1 = 0.f, b2 = 0.f, b3 = 0.f;
  if (!walls) {
    b1 = src(n - 1);
    b2 = src(n - 2);
    b3 = src(n - 3);
  }
  float a[CFD_AHEAD + 1];  // f[i .. i + CFD_AHEAD]
#pragma unroll
  for (int k = 0; k <= CFD_AHEAD; ++k) a[k] = src(k);

  float z = 0.f;
  float y0 = 0.f;
  for (int i = 0; i < n; ++i) {
    const float fi = a[0];
    float r;
    if (walls && i < c.n_rows) {
      r = pick3(cl, i);
    } else if (walls && i >= n - c.n_rows) {
      r = pick3(cr, n - 1 - i);
    } else {
      r = c.center * fi;
      r += c.w[0] * ((a[1] - fi) + c.sign * (b1 - fi));
      r += c.w[1] * ((a[2] - fi) + c.sign * (b2 - fi));
      r += c.w[2] * ((a[3] - fi) + c.sign * (b3 - fi));
      r *= c.scale;
    }
    z = r - __ldg(tw + i) * z;
    y[i * stride] = z;
    y0 += __ldg(tp + i) * z;
    b3 = b2;
    b2 = b1;
    b1 = fi;
#pragma unroll
    for (int k = 0; k < CFD_AHEAD; ++k) a[k] = a[k + 1];
    a[CFD_AHEAD] = src(i + CFD_AHEAD + 1);
  }

  float x = z * __ldg(tinvd + n - 1);
  const float corr = walls ? 0.f : c.inv_denom * (c.v0 * y0 + c.vn * x);
  y[(n - 1) * stride] = x - __ldg(tq + n - 1) * corr;
  float zb[CFD_BEHIND];  // z[i], z[i-1], ... of the forward sweep
#pragma unroll
  for (int k = 0; k < CFD_BEHIND; ++k) zb[k] = n - 2 - k >= 0 ? y[(n - 2 - k) * stride] : 0.f;
  for (int i = n - 2; i >= 0; --i) {
    const float zi = zb[0];
#pragma unroll
    for (int k = 0; k < CFD_BEHIND - 1; ++k) zb[k] = zb[k + 1];
    zb[CFD_BEHIND - 1] = i - CFD_BEHIND >= 0 ? y[(i - CFD_BEHIND) * stride] : 0.f;
    x = (zi - __ldg(tdu + i) * x) * __ldg(tinvd + i);
    y[i * stride] = x - __ldg(tq + i) * corr;
  }
}
