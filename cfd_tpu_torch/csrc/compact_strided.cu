// K2 `compact_strided`: compact derivative along a strided axis of a float32
// field viewed as (outer, n, inner), the line running along the middle
// axis: dfdy is (nz, ny, nx), dfdz is (1, nz, ny * nx).
//
// Replaces: cfd_tpu/ops/pallas_sublane.py `_sublane_kernel` (roll form along
// the second-minor axis, dfdy) and `_sublane_fold_kernel` (fold form, d2y),
// and cfd_tpu/ops/pallas_leading.py `_leading_kernel` in its plain
// derivative mode (dfdz; d2z, which the JAX package sends to a dense
// product) and in its epilogue modes (below). The TPU needed these kernels
// because its (8, 128) tiling treats the second-minor and the leading axis
// differently; on Hopper both are the same strided walk with x contiguous.
// It computes T f' = B f / dx**order with the scheme's interior stencil,
// closure rows and periodic wrap as one Thomas solve per line (plus a
// Sherman–Morrison rank-1 term on periodic lines).
//
// Modes of `_leading_kernel` (pallas_leading.py:157-227), each the
// kernel's own epilogue on its final store or its own RHS reader, never a
// pass after it:
//   acc         out = f' + acc           (projection: uz - dphi/dz with -dz)
//   mul         out = mul * f' + acc     (the advection term uz * fz + axy)
//   solve_only  the input is the right-hand side itself: T x = r, no
//               stencil, no closure rows, no wrap; the Sherman–Morrison
//               term of a periodic line still applies (leading_solve, the
//               second half of the fused divergence)
//   rk          solve_only's solve of the Laplacian's z right-hand side r,
//               lap = T^{-1} r, whose backward sweep emits the Williamson
//               RK3 update  q' = a q + dt (nu lap - adv),  f' = fin + b q'
//               (no q on the first substep): `_leading_kernel(rk=True)`,
//               called by `_call_rk3` (pallas_leading.py:709) from
//               `rk3_solve_update`, the stepwise tail of the fused substep
//               where K4 is not taken. It reads r, adv, fin (and q) once
//               and writes q' and f': 6 passes (5 without q) at the least,
//               8 (7) with the forward sweep's scratch round trip in q'.
//
// Bound on Hopper: by its work, bytes. This simple form moves two reads and
// two writes of f32 per point: the forward sweep reads f and writes its
// intermediate into `out`, the backward sweep reads it back and writes f'
// (plus one read per point for each of mul and acc). The rank-1 periodic
// term rides the backward sweep (see Sweep), so periodic lines move no
// more.
//
// Design: one thread owns one (outer, inner) column and walks it down the
// line; neighbouring threads take neighbouring `inner`, so every row access
// of a warp is one coalesced 128-byte line, and each row of f is read once
// (the line RHS's read-ahead window). Offsets are 64-bit (outer * n * inner
// passes 2^31 at 1024^3). At 256^3 there are only 65,536 columns, about 500
// threads per SM, all resident at once, and each row waits about one memory
// latency: the kernel is latency-bound at ~1.5x its byte floor (PERF.md).
// Splitting each line into interleaved chains with a reduced interface
// solve, as pallas_leading.py does, multiplies the parallelism; that is
// later work.

#include "compact_common.cuh"

// The rk mode's operands: q' = a q + dt_nu lap - dt adv, f' = fin + b q'.
struct RkArgs {
  const float* adv;
  const float* q;  // null on the first substep
  const float* fin;
  float* fout;
  float a, b, dt, dt_nu;
};

// One instantiation per mode, so that no mode pays for another's branches.
template <bool SOLVE_ONLY, bool MUL, bool ACC, bool RK>
__global__ void compact_strided_kernel(const float* __restrict__ f,
                                       float* __restrict__ out,
                                       const float* __restrict__ tab,
                                       const __grid_constant__ Coef c,
                                       const float* __restrict__ mul,  // MUL only
                                       const float* __restrict__ acc,  // ACC only
                                       const __grid_constant__ RkArgs rk,  // RK only
                                       long long outer, long long inner) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= outer * inner) return;
  const long long o = col / inner;
  const long long j = col - o * inner;
  const long long base = o * c.n * inner + j;
  const float* fc = f + base;
  float* oc = out + base;
  const int n = c.n;
  auto store = [&](int i, float v) {
    const long long e = base + i * inner;
    if (RK) {  // v is lap; out holds q'
      float qn = rk.dt_nu * v - rk.dt * __ldg(rk.adv + e);
      if (rk.q) qn += rk.a * __ldg(rk.q + e);
      out[e] = qn;
      rk.fout[e] = __ldg(rk.fin + e) + rk.b * qn;
      return;
    }
    if (MUL) v *= __ldg(mul + e);
    if (ACC) v += __ldg(acc + e);
    out[e] = v;
  };
  if (SOLVE_ONLY || RK) {
    solve_formed(c, tab, [&](int m) { return m < n ? __ldg(fc + m * inner) : 0.f; }, oc, inner,
                 store);
  } else {
    auto src = [&](int m) {
      if (m >= n) {
        if (!c.periodic) return 0.f;
        m %= n;
      }
      return __ldg(fc + m * inner);
    };
    solve_line(c, tab, src, oc, inner, store);
  }
}

#define STRIDED_THREADS 128  // columns per block

template <bool SOLVE_ONLY, bool MUL, bool ACC, bool RK = false>
static int strided_launch(const float* f, float* out, const float* tab, const Coef* c,
                          const float* mul, const float* acc, long long outer,
                          long long inner, void* stream, const RkArgs& rk = RkArgs{}) {
  const long long blocks = (outer * inner + STRIDED_THREADS - 1) / STRIDED_THREADS;
  compact_strided_kernel<SOLVE_ONLY, MUL, ACC, RK>
      <<<(unsigned)blocks, STRIDED_THREADS, 0, (cudaStream_t)stream>>>(f, out, tab, *c, mul,
                                                                        acc, rk, outer, inner);
  return (int)cudaGetLastError();
}

// mul and acc may be null; with solve_only = 1, f is the right-hand side,
// c's scale is not read, and mul and acc must be null.
extern "C" int cfd_compact_strided(const float* f, float* out,
                                   const float* tab, const Coef* c,
                                   const float* mul, const float* acc,
                                   int solve_only, long long outer,
                                   long long inner, void* stream) {
  if (solve_only) {
    if (mul || acc) return (int)cudaErrorInvalidValue;
    return strided_launch<true, false, false>(f, out, tab, c, mul, acc, outer, inner, stream);
  }
  if (mul && acc) {
    return strided_launch<false, true, true>(f, out, tab, c, mul, acc, outer, inner, stream);
  }
  if (mul) return strided_launch<false, true, false>(f, out, tab, c, mul, acc, outer, inner, stream);
  if (acc) return strided_launch<false, false, true>(f, out, tab, c, mul, acc, outer, inner, stream);
  return strided_launch<false, false, false>(f, out, tab, c, mul, acc, outer, inner, stream);
}

// The rk mode on (outer, n, inner) fields: r the Laplacian's right-hand
// side, c and tab the d2 scheme's (only its LHS tables are read); qout
// receives q' (and holds the forward sweep), fout f'. q may be null (the
// first substep); adv, q, fin have r's shape, and no output aliases an
// input.
extern "C" int cfd_strided_rk(const float* r, const float* adv, const float* q,
                              const float* fin, float* qout, float* fout, const float* tab,
                              const Coef* c, float a, float b, float dt, float dt_nu,
                              long long outer, long long inner, void* stream) {
  const RkArgs rk = {adv, q, fin, fout, a, b, dt, dt_nu};
  return strided_launch<false, false, false, true>(r, qout, tab, c, nullptr, nullptr, outer,
                                                   inner, stream, rk);
}
