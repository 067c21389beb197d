// K3 `adv_lap_rhs`: the advection term in x and y and the right-hand side
// of the compact Laplacian's z solve, for a float32 (nz, ny, nx) field:
//
//   axy[p] = ux[p] D1x f[p] + uy[p] D1y f[p]
//   r[p]   = sum_k btab[p,k] f[p+k] + D2x h[p] + D2y h[p],
//   h[p]   = sum_{k=-1..1} ttab[p,k] f[p+k]                (planes wrap)
//
// with D1 the d1 scheme, D2 the periodic d2 scheme and (btab, ttab) its z
// operators B_z / dz^2 and T_z (ops/adv_lap.z_tables). Since the xy
// operator does not depend on z, T_z (D2x f + D2y f) = D2x h + D2y h:
// solving T_z lap = r along z (K4) gives the Laplacian.
//
// Replaces: cfd_tpu/ops/pallas_lap.py `_adv_lap_kernel` (called by
// `_call_adv_lap`), which streams z-slabs through a ring of three in VMEM
// and applies the x and y fold bodies to each slab with the matrix unit.
//
// Bound on Hopper: by its work, bytes. The least it must move is 3 reads
// (f, ux, uy) and 2 writes (axy, r) of f32 per point, 336 MB at 256^3; the
// four line solves, h and B_z f are ~127 flops per point. It is two
// families of xy_phase.cuh (a y phase and an x phase, counted as one call
// by the wrapper): axy = uy D1y f + ux D1x f, and r = B_z f + D2y h + D2x h.
// That moves ~11 passes, not 5: the y phase's scratch round trip and the x
// phase's read-modify-write of both outputs. Both phases are latency-bound
// recurrences like K1 and K2, each thread running one line solve (PERF.md).

#include "xy_phase.cuh"

// f, ux, uy, axy, r: (nz, ny, nx). tab1y/c1y, tab2y/c2y: the d1 and d2
// schemes along y (n = ny, scaled by 1/dy and 1/dy^2); tab1x/c1x, tab2x/c2x
// along x. bt, tt: the d2 scheme's z tables (nz, 2W + 1) and (nz, 3).
extern "C" int cfd_adv_lap(const float* f, const float* ux, const float* uy,
                           float* axy, float* r, const float* tab1y,
                           const float* tab2y, const float* tab1x,
                           const float* tab2x, const float* bt, const float* tt,
                           const Coef* c1y, const Coef* c2y, const Coef* c1x,
                           const Coef* c2x, int nz, int W, void* stream) {
  XYArgs a = xy_args(tab1y, tab2y, tab1x, tab2x, c1y, c2y, c1x, c2x, bt, tt, nz, W);
  a.fam[0] = {f, f, uy, ux, nullptr, axy, 0, 0};
  a.fam[1] = {f, f, nullptr, nullptr, f, r, 1, 1};
  a.nfam = 2;
  a.paired = 1;
  return xy_launch(a, stream);
}
