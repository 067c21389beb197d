// K6 `div_rhs`: the right-hand side whose z solve is the compact divergence
// of a float32 velocity field (nz, ny, nx):
//
//   r = B_z uz / dz + T_z (D1x ux + D1y uy) = B_z uz + D1x (T_z ux) + D1y (T_z uy)
//
// with D1 a periodic d1 scheme and B_z, T_z its z operators. T_z x = r
// along z (K2 in solve_only mode, ops/strided.leading_solve) gives
// x = D1z uz + D1x ux + D1y uy = div u.
//
// Replaces: cfd_tpu/ops/pallas_vec.py `_div_kernel` (called by
// `_call_div_rhs`), which streams slabs of ux, uy, uz through two VMEM rings
// and applies the pair kernels' x and y block bodies.
//
// Bound on Hopper: by its work, bytes. The least it must move is 3 reads and
// 1 write of f32 per point (4 passes, 268 MB at 256^3); its ~60 flops per
// point take far less. It is one family of xy_phase.cuh (a y phase and an x
// phase, counted as one call by the wrapper): the y phase solves D1y on
// T_z uy, formed from three planes as it reads, and stores it plus B_z uz;
// the x phase stages T_z ux lines as K1 stages f and adds D1x of them. That
// moves ~7 passes: the y phase's scratch round trip and the x phase's
// read-modify-write of r.

#include "xy_phase.cuh"

// ux, uy, uz, r: (nz, ny, nx); r aliases no input. tab1y/c1y, tab1x/c1x: the
// d1 scheme along y and x (scaled by 1/dy and 1/dx); bt, tt: its z tables
// (nz, 2W + 1), scaled by 1/dz, and (nz, 3).
extern "C" int cfd_div_rhs(const float* ux, const float* uy, const float* uz,
                           float* r, const float* tab1y, const float* tab1x,
                           const float* bt, const float* tt, const Coef* c1y,
                           const Coef* c1x, int nz, int W, void* stream) {
  XYArgs a = xy_args(tab1y, tab1y, tab1x, tab1x, c1y, c1y, c1x, c1x, bt, tt, nz, W);
  a.fam[0] = {uy, ux, nullptr, nullptr, uz, r, 0, 1};
  a.nfam = 1;
  return xy_launch(a, stream);
}
