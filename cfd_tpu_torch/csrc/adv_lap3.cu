// K5 `adv_lap_rhs3`: K3 for all three components of a velocity field, the
// head of one momentum stage of the Burgers and Navier–Stokes models:
//
//   axy_i = u0 D1x u_i + u1 D1y u_i
//   r_i   = B_z u_i + D2x h_i + D2y h_i,   h_i = T_z u_i      (i = 0, 1, 2)
//
// with D1 the d1 scheme, D2 the periodic d2 scheme and B_z / dz^2, T_z its
// z operators; solving T_z lap_i = r_i along z (K4) gives the Laplacian of
// u_i. The advecting velocities are u0 and u1 themselves.
//
// Replaces: cfd_tpu/ops/pallas_lap.py `_adv_lap3_kernel` (called by
// `_call_adv_lap3`), which streams the three components' z-slabs through
// three VMEM rings so that each velocity is read from HBM once, not three
// times as three `_adv_lap_kernel` calls would.
//
// Bound on Hopper: by its work, bytes. The least it must move is 3 reads
// and 6 writes of f32 per point (9 passes, 604 MB at 256^3); its ~380 flops
// per point take far less. It is six families of xy_phase.cuh in one
// y-phase and one x-phase launch (counted as one call by the wrapper): per
// component, axy_i = u1 D1y u_i + u0 D1x u_i and r_i = B_z u_i + D2y h_i +
// D2x h_i. An x block stages one component's two families from one read of
// u_i, as K3 does (16 lines of each at nx = 256, 34 KB), so six families
// stage no more per block than two: the components share the launches, not
// the tiles. That keeps K3's traffic three times over (not the TPU kernel's
// 9 passes: in the y phase each family reads its component, and u0 and u1
// are read again as velocities), with three times K3's threads in flight.

#include "xy_phase.cuh"

// u0, u1, u2, axy0..2, r0..2: (nz, ny, nx); no output aliases an input.
// Tables as for cfd_adv_lap.
extern "C" int cfd_adv_lap3(const float* u0, const float* u1, const float* u2,
                            float* axy0, float* axy1, float* axy2, float* r0,
                            float* r1, float* r2, const float* tab1y,
                            const float* tab2y, const float* tab1x,
                            const float* tab2x, const float* bt, const float* tt,
                            const Coef* c1y, const Coef* c2y, const Coef* c1x,
                            const Coef* c2x, int nz, int W, void* stream) {
  XYArgs a = xy_args(tab1y, tab2y, tab1x, tab2x, c1y, c2y, c1x, c2x, bt, tt, nz, W);
  const float* u[3] = {u0, u1, u2};
  float* axy[3] = {axy0, axy1, axy2};
  float* r[3] = {r0, r1, r2};
  for (int i = 0; i < 3; ++i) {
    a.fam[2 * i] = {u[i], u[i], u1, u0, nullptr, axy[i], 0, 0};
    a.fam[2 * i + 1] = {u[i], u[i], nullptr, nullptr, u[i], r[i], 1, 1};
  }
  a.nfam = 6;
  a.paired = 1;
  return xy_launch(a, stream);
}
