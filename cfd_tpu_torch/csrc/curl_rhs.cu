// K10 `curl_rhs`: the z component of the compact curl of a float32 velocity
// (nz, ny, nx), and the right-hand sides whose z solves are the other two:
//
//   wz = D1x uy - D1y ux                         (final)
//   rA = T_z (D1y uz) - B_z uy / dz     T_z wx = rA:  wx = D1y uz - D1z uy
//   rB = B_z ux / dz - T_z (D1x uz)     T_z wy = rB:  wy = D1z ux - D1x uz
//
// with D1 a periodic d1 scheme and B_z, T_z its z operators; the two solves
// are K2 in solve_only mode (ops/vec.curl_fused). Since the xy operators do
// not depend on z, T_z (D1y uz) = D1y (T_z uz), and likewise for x.
//
// Replaces: cfd_tpu/ops/pallas_vec.py `_curl_kernel` (called by
// `_call_curl_rhs`), which streams slabs of ux, uy, uz through VMEM rings
// and applies the pair kernels' x and y block bodies.
//
// Bound on Hopper: by its work, bytes. The least it must move is 3 reads
// and 3 writes of f32 per point (6 passes, 403 MB at 256^3); its ~130 flops
// per point take far less. It is three weighted families of xy_phase.cuh in
// one y-phase and one x-phase launch (counted as one call by the wrapper):
//
//   wz: wy = -1 on ux, wx = +1 on uy, no z work
//   rA: wy = +1 on T_z uz, wb = -1 on uy, no x term (no x blocks)
//   rB: no y term (its y phase writes B_z ux, no solve), wx = -1 on T_z uz
//
// so four line solves a point, each family's y phase and x phase
// latency-bound as K6's are; it moves ~14 passes: the y scratch round trips
// of wz and rA, the x phase's read-modify-write of wz and rB, and the
// neighbouring planes of T_z and B_z (mostly L2 hits).

#include "xy_phase.cuh"

// ux, uy, uz, wz, ra, rb: (nz, ny, nx); no output aliases an input.
// tab1y/c1y, tab1x/c1x: the d1 scheme along y and x (scaled by 1/dy and
// 1/dx); bt, tt: its z tables (nz, 2W + 1), scaled by 1/dz, and (nz, 3).
extern "C" int cfd_curl_rhs(const float* ux, const float* uy, const float* uz, float* wz,
                            float* ra, float* rb, const float* tab1y, const float* tab1x,
                            const float* bt, const float* tt, const Coef* c1y,
                            const Coef* c1x, int nz, int W, void* stream) {
  XYArgs a = xy_args(tab1y, tab1y, tab1x, tab1x, c1y, c1y, c1x, c1x, bt, tt, nz, W);
  //          sy       sx       my       mx       bz       out d2 rhs wy    wx    wb   tz
  a.fam[0] = {ux,      uy,      nullptr, nullptr, nullptr, wz, 0, 0, -1.f, 1.f, 0.f, 0};
  a.fam[1] = {uz,      nullptr, nullptr, nullptr, uy,      ra, 0, 0, 1.f, 0.f, -1.f, 1};
  a.fam[2] = {nullptr, uz,      nullptr, nullptr, ux,      rb, 0, 0, 0.f, -1.f, 1.f, 1};
  a.nfam = 3;
  a.weighted = 1;
  return xy_launch(a, stream);
}
