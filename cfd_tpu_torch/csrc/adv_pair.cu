// K13 `advection_pair`: the advection term in x and y of a float32 field
// viewed as (planes, ny, nx):
//
//   out = ux D1x f + uy D1y f
//
// with D1 any first-derivative scheme (periodic, or with closure rows). It
// is the stepwise head of the fused RK3 substep (ops/fused_step.py) on
// x-lines too long for K3, whose x phase stages two lines per line (f for
// this family and T_z f for the Laplacian's): with one staged line it takes
// nx up to 12278, where K3 stops at 6134.
//
// Replaces: cfd_tpu/ops/pallas_pair.py `_adv_pair_kernel` (called by
// `_call_adv_pair`), which holds one (ny, nx) plane in VMEM, applies the
// pair kernel's x and y block bodies to it and weights them by the
// velocity in the resident output tile.
//
// Bound on Hopper: by its work, bytes. The least it must move is 3 reads
// (f, ux, uy) and 1 write of f32 per point (4 passes, 268 MB at 256^3,
// 1.07 GB at (64, 128, 8192)); its two line solves are ~52 flops a point.
// It is one advection family of xy_phase.cuh, alone (K3's first family
// without the second): the y phase walks (plane, x) columns down y as K2
// does and stores uy D1y f, the x phase stages x-lines of f in shared
// memory as K1 does, solves them in place and adds ux D1x f into the
// output. That moves ~8 passes (the y phase's scratch round trip, the
// output's read-modify-write and f read twice), and both phases are
// latency-bound recurrences like K1 and K2 (PERF.md).

#include "xy_phase.cuh"

// f, ux, uy, out: (planes, ny, nx); out aliases no input. tabx/cx, taby/cy:
// the d1 scheme along x (n = nx, scaled by 1/dx) and y (n = ny, by 1/dy).
extern "C" int cfd_adv_pair(const float* f, const float* ux, const float* uy, float* out,
                            const float* taby, const float* tabx, const Coef* cy,
                            const Coef* cx, int planes, void* stream) {
  XYArgs a = xy_args(taby, taby, tabx, tabx, cy, cy, cx, cx, nullptr, nullptr, planes, 0);
  a.fam[0] = {f, f, uy, ux, nullptr, out, 0, 0};
  a.nfam = 1;
  return xy_launch(a, stream);
}
