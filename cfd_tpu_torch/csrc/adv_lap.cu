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
// four line solves, h and B_z f are ~127 flops per point. It is K5's launch
// (adv_lap3.cu) for one field: one pair of families of xy_phase.cuh (a y
// phase and an x phase, counted as one call by the wrapper), axy = uy D1y f
// + ux D1x f and r = B_z f + D2y h + D2x h. That moves 10 passes, not 5: f
// read in both phases and the x phase's read-modify-write of both outputs.
// The y phase (`xy_y_kernel<K, XY_PAIR>`) stages C columns' y-lines of f
// once, as f and T_z f, in two tiles, solves them in y-tile sub-block
// chains on the d1 and the d2 scheme's y chain tables and writes uy D1y f
// and B_z f + D2y h once each. The x phase (`xy_chain_launch<XY_PAIR>`)
// reads L x-lines of f once, stages them twice into one chain layout (f
// for the advection family, T_z f for the Laplacian's), cuts each line into
// ops/lane.py `line_nb(nx)` sub-blocks of >= 32 rows and runs their Thomas
// chains one a thread (line_chains.cuh), the d1 scheme's chain table for
// the advection family and the periodic d2 scheme's for the Laplacian's: 16
// lines, 256 chains and 35 KB a block at nx = 256, one line of two chains
// of 3067 rows in opted-in shared memory at nx = 6134. So a component of K5
// and K3 run the same arithmetic.

#include "xy_phase.cuh"

// f, ux, uy, axy, r: (nz, ny, nx); no output aliases an input. c1y with tab1y,
// hy1, winy1 and c2y with tab2y, hy2, winy2: the d1 and the periodic d2 scheme
// along y (n = ny, scaled by 1/dy and 1/dy^2), with their chain tables
// (ops/lane.py `chain_table`) for nby sub-blocks a y-line. c1x with chx1, h1,
// win1 and c2x with chx2, h2, win2: the two along x (n = nx, scaled by 1/dx
// and 1/dx^2), with their chain tables for nb sub-blocks a line. bt, tt: the
// d2 scheme's z tables (nz, 2W + 1), scaled by 1/dz^2, and (nz, 3).
extern "C" int cfd_adv_lap(const float* f, const float* ux, const float* uy, float* axy,
                           float* r, const float* tab1y, const float* tab2y, const float* chx1,
                           const float* chx2, const float* bt, const float* tt, const Coef* c1y,
                           const Coef* c2y, const Coef* c1x, const Coef* c2x, int nz, int W,
                           int nby, int hy1, int winy1, int hy2, int winy2, int nb, int h1,
                           int win1, int h2, int win2, void* stream) {
  XYArgs a = xy_args(tab1y, tab2y, nullptr, nullptr, c1y, c2y, c1x, c2x, bt, tt, nz, W);
  a.fam[0] = {f, f, uy, ux, nullptr, axy, 0, 0};
  a.fam[1] = {f, f, nullptr, nullptr, f, r, 1, 1};
  a.nfam = 2;
  a.paired = 1;
  xy_y_chains(a, 0, nby, hy1, winy1);
  xy_y_chains(a, 1, nby, hy2, winy2);
  xy_chain_table(a, 0, chx1, nb, h1, win1);
  xy_chain_table(a, 1, chx2, nb, h2, win2);
  return xy_chain_launch<XY_PAIR>(a, stream);
}
