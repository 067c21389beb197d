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
// and 6 writes of f32 per point (9 passes, 604 MB or 0.180 ms at 3.35 TB/s
// at 256^3); its ~380 flops per point take far less. It is six families of
// xy_phase.cuh in one y-phase and one x-phase launch (counted as one call
// by the wrapper): per component, axy_i = u1 D1y u_i + u0 D1x u_i and r_i =
// B_z u_i + D2y h_i + D2x h_i. Each phase reads a component once for both
// of its families, and the advecting velocity of its axis once; the y phase
// writes both outputs once and the x phase adds into them. So a component
// moves 4 passes in the y phase and 6 in the x phase: 30 in all, not the
// TPU kernel's 9 (the y phase's column walk, which this replaced, moved
// ~27 of its own: a scratch round trip through the outputs, and the
// component read again for each family).
//
// Design of the y phase (xy_phase.cuh `xy_y_kernel<K, XY_PAIR>`): staged
// y-tile sub-block chains, as K4 runs z. A block takes C columns of one
// plane, reads their whole y-lines of u_i once and stages them twice, u_i
// and T_z u_i (the plane's T_z row made once), into two tiles of row m,
// column l at [m C + l]; each y-line is cut into ops/lane.py `line_nb(ny)`
// sub-blocks of >= 32 rows, the advection tile's chains on the d1 scheme's
// y chain table and the Laplacian's on the periodic d2 scheme's, one
// thread a chain (chain (k, l) thread k C + l of its tile, so a warp's 32
// chains touch 32 consecutive words); the block then writes u1 D1y u_i and
// B_z u_i + D2y h_i, coalesced. At 512^3: 16 columns, 512 chains and 68
// KB a block; at 256^3: 32 columns, 512 chains, 68 KB.
//
// Design of the x phase (xy_phase.cuh `xy_chain_launch<XY_PAIR>`): K1's
// sub-block Thomas chains (line_chains.cuh) on a component's two families
// at once. A block reads L x-lines of u_i once and stages them twice into
// one chain layout: u_i for the advection family, T_z u_i (each line's T_z
// row made once) for the Laplacian's. Each line is cut into ops/lane.py
// `line_nb(nx)` sub-blocks of >= 32 rows (8 of 32 at nx = 256: 16 lines, 256
// chains and 35 KB a block); the advection family's chains solve on the d1
// scheme's chain table (closure rows included, for a non-periodic d1), the
// Laplacian's on the periodic d2 scheme's, one thread a chain, and the
// block adds u0 D1x u_i into axy_i and D2x h_i into r_i, coalesced. Where
// one thread walked each staged line (the form this replaced), a block at
// nx = 256 had 64 of its 128 threads busy; a line past 48 KB a block (nx =
// 6134: two chains of 3067 rows) opts into the larger shared memory. K3
// (adv_lap.cu) is this launch for one field.

#include "xy_phase.cuh"

// u0, u1, u2, axy0..2, r0..2: (nz, ny, nx); no output aliases an input. c1y
// with tab1y, hy1, winy1 and c2y with tab2y, hy2, winy2: the d1 and the
// periodic d2 scheme along y (n = ny, scaled by 1/dy and 1/dy^2), with their
// chain tables (ops/lane.py `chain_table`) for nby sub-blocks a y-line. c1x
// with chx1, h1, win1 and c2x with chx2, h2, win2: the two along x (n = nx,
// scaled by 1/dx and 1/dx^2), with their chain tables for nb sub-blocks a
// line. bt, tt: the d2 scheme's z tables (nz, 2W + 1), scaled by 1/dz^2, and
// (nz, 3).
extern "C" int cfd_adv_lap3(const float* u0, const float* u1, const float* u2, float* axy0,
                            float* axy1, float* axy2, float* r0, float* r1, float* r2,
                            const float* tab1y, const float* tab2y, const float* chx1,
                            const float* chx2, const float* bt, const float* tt,
                            const Coef* c1y, const Coef* c2y, const Coef* c1x, const Coef* c2x,
                            int nz, int W, int nby, int hy1, int winy1, int hy2, int winy2,
                            int nb, int h1, int win1, int h2, int win2, void* stream) {
  XYArgs a = xy_args(tab1y, tab2y, nullptr, nullptr, c1y, c2y, c1x, c2x, bt, tt, nz, W);
  const float* u[3] = {u0, u1, u2};
  float* axy[3] = {axy0, axy1, axy2};
  float* r[3] = {r0, r1, r2};
  for (int i = 0; i < 3; ++i) {
    a.fam[2 * i] = {u[i], u[i], u1, u0, nullptr, axy[i], 0, 0};
    a.fam[2 * i + 1] = {u[i], u[i], nullptr, nullptr, u[i], r[i], 1, 1};
  }
  a.nfam = 6;
  a.paired = 1;
  xy_y_chains(a, 0, nby, hy1, winy1);
  xy_y_chains(a, 1, nby, hy2, winy2);
  xy_chain_table(a, 0, chx1, nb, h1, win1);
  xy_chain_table(a, 1, chx2, nb, h2, win2);
  return xy_chain_launch<XY_PAIR>(a, stream);
}
