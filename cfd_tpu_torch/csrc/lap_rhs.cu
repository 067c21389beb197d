// K9 `lap_rhs`: the right-hand side whose z solve is the compact-d2
// Laplacian of a float32 field (nz, ny, nx):
//
//   r = B_z f / dz^2 + T_z (D2x f + D2y f) = B_z f + D2x h + D2y h,  h = T_z f
//
// with D2 a periodic d2 scheme and B_z, T_z its z operators. T_z x = r along
// z (K2 in solve_only mode, ops/strided.leading_solve) gives
// x = D2z f + D2x f + D2y f: `laplacian` on a periodic d2 scheme.
//
// Replaces: cfd_tpu/ops/pallas_lap.py `_lap_rhs_kernel` (called by
// `_call_lap_rhs`), which streams z-slabs of f through a ring of three in
// VMEM and applies the pair kernels' x and y fold bodies to each slab.
//
// Bound on Hopper: by its work, bytes. The least it must move is 1 read and
// 1 write of f32 per point (2 passes, 134 MB at 256^3, 537 MB or 0.160 ms
// at 3.35 TB/s at (64, 128, 8192)); its ~64 flops per point take far less.
// It is K3's z-RHS family alone: one family of xy_phase.cuh (a y phase and
// an x phase, counted as one call by the wrapper), K6's structure with the
// d2 scheme and f as sy, sx and bz. The y phase (`xy_y_kernel<K, XY_RHS>`)
// stages C columns' y-lines of h = T_z f, formed from three planes, solves
// them in y-tile sub-block chains and stores D2y h + B_z f once. That moves
// 5 passes, not 2: f read in both phases and the x phase's
// read-modify-write of r.
//
// Design of the x phase (xy_phase.cuh `xy_chain_launch`): K1's sub-block
// Thomas chains (line_chains.cuh). Each block stages L lines of h = T_z f,
// each line's T_z row made once, into the chain layout; each line is cut
// into ops/lane.py `line_nb(nx)` sub-blocks of >= 32 rows (128 chains of 64
// rows at nx = 8192, 8 of 32 at 256; one chain, the whole line, where no
// divisor leaves 32 rows), one thread a chain, and the block adds D2x h
// into r, coalesced. Where one thread walked a whole staged line (the form
// this replaced), a block at nx = 8192 had one busy thread.

#include "xy_phase.cuh"

// f, r: (nz, ny, nx); r does not alias f. c2y with tab2y, nby, hy, winy: the
// periodic d2 scheme along y (scaled by 1/dy^2), its chain table (ops/lane.py
// `chain_table`) for nby sub-blocks a y-line; c2x with chx, nb, h, win: along
// x (scaled by 1/dx^2), its chain table for nb sub-blocks a line; bt, tt: its
// z tables (nz, 2W + 1), scaled by 1/dz^2, and (nz, 3).
extern "C" int cfd_lap_rhs(const float* f, float* r, const float* tab2y, const float* chx,
                           const float* bt, const float* tt, const Coef* c2y, const Coef* c2x,
                           int nz, int W, int nby, int hy, int winy, int nb, int h, int win,
                           void* stream) {
  XYArgs a = xy_args(tab2y, tab2y, nullptr, nullptr, c2y, c2y, c2x, c2x, bt, tt, nz, W);
  a.fam[0] = {f, f, nullptr, nullptr, f, r, 0, 1};
  a.nfam = 1;
  xy_y_chains(a, 0, nby, hy, winy);
  xy_chain_table(a, 0, chx, nb, h, win);
  return xy_chain_launch<XY_RHS>(a, stream);
}
