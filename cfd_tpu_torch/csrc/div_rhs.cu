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
// 1 write of f32 per point (4 passes, 268 MB at 256^3, 1.07 GB or 0.3205 ms
// at 3.35 TB/s at (64, 128, 8192)); its ~64 flops per point take far less.
// It is one z-RHS family of xy_phase.cuh (a y phase and an x phase, counted
// as one call by the wrapper), K9's structure with the d1 scheme, uy as sy,
// ux as sx and uz as bz: the y phase (`xy_y_kernel<K, XY_RHS>`) stages C
// columns' y-lines of T_z uy, formed from three planes, solves them in
// y-tile sub-block chains and stores D1y (T_z uy) + B_z uz once. That moves
// 6 passes, not 4: the x phase's read-modify-write of r.
//
// Design of the x phase (xy_phase.cuh `xy_chain_launch`, as K9's): K1's
// sub-block Thomas chains (line_chains.cuh). Each block stages L lines of
// T_z ux, each line's T_z row made once, into the chain layout; each line
// is cut into ops/lane.py `line_nb(nx)` sub-blocks of >= 32 rows (128
// chains of 64 rows at nx = 8192, 8 of 32 at 256; one chain, the whole
// line, where no divisor leaves 32 rows), one thread a chain, and the block
// adds D1x (T_z ux) into r, coalesced. Where one thread walked a whole
// staged line (the form this replaced), a block at nx = 8192 had one busy
// thread, and a line past 48 KB (nx > 12278) was refused; a block now opts
// into the larger shared memory for it.

#include "xy_phase.cuh"

// ux, uy, uz, r: (nz, ny, nx); r aliases no input. c1y with tab1y, nby, hy,
// winy: the d1 scheme along y (scaled by 1/dy), its chain table (ops/lane.py
// `chain_table`) for nby sub-blocks a y-line; c1x with chx, nb, h, win: along
// x (scaled by 1/dx), its chain table for nb sub-blocks a line; bt, tt: its z
// tables (nz, 2W + 1), scaled by 1/dz, and (nz, 3).
extern "C" int cfd_div_rhs(const float* ux, const float* uy, const float* uz, float* r,
                           const float* tab1y, const float* chx, const float* bt, const float* tt,
                           const Coef* c1y, const Coef* c1x, int nz, int W, int nby, int hy,
                           int winy, int nb, int h, int win, void* stream) {
  XYArgs a = xy_args(tab1y, tab1y, nullptr, nullptr, c1y, c1y, c1x, c1x, bt, tt, nz, W);
  a.fam[0] = {uy, ux, nullptr, nullptr, uz, r, 0, 1};
  a.nfam = 1;
  xy_y_chains(a, 0, nby, hy, winy);
  xy_chain_table(a, 0, chx, nb, h, win);
  return xy_chain_launch<XY_RHS>(a, stream);
}
