// K13 `advection_pair`: the advection term in x and y of a float32 field
// viewed as (planes, ny, nx):
//
//   out = ux D1x f + uy D1y f
//
// with D1 any first-derivative scheme (periodic, or with closure rows). It
// is the stepwise head of the fused RK3 substep (ops/fused_step.py) on
// x-lines too long for K3, whose x phase stages two lines per line (f for
// this family and T_z f for the Laplacian's) and stops at nx = 6134; the
// substep routes K13 up to nx = 12278 (ops/pair.py `adv_pair_supported`),
// and the kernel takes any line an opted-in block holds.
//
// Replaces: cfd_tpu/ops/pallas_pair.py `_adv_pair_kernel` (called by
// `_call_adv_pair`), which holds one (ny, nx) plane in VMEM, applies the
// pair kernel's x and y block bodies to it and weights them by the
// velocity in the resident output tile.
//
// Bound on Hopper: by its work, bytes. The least it must move is 3 reads
// (f, ux, uy) and 1 write of f32 per point (4 passes, 268 MB at 256^3,
// 1.07 GB or 0.3205 ms at 3.35 TB/s at (64, 128, 8192)); its two line
// solves are ~52 flops a point. It is one advection family of
// xy_phase.cuh, alone (K3's first family without the second): the y phase
// (`xy_y_kernel<K, XY_ADV>`) stages C columns' y-lines of f with cp.async,
// solves them in y-tile sub-block chains and stores uy D1y f once. That
// moves 7 passes (the output's read-modify-write and f read in both
// phases).
//
// Design of the x phase (xy_phase.cuh `xy_chain_launch`): K1's sub-block
// Thomas chains (line_chains.cuh). Each block stages L x-lines of f with
// cp.async into the chain layout; each line is cut into ops/lane.py
// `line_nb(nx)` sub-blocks of >= 32 rows (128 chains of 64 rows at nx =
// 8192; one chain, the whole line, where no divisor leaves 32 rows), one
// thread a chain, and the block adds ux D1x f into the output, coalesced.
// Where one thread walked a whole staged line (the form this replaced), a
// block at nx = 8192 had one busy thread.

#include "xy_phase.cuh"

// f, ux, uy, out: (planes, ny, nx); out aliases no input. cy with taby, nby,
// hy, winy: the d1 scheme along y (n = ny, scaled by 1/dy), its chain table
// (ops/lane.py `chain_table`) for nby sub-blocks a y-line; cx with chx, nb, h,
// win: along x (n = nx, scaled by 1/dx), its chain table for nb sub-blocks a
// line.
extern "C" int cfd_adv_pair(const float* f, const float* ux, const float* uy, float* out,
                            const float* taby, const float* chx, const Coef* cy, const Coef* cx,
                            int planes, int nby, int hy, int winy, int nb, int h, int win,
                            void* stream) {
  XYArgs a = xy_args(taby, taby, nullptr, nullptr, cy, cy, cx, cx, nullptr, nullptr, planes, 0);
  a.fam[0] = {f, f, uy, ux, nullptr, out, 0, 0};
  a.nfam = 1;
  xy_y_chains(a, 0, nby, hy, winy);
  xy_chain_table(a, 0, chx, nb, h, win);
  return xy_chain_launch<XY_ADV>(a, stream);
}
