// K8 `d2_sum`: the xy part of the compact-d2 Laplacian of a float32 field
// viewed as (planes, ny, nx), in one output:
//
//   s = D2x f + D2y f
//
// with D2 any d2 scheme (periodic or with closure rows). `laplacian` on a
// non-periodic d2 scheme is K2 along z with `acc = s` (d2z + s, K2's acc
// epilogue), as the JAX package's `leading_derivative(f, dz, acc=s)`.
//
// Replaces: cfd_tpu/ops/pallas_pair.py `_d2_sum_kernel` (called by
// `_call_d2_sum`), which holds one (ny, nx) plane in VMEM, applies the lane
// and sublane fold bodies to it and sums them in the output tile.
//
// Bound on Hopper: by its work, bytes. The least it must move is 1 read and
// 1 write of f32 per point (2 passes, 134 MB at 256^3); its ~54 flops per
// point take far less. A 256^2 plane (256 KB) does not fit a block's 227 KB
// of shared memory, so the sum is formed in the output: it is one weighted
// family of xy_phase.cuh (wy = wx = 1, no z work), a y phase that walks y
// as K2 does and stores D2y f, then an x phase that stages x-lines of f as
// K1 does and adds D2x f. That moves ~6 passes (f read in each phase, the y
// phase's scratch round trip, the x phase's read-modify-write of s); both
// phases are latency-bound recurrences like K1 and K2 (PERF.md).

#include "xy_phase.cuh"

// f, s: (planes, ny, nx); s does not alias f. tab2y/c2y, tab2x/c2x: the d2
// scheme along y and x (scaled by 1/dy^2 and 1/dx^2).
extern "C" int cfd_d2_sum(const float* f, float* s, const float* tab2y, const float* tab2x,
                          const Coef* c2y, const Coef* c2x, long long planes, void* stream) {
  if (planes < 1 || planes > 0x7fffffff) return (int)cudaErrorInvalidValue;
  XYArgs a = xy_args(tab2y, tab2y, tab2x, tab2x, c2y, c2y, c2x, c2x, nullptr, nullptr,
                     (int)planes, 0);
  a.fam[0] = {f, f, nullptr, nullptr, nullptr, s, 0, 0, 1.f, 1.f, 0.f, 0};
  a.nfam = 1;
  a.weighted = 1;
  return xy_launch(a, stream);
}
