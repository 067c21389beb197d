// K2 `compact_strided`: compact derivative along a strided axis of a float32
// field viewed as (outer, n, inner), the line running along the middle
// axis: dfdy is (nz, ny, nx), dfdz is (1, nz, ny * nx).
//
// Replaces: cfd_tpu/ops/pallas_sublane.py `_sublane_kernel` (roll form along
// the second-minor axis, dfdy) and `_sublane_fold_kernel` (fold form, d2y),
// and cfd_tpu/ops/pallas_leading.py `_leading_kernel` in its plain
// derivative mode (dfdz; d2z, which the JAX package sends to a dense
// product). The TPU needed these kernels because its (8, 128) tiling treats
// the second-minor and the leading axis differently; on Hopper both are the
// same strided walk with x contiguous. It computes T f' = B f / dx**order with the
// scheme's interior stencil, closure rows and periodic wrap as one Thomas
// solve per line (plus a Sherman–Morrison rank-1 term on periodic lines).
//
// Bound on Hopper: by its work, bytes. This simple form moves two reads and
// two writes of f32 per point: the forward sweep reads f and writes its
// intermediate into `out`, the backward sweep reads it back and writes f'.
// The rank-1 periodic term rides the backward sweep (see solve_line), so
// periodic lines move no more.
//
// Design: one thread owns one (outer, inner) column and walks it down the
// line; neighbouring threads take neighbouring `inner`, so every row access
// of a warp is one coalesced 128-byte line, and each row of f is read once
// (solve_line's window). Offsets are 64-bit (outer * n * inner passes 2^31
// at 1024^3). At 256^3 there are only 65,536 columns, about 500 threads per
// SM, all resident at once, and each row waits about one memory latency:
// the kernel is latency-bound at ~1.5x its byte floor (PERF.md). Splitting
// each line into interleaved chains with a reduced interface solve, as
// pallas_leading.py does, multiplies the parallelism; that is later work.

#include "compact_common.cuh"

__global__ void compact_strided_kernel(const float* __restrict__ f,
                                       float* __restrict__ out,
                                       const float* __restrict__ tab,
                                       const __grid_constant__ Coef c,
                                       long long outer, long long inner) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= outer * inner) return;
  const long long o = col / inner;
  const long long j = col - o * inner;
  const long long base = o * c.n * inner + j;
  const float* fc = f + base;
  const int n = c.n;
  auto src = [&](int m) {
    if (m >= n) {
      if (!c.periodic) return 0.f;
      m %= n;
    }
    return __ldg(fc + m * inner);
  };
  solve_line(c, tab, src, out + base, inner);
}

#define STRIDED_THREADS 128  // columns per block

extern "C" int cfd_compact_strided(const float* f, float* out,
                                   const float* tab, const Coef* c,
                                   long long outer, long long inner,
                                   void* stream) {
  const long long blocks = (outer * inner + STRIDED_THREADS - 1) / STRIDED_THREADS;
  compact_strided_kernel<<<(unsigned)blocks, STRIDED_THREADS, 0,
                           (cudaStream_t)stream>>>(f, out, tab, *c, outer,
                                                   inner);
  return (int)cudaGetLastError();
}
