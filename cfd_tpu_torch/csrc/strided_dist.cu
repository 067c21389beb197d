// K12 `strided_dist`: one shard's local solve of a distributed compact
// derivative down a strided axis of a float32 block viewed as (outer, n,
// inner), the line along the middle axis (y: (nz, ny, nx); z: (1, nz,
// ny * nx); the generic route's flat lines: (1, n, B)), with w halo rows on
// each side, (outer, w, inner), and optionally the shard's outer interface
// weights, (outer, 2, inner):
//
//   x = T_r^{-1} rhs(f ⊕ halos) [+ a * suh + b * slh]     (dist_common.cuh)
//
// Replaces: cfd_tpu/ops/pallas_dist.py `_sublane_dist_kernel` (roll form)
// and `_sublane_dist_fold_kernel` (fold form) along y;
// cfd_tpu/ops/pallas_leading.py `_leading_kernel` in its `ext` mode (via
// `_call_leading_dist`) along z; and, without the interface weights,
// cfd_tpu/ops/pallas_fused.py `_fused_kernel` as the generic route's local
// solve (solve_lines_tables). The TPU's nb interleaved sub-block chains
// (pallas_leading.py) are an ILP device of its vector unit; here a plain
// Thomas solve per column, as K2 does.
//
// Bound on Hopper: by its work, bytes. One read of f and one write of x,
// plus the halo and weight planes; this simple form moves two reads and two
// writes per point (the forward sweep keeps its intermediate in `out`, as
// K2) and is latency-bound like K2 (PERF.md).
//
// Design: as K2 (compact_strided.cu). One thread owns one (outer, inner)
// column and walks it down the line, neighbouring threads on neighbouring
// `inner`, so every row access of a warp is coalesced; halo rows are read
// from their own planes where the stencil crosses the shard's ends, and the
// interface update rides the backward sweep's store. Offsets are 64-bit.

#include "dist_common.cuh"

#define STRIDED_DIST_THREADS 128  // columns per block

template <bool AB>
__global__ void strided_dist_kernel(const float* __restrict__ f, const float* __restrict__ hl,
                                    const float* __restrict__ hr, const float* __restrict__ ab,
                                    float* __restrict__ out, const float* __restrict__ tab,
                                    const __grid_constant__ Coef c, long long outer,
                                    long long inner, int first, int last) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= outer * inner) return;
  const long long o = col / inner;
  const long long j = col - o * inner;
  const int n = c.n;
  const int w = c.K;
  const float* fc = f + o * n * inner + j;
  const float* lc = hl + o * w * inner + j;  // lc[k * inner] = f[k - w], 0 <= k < w
  const float* rc = hr + o * w * inner + j;  // rc[k * inner] = f[n + k]
  float* oc = out + o * n * inner + j;
  auto src = [&](int m) {
    if (m < 0) return m >= -w ? __ldg(lc + (m + w) * inner) : 0.f;
    if (m < n) return __ldg(fc + m * inner);
    return m < n + w ? __ldg(rc + (m - n) * inner) : 0.f;
  };
  float a = 0.f, b = 0.f;
  if (AB) {
    a = __ldg(ab + 2 * o * inner + j);
    b = __ldg(ab + (2 * o + 1) * inner + j);
  }
  auto store = [&](int i, float v) {
    if (AB) v += dist_update(tab, n, i, a, b);
    oc[i * inner] = v;
  };
  solve_dist_line(c, tab, src, first, last, oc, inner, store);
}

template <bool AB>
static int strided_dist_launch(const float* f, const float* hl, const float* hr, const float* ab,
                               float* out, const float* tab, const Coef* c, long long outer,
                               long long inner, int first, int last, void* stream) {
  const long long blocks = (outer * inner + STRIDED_DIST_THREADS - 1) / STRIDED_DIST_THREADS;
  strided_dist_kernel<AB><<<(unsigned)blocks, STRIDED_DIST_THREADS, 0, (cudaStream_t)stream>>>(
      f, hl, hr, ab, out, tab, *c, outer, inner, first, last);
  return (int)cudaGetLastError();
}

// f (outer, n, inner) with n = c->n; hl, hr (outer, w, inner) with w = c->K;
// ab (outer, 2, inner) or null (no interface update).
extern "C" int cfd_strided_dist(const float* f, const float* hl, const float* hr,
                                const float* ab, float* out, const float* tab, const Coef* c,
                                long long outer, long long inner, int first, int last,
                                void* stream) {
  if (ab) {
    return strided_dist_launch<true>(f, hl, hr, ab, out, tab, c, outer, inner, first, last,
                                     stream);
  }
  return strided_dist_launch<false>(f, hl, hr, ab, out, tab, c, outer, inner, first, last,
                                    stream);
}
