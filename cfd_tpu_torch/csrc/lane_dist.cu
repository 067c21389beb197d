// K11 `lane_dist`: one shard's local solve of a distributed compact
// derivative along the contiguous (last) axis, x-lines of a float32 block
// viewed as (lines, n), with w halo lanes on each side and the shard's
// outer interface weights (a, b) per line:
//
//   x = T_r^{-1} rhs(f ⊕ halos) + a * suh + b * slh      (dist_common.cuh)
//
// Replaces: cfd_tpu/ops/pallas_dist.py `_lane_dist_kernel` (roll form,
// first derivatives) and `_lane_dist_fold_kernel` (fold form, second
// derivatives and filters). It computes what they compute, as one Thomas
// solve per line with the stencil over the halo-extended line, not their
// 128-lane block inverses for the TPU's matrix unit: the two forms are one
// kernel here, the scheme's tables selecting the order.
//
// Bound on Hopper: by its work, bytes. One read of f, one write of x, plus
// the w halo lanes and two weights per line (~(2w + 2) / n of a pass): the
// least any form moves. This simple form is latency-bound like K1 (PERF.md).
//
// Design: as K1 (compact_lane.cu). A block stages L consecutive lines in
// shared memory with coalesced loads, each as [halo left | f | halo right]
// with an odd stride so the 32 lines a warp walks sit in 32 banks; one
// thread per line runs the forward sweep, forming the RHS from shared
// memory (closure rows on the line's physical ends), and the backward sweep
// in place; the block writes the lines back coalesced, adding the rank-2
// interface update there.

#include "dist_common.cuh"

#define LANE_DIST_THREADS 128  // >= the most lines a block stages
#define LANE_DIST_SMEM (48 * 1024)

__host__ __device__ __forceinline__ int lane_dist_ld(int n, int w) { return (n + 2 * w) | 1; }

__global__ void lane_dist_kernel(const float* __restrict__ f, const float* __restrict__ hl,
                                 const float* __restrict__ hr, const float* __restrict__ ab,
                                 float* __restrict__ out, const float* __restrict__ tab,
                                 const __grid_constant__ Coef c, long long lines,
                                 int lines_per_block, int first, int last) {
  extern __shared__ float tile[];
  const int n = c.n;
  const int w = c.K;
  const int ld = lane_dist_ld(n, w);
  const long long line0 = (long long)blockIdx.x * lines_per_block;
  const long long rest = lines - line0;
  const int nl = rest < lines_per_block ? (int)rest : lines_per_block;
  const int count = nl * n;
  const float* fb = f + line0 * n;

  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int l = e / n;
    tile[l * ld + w + (e - l * n)] = __ldg(fb + e);
  }
  for (int e = threadIdx.x; e < nl * w; e += blockDim.x) {
    const int l = e / w;
    const int j = e - l * w;
    tile[l * ld + j] = __ldg(hl + line0 * w + e);
    tile[l * ld + w + n + j] = __ldg(hr + line0 * w + e);
  }
  __syncthreads();

  if (threadIdx.x < nl) {
    float* line = tile + threadIdx.x * ld + w;  // line[m] = f[m], -w <= m < n + w
    auto src = [&](int m) { return m >= -w && m < n + w ? line[m] : 0.f; };
    solve_dist_line(c, tab, src, first, last, line, 1, [&](int i, float v) { line[i] = v; });
  }
  __syncthreads();

  float* ob = out + line0 * n;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int l = e / n;
    const int i = e - l * n;
    const float* abl = ab + (line0 + l) * 2;
    ob[e] = tile[l * ld + w + i] + dist_update(tab, n, i, __ldg(abl), __ldg(abl + 1));
  }
}

// `lines` lines of n = c->n points; hl, hr (lines, w) with w = c->K; ab
// (lines, 2). A block stages 32 lines, halved until they fit 48 KB; a line
// longer than that returns cudaErrorInvalidValue.
extern "C" int cfd_lane_dist(const float* f, const float* hl, const float* hr, const float* ab,
                             float* out, const float* tab, const Coef* c, long long lines,
                             int first, int last, void* stream) {
  const size_t line_bytes = (size_t)lane_dist_ld(c->n, c->K) * sizeof(float);
  if (line_bytes > LANE_DIST_SMEM) return (int)cudaErrorInvalidValue;
  int per_block = 32;
  while (per_block > 1 && per_block * line_bytes > LANE_DIST_SMEM) per_block /= 2;
  const long long blocks = (lines + per_block - 1) / per_block;
  lane_dist_kernel<<<(unsigned)blocks, LANE_DIST_THREADS, per_block * line_bytes,
                     (cudaStream_t)stream>>>(f, hl, hr, ab, out, tab, *c, lines, per_block,
                                             first, last);
  return (int)cudaGetLastError();
}
