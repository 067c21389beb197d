// K11 `lane_dist`: one shard's local solve of a distributed compact
// derivative along the contiguous (last) axis, x-lines of a float32 block
// viewed as (lines, n), with w halo lanes on each side and the shard's
// outer interface weights (a, b) per line:
//
//   x = T_r^{-1} rhs(f ⊕ halos) + a * suh + b * slh      (dist_common.cuh)
//
// Replaces: cfd_tpu/ops/pallas_dist.py `_lane_dist_kernel` (roll form,
// first derivatives) and `_lane_dist_fold_kernel` (fold form, second
// derivatives and filters). It computes what they compute, with the stencil
// over the halo-extended line, not their 128-lane block inverses for the
// TPU's matrix unit: the two forms are one kernel here, the scheme's tables
// selecting the order.
//
// Bound on Hopper: by its work, bytes. One read of f, one write of x, plus
// the w halo lanes and two weights per line (~(2w + 2) / n of a pass); the
// sweeps are ~30 flops a point, far under the card's rate for the bytes.
// This form stages and stores at about that bound and spends as long again
// on the sweeps, which wait on instruction issue and latency (PERF.md).
//
// Design: sub-block Thomas chains over a tile staged once
// (dist_common.cuh). A block stages L consecutive lines (32, halved until
// they fit 48 KB) in shared memory with 4-byte cp.async copies, coalesced,
// each line as [halo left | f | halo right] at an odd stride, and runs
// L * nb threads: thread (line l, chain k) with l = threadIdx.x % L, so
// that a warp is one chain of 32 lines, their rows in 32 different banks,
// and every table read a broadcast. The sweeps run in place in the tile,
// the backward sweep adding the intra and the shard update; the block then
// writes the lines back coalesced. A 128^3 shard runs 65536 chains of 32
// rows, where one warp of four solved each block's 32 lines, 16384 chains
// of 128.

#include "dist_common.cuh"

__host__ __device__ __forceinline__ int lane_dist_ld(int n, int w) { return (n + 2 * w) | 1; }

static int lane_dist_optin[DIST_MAX_DEVICES];

// K = c.K, the scheme's widest offset (1, 2 or 3), is the halo's depth.
template <int K>
__global__ void __launch_bounds__(32 * DIST_MAX_NB)
    lane_dist_kernel(const float* __restrict__ f, const float* __restrict__ hl,
                     const float* __restrict__ hr, const float* __restrict__ ab,
                     float* __restrict__ out, const float* __restrict__ tab,
                     const __grid_constant__ Coef c, long long lines, int lines_per_block,
                     int nb, int first, int last) {
  extern __shared__ float tile[];
  const int n = c.n;
  const int ld = lane_dist_ld(n, K);
  const int L = lines_per_block;
  float* faces = tile + L * ld;  // faces[j * L + l], j < 2 nb
  const long long line0 = (long long)blockIdx.x * L;
  const long long rest = lines - line0;
  const int nl = rest < L ? (int)rest : L;
  const int count = nl * n;
  const float* fb = f + line0 * n;
  float* ob = out + line0 * n;

  // element e = l * n + i of the block's lines, walked without a division
  const int step_l = blockDim.x / n;
  const int step_i = blockDim.x - step_l * n;
  auto walk = [&](auto&& body) {
    int l = threadIdx.x / n;
    int i = threadIdx.x - l * n;
    for (int e = threadIdx.x; e < count; e += blockDim.x) {
      body(e, l * ld + K + i);
      l += step_l;
      i += step_i;
      if (i >= n) {
        i -= n;
        ++l;
      }
    }
  };
  walk([&](int e, int at) { cp_async4(tile + at, fb + e); });
  for (int e = threadIdx.x; e < nl * K; e += blockDim.x) {
    const int l = e / K;
    const int j = e - l * K;
    cp_async4(tile + l * ld + j, hl + line0 * K + e);
    cp_async4(tile + l * ld + K + n + j, hr + line0 * K + e);
  }
  const int l = threadIdx.x % L;
  const int k = threadIdx.x / L;
  float a = 0.f, b = 0.f;
  if (l < nl) {
    a = __ldg(ab + (line0 + l) * 2);
    b = __ldg(ab + (line0 + l) * 2 + 1);
  }
  cp_async_wait_all();
  __syncthreads();

  // a line past the block's last (l >= nl) runs on whatever its slot holds
  // and is never written back
  float* line = tile + l * ld + K;  // line[m] = f[m], -K <= m < n + K
  solve_chain<K, true>(c, dist_rows(tab), nb, k, line, 1, first, last, faces + l, L, a, b,
                       [&](int g, float v) { line[g] = v; });
  __syncthreads();

  walk([&](int e, int at) { ob[e] = tile[at]; });
}

// `lines` lines of n = c->n points; hl, hr (lines, w) with w = c->K; ab
// (lines, 2); tab from ops/dist.py `_launch_tables` with nb = pick_nb(n)
// sub-blocks. A block stages 32 lines, halved until they fit 48 KB; a line
// longer than that returns cudaErrorInvalidValue. The block's face slots
// (2 nb floats a line) come on top, past 48 KB only for a block of one
// line just under it, which the opt-in covers.
extern "C" int cfd_lane_dist(const float* f, const float* hl, const float* hr, const float* ab,
                             float* out, const float* tab, const Coef* c, long long lines,
                             int nb, int first, int last, void* stream) {
  const size_t line_bytes = (size_t)lane_dist_ld(c->n, c->K) * sizeof(float);
  if (line_bytes > DIST_SMEM_DEFAULT) return (int)cudaErrorInvalidValue;
  int per_block = 32;
  while (per_block > 1 && per_block * line_bytes > DIST_SMEM_DEFAULT) per_block /= 2;
  const size_t smem = per_block * (line_bytes + 2 * nb * sizeof(float));
  if (smem > DIST_SMEM_DEFAULT) {
    const void* kernels[3] = {(const void*)lane_dist_kernel<1>, (const void*)lane_dist_kernel<2>,
                              (const void*)lane_dist_kernel<3>};
    int limit;
    const cudaError_t err = dist_smem_limit(lane_dist_optin, kernels, 3, &limit);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (lines + per_block - 1) / per_block;
  const int threads = per_block * nb;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c->K) {
    case 1:
      lane_dist_kernel<1><<<(unsigned)blocks, threads, smem, s>>>(f, hl, hr, ab, out, tab, *c,
                                                                  lines, per_block, nb, first,
                                                                  last);
      break;
    case 2:
      lane_dist_kernel<2><<<(unsigned)blocks, threads, smem, s>>>(f, hl, hr, ab, out, tab, *c,
                                                                  lines, per_block, nb, first,
                                                                  last);
      break;
    case 3:
      lane_dist_kernel<3><<<(unsigned)blocks, threads, smem, s>>>(f, hl, hr, ab, out, tab, *c,
                                                                  lines, per_block, nb, first,
                                                                  last);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
