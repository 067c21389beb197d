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
// solve (solve_lines_tables).
//
// Bound on Hopper: by its work, bytes. One read of f, of the halo rows and
// of the weight planes, and one write of x; the sweeps are ~30 flops a
// point, far under the card's rate for the bytes. This form stages and
// stores at about that bound and spends as long again on the sweeps, which
// wait on instruction issue and latency (PERF.md).
//
// Design: sub-block Thomas chains over a tile staged once
// (dist_common.cuh). A block takes `cols` (32) consecutive `inner` columns
// of one `outer` index and stages [hl (w rows); f (n rows); hr (w rows)]
// of them in shared memory with cp.async, 16-byte copies where the rows
// are aligned: (n + 2w) * 128 bytes, 16.8 KB at n = 128. It runs cols * nb
// threads, warp k being chain k of the 32 columns, so that every row access
// of a warp is 32 consecutive floats of shared memory (no bank conflict)
// and every table read a broadcast. The forward sweeps run in place in the
// tile; the backward sweeps store x straight to device memory, 32
// consecutive floats a row and warp. A 128^3 shard runs 65536 chains of 32
// rows, where one thread per column ran 16384 chains of 128. Long lines
// take fewer columns a block (down to 1) so that the tile fits 48 KB, then
// up to the device's opt-in maximum of shared memory.

#include <cstdint>

#include "dist_common.cuh"

#define STRIDED_DIST_COLS 32  // columns a block takes

static int strided_dist_optin[DIST_MAX_DEVICES];

// K = c.K, the scheme's widest offset (1, 2 or 3), is the halo's depth.
template <int K, bool AB>
__global__ void __launch_bounds__(STRIDED_DIST_COLS * DIST_MAX_NB)
    strided_dist_kernel(const float* __restrict__ f, const float* __restrict__ hl,
                        const float* __restrict__ hr, const float* __restrict__ ab,
                        float* __restrict__ out, const float* __restrict__ tab,
                        const __grid_constant__ Coef c, long long inner, int cols, int nb,
                        int aligned, int first, int last) {
  extern __shared__ __align__(16) float smem[];
  const int n = c.n;
  const int rows = n + 2 * K;
  float* tile = smem;                 // tile[(m + K) * cols + col] = f[m] of column col
  float* faces = smem + rows * cols;  // faces[j * cols + col], j < 2 nb
  const long long col_blocks = (inner + cols - 1) / cols;
  const long long o = blockIdx.x / col_blocks;
  const long long j0 = (blockIdx.x - o * col_blocks) * cols;
  const int valid = inner - j0 < cols ? (int)(inner - j0) : cols;

  // row r of the tile: hl, f or hr at column j0
  auto row = [&](int r) -> const float* {
    const int m = r - K;
    if (m < 0) return hl + (o * K + r) * inner + j0;
    if (m < n) return f + (o * n + m) * inner + j0;
    return hr + (o * K + m - n) * inner + j0;
  };
  if (aligned && valid == cols) {
    const int quads = cols / 4;
    for (int q = threadIdx.x; q < rows * quads; q += blockDim.x) {
      const int r = q / quads;
      const int c4 = 4 * (q - r * quads);
      cp_async16(tile + r * cols + c4, row(r) + c4);
    }
  } else {
    for (int q = threadIdx.x; q < rows * cols; q += blockDim.x) {
      const int r = q / cols;
      const int cc = q - r * cols;
      const float* src = row(r);
      cp_async4(tile + r * cols + cc, cc < valid ? src + cc : src, cc < valid);
    }
  }

  const int col = threadIdx.x % cols;
  const int k = threadIdx.x / cols;
  const long long j = j0 + col;
  float a = 0.f, b = 0.f;
  if (AB && col < valid) {
    a = __ldg(ab + 2 * o * inner + j);
    b = __ldg(ab + (2 * o + 1) * inner + j);
  }
  cp_async_wait_all();
  __syncthreads();

  float* oc = out + o * n * inner + j;
  solve_chain<K, AB>(c, dist_rows(tab), nb, k, tile + K * cols + col, cols, first, last,
                     faces + col, cols, a, b, [&](int g, float v) {
                       if (col < valid) oc[(long long)g * inner] = v;
                     });
}

template <int K, bool AB>
static void strided_dist_launch(const float* f, const float* hl, const float* hr,
                                const float* ab, float* out, const float* tab, const Coef* c,
                                long long blocks, int threads, size_t smem, long long inner,
                                int cols, int nb, int aligned, int first, int last,
                                cudaStream_t s) {
  strided_dist_kernel<K, AB><<<(unsigned)blocks, threads, smem, s>>>(
      f, hl, hr, ab, out, tab, *c, inner, cols, nb, aligned, first, last);
}

// f (outer, n, inner) with n = c->n; hl, hr (outer, w, inner) with w = c->K;
// ab (outer, 2, inner) or null (no interface update); tab from ops/dist.py
// `_launch_tables` with nb = pick_nb(n) sub-blocks. A line whose tile of
// one column passes the device's opt-in maximum of shared memory returns
// cudaErrorInvalidValue.
extern "C" int cfd_strided_dist(const float* f, const float* hl, const float* hr,
                                const float* ab, float* out, const float* tab, const Coef* c,
                                long long outer, long long inner, int nb, int first, int last,
                                void* stream) {
  const void* kernels[6] = {
      (const void*)strided_dist_kernel<1, true>, (const void*)strided_dist_kernel<1, false>,
      (const void*)strided_dist_kernel<2, true>, (const void*)strided_dist_kernel<2, false>,
      (const void*)strided_dist_kernel<3, true>, (const void*)strided_dist_kernel<3, false>};
  int limit;
  cudaError_t err = dist_smem_limit(strided_dist_optin, kernels, 6, &limit);
  if (err != cudaSuccess) return (int)err;
  const size_t col_bytes = (size_t)(c->n + 2 * c->K + 2 * nb) * sizeof(float);
  int cols = STRIDED_DIST_COLS;
  while (cols > 1 && cols / 2 >= inner) cols /= 2;
  while (cols > 1 && cols * col_bytes > DIST_SMEM_DEFAULT) cols /= 2;
  if (cols * col_bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  const int aligned = cols % 4 == 0 && inner % 4 == 0 &&
                      ((uintptr_t)f | (uintptr_t)hl | (uintptr_t)hr) % 16 == 0;
  const long long blocks = outer * ((inner + cols - 1) / cols);
  const size_t smem = cols * col_bytes;
  cudaStream_t s = (cudaStream_t)stream;
#define STRIDED_DIST_ARGS f, hl, hr, ab, out, tab, c, blocks, cols * nb, smem, inner, cols, nb, \
                          aligned, first, last, s
  switch (c->K * 2 + (ab ? 1 : 0)) {
    case 2: strided_dist_launch<1, false>(STRIDED_DIST_ARGS); break;
    case 3: strided_dist_launch<1, true>(STRIDED_DIST_ARGS); break;
    case 4: strided_dist_launch<2, false>(STRIDED_DIST_ARGS); break;
    case 5: strided_dist_launch<2, true>(STRIDED_DIST_ARGS); break;
    case 6: strided_dist_launch<3, false>(STRIDED_DIST_ARGS); break;
    case 7: strided_dist_launch<3, true>(STRIDED_DIST_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef STRIDED_DIST_ARGS
  return (int)cudaGetLastError();
}
