// K7 `gradient_pair`: the compact first derivatives along x and along y of a
// float32 field viewed as (planes, ny, nx), both in one launch:
//
//   gx = D1x f,   gy = D1y f
//
// with D1 any first-derivative scheme (periodic or with closure rows).
// `gradient` takes it for (dfdx, dfdy) and K2 for dfdz; the non-periodic
// `curl` takes it for uz's two derivatives.
//
// Replaces: cfd_tpu/ops/pallas_pair.py `_pair_kernel` (called by
// `_call_pair`), which holds one (ny, nx) plane in VMEM, so that f is read
// from HBM once for both axes, and applies the lane and sublane block
// bodies to it.
//
// Bound on Hopper: by its work, bytes. The least it must move is 1 read and
// 2 writes of f32 per point (3 passes, 201 MB at 256^3); its ~52 flops per
// point take far less. A 256^2 plane (256 KB) does not fit a block's 227 KB
// of shared memory, so this kernel does not hold a plane. Its blocks are of
// two kinds, dealt out in one launch: a y block walks 128 (plane, x)
// columns down y as K2 does (the forward sweep kept in gy, the backward
// sweep reading it back), and an x block stages 32 consecutive x-lines in
// shared memory as K1 does, solves them in place and writes them to gx.
// The two kinds are interleaved in block order in proportion to their
// counts, so the blocks resident at one time read the same few planes and
// f's second read is mostly an L2 hit: ~2 passes of f from HBM, ~5 in all
// with gy's scratch round trip. Both kinds are latency-bound line
// recurrences, as K1 and K2 are; the gain over K1 + K2 is that they share
// the card in one launch (PERF.md). A cluster of blocks holding a plane in
// distributed shared memory is the way to one read of f.

#include "compact_common.cuh"

#define PAIR_THREADS 128           // y block: columns; x block: >= its lines
#define PAIR_LINES 32              // x block: lines staged, halved to fit
#define PAIR_SMEM (48 * 1024)      // x block: bytes staged (no opt-in)

__global__ void __launch_bounds__(PAIR_THREADS) pair_kernel(
    const float* __restrict__ f, float* __restrict__ gx, float* __restrict__ gy,
    const float* __restrict__ tabx, const float* __restrict__ taby,
    const __grid_constant__ Coef cx, const __grid_constant__ Coef cy, long long planes,
    long long yblocks, long long xblocks, int lines_per_block) {
  extern __shared__ float tile[];
  const long long b = blockIdx.x;
  const long long total = yblocks + xblocks;
  const long long yk = b * yblocks / total;  // y blocks before this one
  const int nx = cx.n, ny = cy.n;

  if ((b + 1) * yblocks / total > yk) {  // y block yk: K2's walk, (planes, ny, nx)
    const long long col = yk * PAIR_THREADS + threadIdx.x;
    if (col >= planes * nx) return;
    const long long o = col / nx;
    const long long base = o * ny * nx + (col - o * nx);
    const float* fc = f + base;
    auto src = [&](int m) {
      if (m >= ny) {
        if (!cy.periodic) return 0.f;
        m %= ny;
      }
      return __ldg(fc + (long long)m * nx);
    };
    solve_line(cy, taby, src, gy + base, nx);
    return;
  }

  // x block b - yk: K1's staged lines
  const long long lines = planes * ny;
  const long long line0 = (b - yk) * lines_per_block;
  const long long rest = lines - line0;
  const int nl = rest < lines_per_block ? (int)rest : lines_per_block;
  const int count = nl * nx;
  const int ld = cfd_line_ld(nx);
  const float* fb = f + line0 * nx;
  float* ob = gx + line0 * nx;

  float* const tiles[1] = {tile};
  stage_lines(tiles, count, nx, [&](int e, float* v) { v[0] = __ldg(fb + e); });
  __syncthreads();

  if (threadIdx.x < nl) {
    float* line = tile + threadIdx.x * ld;
    wrap_line(line, nx);
    solve_line(cx, tabx, [&](int m) { return line[m]; }, line, 1);
  }
  __syncthreads();

  for (int e0 = threadIdx.x; e0 < count; e0 += CFD_STAGE_BATCH * blockDim.x) {
#pragma unroll
    for (int u = 0; u < CFD_STAGE_BATCH; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < count) {
        const int l = e / nx;
        ob[e] = tile[l * ld + (e - l * nx)];
      }
    }
  }
}

// f, gx, gy: (planes, ny, nx); no output aliases f. tabx/cx, taby/cy: the d1
// scheme along x (n = nx, scaled by 1/dx) and along y (n = ny, by 1/dy). An
// x-line past 48 KB returns cudaErrorInvalidValue.
extern "C" int cfd_gradient_pair(const float* f, float* gx, float* gy, const float* tabx,
                                 const float* taby, const Coef* cx, const Coef* cy,
                                 long long planes, void* stream) {
  const size_t line_bytes = (size_t)cfd_line_ld(cx->n) * sizeof(float);
  if (planes < 1 || line_bytes > PAIR_SMEM) return (int)cudaErrorInvalidValue;
  int per_block = PAIR_LINES;
  while (per_block > 1 && per_block * line_bytes > PAIR_SMEM) per_block /= 2;
  const long long yblocks = (planes * cx->n + PAIR_THREADS - 1) / PAIR_THREADS;
  const long long xblocks = (planes * cy->n + per_block - 1) / per_block;
  if (yblocks + xblocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  pair_kernel<<<(unsigned)(yblocks + xblocks), PAIR_THREADS, per_block * line_bytes,
                (cudaStream_t)stream>>>(f, gx, gy, tabx, taby, *cx, *cy, planes, yblocks,
                                         xblocks, per_block);
  return (int)cudaGetLastError();
}
