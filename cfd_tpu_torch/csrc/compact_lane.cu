// K1 `compact_lane`: compact derivative along the contiguous (last) axis of
// a float32 field viewed as (lines, n).
//
// Replaces: cfd_tpu/ops/pallas_lane.py `_lane_fold_kernel` (the fold form,
// n <= 256; first and second derivatives) and `_lane_kernel` (the roll
// form, n > 256; first derivative). It computes what they compute,
// T f' = B f / dx**order with the scheme's interior stencil, closure rows
// and periodic wrap, as one Thomas solve per line
// (plus a Sherman–Morrison rank-1 term on periodic lines), not their
// block-matrix algebra for the TPU's matrix unit.
//
// With `acc` the write-back adds it, out = f' + acc (a separate
// instantiation, so the plain derivative pays nothing for it): with a
// negative spacing that is pallas_pair.py `_pair_sub_kernel`'s x half,
// ax - dphi/dx (ops/pair.py), and dphi/dx never makes a round trip through
// memory.
//
// Bound on Hopper: by its work, bytes. One read and one write of f32 per
// point (and one more read with acc) is the least any form can move, and
// the sweeps are ~15 flops per point. This simple form is bound instead by
// the latency of its sweeps, at ~3.8x the copy floor at 256^3 (design
// below).
//
// Design: a block takes L consecutive lines and stages them in shared
// memory with coalesced loads, eight in flight per thread, so that HBM sees
// one read and one write per point (staging and write-back alone run at the
// copy floor on an H100). One thread per line then runs the forward sweep,
// forming the RHS from shared memory as it goes, and the backward sweep,
// both in place (solve_line). The row stride is n + 9, rounded up to odd:
// the 9 extra slots hold the line's first values for the periodic wrap,
// and an odd stride puts the 32 lines a warp walks in 32 different banks.
// The block writes the lines back coalesced. L is chosen from n at launch
// (32 lines at n = 256, 16 at n = 512) so that a block fits 48 KB. The
// sweeps bound the kernel: shared memory holds ~200 lines per SM, and each
// row of a sweep waits on latency (PERF.md). Splitting each line into
// chains with a reduced interface solve, as pallas_leading.py does, is the
// way to more lines in flight; that is later work.

#include "compact_common.cuh"

template <bool ACC>
__global__ void compact_lane_kernel(const float* __restrict__ f,
                                    float* __restrict__ out,
                                    const float* __restrict__ tab,
                                    const __grid_constant__ Coef c,
                                    const float* __restrict__ acc,  // ACC only
                                    long long lines, int lines_per_block) {
  extern __shared__ float tile[];
  const int n = c.n;
  const int ld = cfd_line_ld(n);
  const long long line0 = (long long)blockIdx.x * lines_per_block;
  const long long rest = lines - line0;
  const int nl = rest < lines_per_block ? (int)rest : lines_per_block;
  const int count = nl * n;
  const float* fb = f + line0 * n;
  float* ob = out + line0 * n;
  const float* ab = ACC ? acc + line0 * n : nullptr;

  float* const tiles[1] = {tile};
  stage_lines(tiles, count, n, [&](int e, float* v) { v[0] = __ldg(fb + e); });
  __syncthreads();

  if (threadIdx.x < nl) {
    float* line = tile + threadIdx.x * ld;
    wrap_line(line, n);
    solve_line(c, tab, [&](int m) { return line[m]; }, line, 1);
  }
  __syncthreads();

  for (int e0 = threadIdx.x; e0 < count; e0 += CFD_STAGE_BATCH * blockDim.x) {
#pragma unroll
    for (int u = 0; u < CFD_STAGE_BATCH; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < count) {
        const int l = e / n;
        const float v = tile[l * ld + (e - l * n)];
        ob[e] = ACC ? v + __ldg(ab + e) : v;
      }
    }
  }
}

#define LANE_THREADS 128               // >= the most lines a block stages
#define LANE_SMEM_DEFAULT (48 * 1024)  // bytes a block gets without opting in
#define LANE_MAX_DEVICES 64

// Per device: the dynamic shared memory the kernel has been opted in to
// (the device's per-block maximum), 0 until its first launch there.
static int lane_smem_optin[LANE_MAX_DEVICES];

static cudaError_t lane_smem_limit(int* bytes) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= LANE_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!lane_smem_optin[dev]) {
    int most;
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(compact_lane_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(compact_lane_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    lane_smem_optin[dev] = most;
  }
  *bytes = lane_smem_optin[dev];
  return cudaSuccess;
}

// Lines of length n = c->n, `lines` of them; acc may be null. A block
// stages 32 lines, halved until they fit 48 KB; a line longer than the
// device's opt-in maximum of shared memory returns cudaErrorInvalidValue.
extern "C" int cfd_compact_lane(const float* f, float* out, const float* tab,
                                const Coef* c, const float* acc, long long lines,
                                void* stream) {
  int limit;
  cudaError_t err = lane_smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  const size_t line_bytes = (size_t)cfd_line_ld(c->n) * sizeof(float);
  if (line_bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  int per_block = 32;
  while (per_block > 1 && per_block * line_bytes > LANE_SMEM_DEFAULT) per_block /= 2;
  const long long blocks = (lines + per_block - 1) / per_block;
  const size_t smem = per_block * line_bytes;
  cudaStream_t s = (cudaStream_t)stream;
  if (acc) {
    compact_lane_kernel<true><<<(unsigned)blocks, LANE_THREADS, smem, s>>>(f, out, tab, *c, acc,
                                                                           lines, per_block);
  } else {
    compact_lane_kernel<false><<<(unsigned)blocks, LANE_THREADS, smem, s>>>(f, out, tab, *c, acc,
                                                                            lines, per_block);
  }
  return (int)cudaGetLastError();
}
