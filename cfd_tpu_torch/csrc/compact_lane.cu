// K1 `compact_lane`: compact derivative along the contiguous (last) axis of
// a float32 field viewed as (lines, n).
//
// Replaces: cfd_tpu/ops/pallas_lane.py `_lane_fold_kernel` (the fold form,
// n <= 256; first and second derivatives) and `_lane_kernel` (the roll
// form, n > 256; first derivative). It computes what they compute,
// T f' = B f / dx**order with the scheme's interior stencil, closure rows
// and periodic wrap, as Thomas sweeps over each line's sub-blocks side by
// side (below), not their block-matrix algebra for the TPU's matrix unit.
//
// With `acc` the write-back adds it, out = f' + acc (a separate
// instantiation, so the plain derivative pays nothing for it): with a
// negative spacing that is pallas_pair.py `_pair_sub_kernel`'s x half,
// ax - dphi/dx (ops/pair.py), and dphi/dx never makes a round trip through
// memory.
//
// Bound on Hopper: by its work, bytes. One read and one write of f32 per
// point (and one more read with acc) is the least any form can move, and
// the sweeps are ~15 flops per point. The kernel is bound instead by the
// latency and issue of its sweeps (PERF.md).
//
// Design. Each line is cut into the nb sub-blocks that ops/lane.py
// `line_nb` picks for its length n: the most that divide n into chains of
// at least 32 rows, at most 128 (16 chains of 32 rows at n = 512, 128 of
// 64 at n = 8192), and nb = 1 where no divisor leaves 32 rows (n < 64, a
// prime n). Their Thomas chains run one a thread (line_chains.cuh, on
// dist_common.cuh's solve_chain): a forward sweep with the couplings cut,
// the line's 2 nb faces in shared memory, a short window of the reduced
// inverse dotted with them, and a backward sweep adding the intra update;
// at nb = 1 the one chain is the line's whole Thomas solve, its periodic
// wrap closed by the 2 x 2 cyclic reduced system in place of a
// Sherman–Morrison term. A block runs L lines of nb chains (256 threads at
// most, L cut until the tile fits 48 KB), staged once with cp.async in a
// layout where a warp's chains touch 32 consecutive words at each step.
// Where one thread walked a whole line (the form this kernel replaced), a
// block had as many busy threads as lines, 32 at n = 256 and one at n =
// 8192.

#include "line_chains.cuh"

#define LANE_CHAIN_THREADS 256  // the most chains a block runs

// A block takes L lines of nb chains, one thread a chain
// (line_chains.cuh), stages them with 4-byte cp.async copies (coalesced;
// the tile's layout scatters a line's rows over the chains' columns), runs
// solve_line_chain in place and writes the lines back coalesced.
template <int K, bool ACC>
__global__ void __launch_bounds__(LANE_CHAIN_THREADS)
    compact_lane_kernel(const float* __restrict__ f, float* __restrict__ out,
                        const float* __restrict__ tab, const __grid_constant__ Coef c,
                        const float* __restrict__ acc,  // ACC only
                        long long lines, int lines_per_block, int nb, int h, int win) {
  extern __shared__ float tile[];
  const int n = c.n;
  const int cs = line_chain_stride(lines_per_block * nb);
  float* faces = tile + (n / nb) * cs;  // 2 nb a line
  const long long line0 = (long long)blockIdx.x * lines_per_block;
  const long long rest = lines - line0;
  const int nl = rest < lines_per_block ? (int)rest : lines_per_block;
  const int count = nl * n;
  const float* fb = f + line0 * n;
  float* ob = out + line0 * n;
  const float* ab = ACC ? acc + line0 * n : nullptr;

  walk_chains(count, n, nb, cs, [&](int e, int at, int) { cp_async4(tile + at, fb + e); });
  cp_async_wait_all();
  __syncthreads();
  solve_line_chain<K>(c, tab, nb, h, win, tile, cs, faces, threadIdx.x);
  __syncthreads();
  walk_chains(count, n, nb, cs, [&](int e, int at, int) {
    ob[e] = ACC ? tile[at] + __ldg(ab + e) : tile[at];
  });
}

#define LANE_SMEM_DEFAULT (48 * 1024)  // bytes a block gets without opting in
#define LANE_MAX_DEVICES 64

// Per device: the dynamic shared memory the kernels have been opted in to
// (the device's per-block maximum), 0 until the first launch there.
static int lane_smem_optin[LANE_MAX_DEVICES];

static cudaError_t lane_smem_limit(int* bytes) {
  const void* kernels[] = {
      (const void*)compact_lane_kernel<1, false>, (const void*)compact_lane_kernel<1, true>,
      (const void*)compact_lane_kernel<2, false>, (const void*)compact_lane_kernel<2, true>,
      (const void*)compact_lane_kernel<3, false>, (const void*)compact_lane_kernel<3, true>,
  };
  return dist_smem_limit(lane_smem_optin, kernels, sizeof(kernels) / sizeof(kernels[0]), bytes);
}

template <int K>
static void lane_launch(const float* f, float* out, const float* tab, const Coef* c,
                        const float* acc, long long lines, int per_block, int nb, int h, int win,
                        size_t smem, cudaStream_t s) {
  const unsigned blocks = (unsigned)((lines + per_block - 1) / per_block);
  const int threads = per_block * nb;
  if (acc) {
    compact_lane_kernel<K, true><<<blocks, threads, smem, s>>>(f, out, tab, *c, acc, lines,
                                                               per_block, nb, h, win);
  } else {
    compact_lane_kernel<K, false><<<blocks, threads, smem, s>>>(f, out, tab, *c, acc, lines,
                                                                per_block, nb, h, win);
  }
}

// Lines of length n = c->n, `lines` of them; acc may be null; nb (a
// divisor of n, at most LANE_CHAIN_THREADS) chains a line against the
// chain table of ops/lane.py `chain_table` (h, win: the window of its
// reduced rows). A block runs LANE_CHAIN_THREADS / nb lines, fewer until
// they fit 48 KB, at least one. A line longer than the device's opt-in
// maximum of shared memory returns cudaErrorInvalidValue.
extern "C" int cfd_compact_lane(const float* f, float* out, const float* tab, const Coef* c,
                                const float* acc, long long lines, int nb, int h, int win,
                                void* stream) {
  const int n = c->n;
  if (nb < 1 || n % nb || nb > LANE_CHAIN_THREADS || win < 1 || win > 2 * nb || c->K < 1 ||
      c->K > CFD_MAX_K) {
    return (int)cudaErrorInvalidValue;
  }
  const int bz = n / nb;
  auto bytes = [&](int L) {
    return ((size_t)bz * line_chain_stride(L * nb) + (size_t)L * 2 * nb) * sizeof(float);
  };
  int per_block = LANE_CHAIN_THREADS / nb;
  while (per_block > 1 && bytes(per_block) > LANE_SMEM_DEFAULT) --per_block;
  const size_t smem = bytes(per_block);
  if (smem > LANE_SMEM_DEFAULT) {
    int limit;
    const cudaError_t err = lane_smem_limit(&limit);
    if (err != cudaSuccess) return (int)err;
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (c->K == 1) {
    lane_launch<1>(f, out, tab, c, acc, lines, per_block, nb, h, win, smem, s);
  } else if (c->K == 2) {
    lane_launch<2>(f, out, tab, c, acc, lines, per_block, nb, h, win, smem, s);
  } else {
    lane_launch<3>(f, out, tab, c, acc, lines, per_block, nb, h, win, smem, s);
  }
  return (int)cudaGetLastError();
}
