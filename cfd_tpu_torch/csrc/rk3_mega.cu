// K4 `rk3_mega`: one low-storage RK3 substep's z-work of the advection–
// diffusion model on a float32 (nz, ny, nx) field, viewed as (nz, cols)
// with cols = ny * nx:
//
//   fz  = d1z f                    (family A: the d1 scheme's RHS and LHS)
//   lap = T2z^{-1} r               (family B: r is the RHS; the d2 scheme's LHS)
//   q'  = a q + dt (nu lap - (axy + uz fz))     (no q on the first substep)
//   f'  = f + b q'
//
// Replaces: cfd_tpu/ops/pallas_megastep.py `_mega_kernel` (called by
// `_call_mega`), which interleaves the two families' substructured
// sub-block chains in VMEM for its (8, 128) tiles and applies the update as
// their backward sweeps emit rows.
//
// Bound on Hopper: by its work, bytes. The least it must move is 5 reads
// (f, r, axy, uz, q) and 2 writes (q', f') of f32 per point, 7 passes or
// 470 MB (0.140 ms at 3.35 TB/s) at 256^3: 6 on the first substep (no q)
// and on the last (q' is dead, write_q = 0). The sweeps are ~45 flops a
// point. This form moves those 7 passes and no more: each input is read
// once from device memory (f twice, the second read mostly from L2) and
// each output written once, with no scratch round trip.
//
// Design: staged z-tile sub-block chains, K12's z route (strided_dist.cu)
// with both families in one block. A block takes C consecutive columns (32
// where they fit, so that a row of the tile is one 128-byte segment) and
// stages their whole z-lines of f and of r once, with cp.async (16-byte
// copies where the rows are aligned), into two tiles: tile[m * C + l] is
// row m of column l. At nz = 256 that is 2 x 32 KB, opted in past 48 KB;
// at nz = 8192 it would be 64 KB a column, so fewer columns a block, down
// to 1, until the tiles fit the device's opt-in maximum and the block 1024
// threads (ops/megastep.py `rk3_mega_supported` declines longer z-lines).
// Each z-line is cut into nb sub-blocks of >= 32 rows (ops/lane.py
// `line_nb`: 8 of 32 at nz = 256, 2 at nz = 64, one chain at nz = 42 or a
// prime nz), and every sub-block of every column of both families is one
// thread running dist_common.cuh's solve_chain on the chain tables of
// ops/lane.py `chain_table(scheme, nz, nb)` (line_chains.cuh's LineTab):
// family A on the d1 scheme, its closure rows formed from the tile, or the
// wrap read from the tile on a periodic ring (no Sherman–Morrison term);
// family B on the d2 scheme's LHS against r itself, through an identity
// RHS row (centre weight 1, scale 1, no closure rows) on the same code
// path. Chain (k, l) of a family is thread k C + l of it, so a warp's 32
// chains touch 32 consecutive words at every step of their sweeps, and its
// table reads are one broadcast. At 256^3: 2 x 8 x 32 = 512 chains a
// block, 68 KB. Where a block has fewer than 128 chains (one chain a
// column), whole warps before them help stage and write back, and pass
// solve_chain's barriers on their own.
//
// Epilogue: after the solves fz sits in tile A and lap in tile B. The
// block walks the tiles row by row, C consecutive columns a warp, reads
// axy, uz, q and f (this block's f again, mostly an L2 hit: a third tile
// would cost the occupancy that the two leave), and writes q' (only with
// write_q) and f' once, coalesced.

#include <cstdint>

#include "line_chains.cuh"

#define MEGA_COLS 32            // columns a block takes where they fit
#define MEGA_MAX_THREADS 1024   // the most threads a block runs
#define MEGA_STAGERS 128        // the fewest threads a block stages with

static int mega_optin[DIST_MAX_DEVICES];

struct Rk3Coef {
  float a, b, dt, dt_nu;  // q' = a q + dt_nu lap - dt adv;  f' = f + b q'
};

// The two families: 0 the d1 scheme on f, 1 the d2 scheme's LHS on r (its
// Coef the identity RHS), each with its chain table for nb sub-blocks and
// that table's reduced window (h, win).
struct MegaFamilies {
  Coef c[2];
  const float* ch[2];
  int h[2], win[2];
};

// Shared memory of a block of C columns of n rows in nb chains: the two
// tiles and each family's 2 nb face slots a column.
__host__ inline size_t mega_bytes(int n, int nb, int C) {
  return (size_t)C * (2 * n + 2 * 2 * nb) * sizeof(float);
}

template <int K>
__global__ void __launch_bounds__(MEGA_MAX_THREADS)
    rk3_mega_kernel(const float* __restrict__ f, const float* __restrict__ r,
                    const float* __restrict__ axy, const float* __restrict__ uz,
                    const float* __restrict__ q,  // null: no q
                    float* __restrict__ qout, float* __restrict__ fout,
                    const __grid_constant__ MegaFamilies fam, const Rk3Coef rk, int write_q,
                    long long cols, int C, int nb, int aligned) {
  extern __shared__ __align__(16) float smem[];
  const int n = fam.c[0].n;
  float* tiles[2] = {smem, smem + n * C};  // f, then fz; r, then lap
  float* faces = smem + 2 * n * C;         // family s, column l: faces[(s 2nb + j) C + l]
  const long long j0 = (long long)blockIdx.x * C;
  const int valid = cols - j0 < C ? (int)(cols - j0) : C;

  // stage the C columns' z-lines of f and r, row by row
  const float* srcs[2] = {f + j0, r + j0};
  if (aligned && valid == C) {
    const int quads = C / 4;
    for (int e = threadIdx.x; e < 2 * n * quads; e += blockDim.x) {
      const int s = e >= n * quads;
      const int rem = e - s * n * quads;
      const int m = rem / quads;
      const int c4 = 4 * (rem - m * quads);
      cp_async16(tiles[s] + m * C + c4, srcs[s] + m * cols + c4);
    }
  } else {
    for (int e = threadIdx.x; e < 2 * n * C; e += blockDim.x) {
      const int s = e >= n * C;
      const int rem = e - s * n * C;
      const int m = rem / C;
      const int l = rem - m * C;
      const float* src = srcs[s] + m * cols;
      cp_async4(tiles[s] + m * C + l, l < valid ? src + l : src, l < valid);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int chains = nb * C;  // a family's
  const int lead = blockDim.x - 2 * chains;  // staging threads before the chains, whole warps
  if ((int)threadIdx.x >= lead) {
    const int t = threadIdx.x - lead;
    const int s = t >= chains;
    const int u = t - s * chains;
    const int k = u / C;
    const int l = u - k * C;
    const Coef& c = fam.c[s];
    float* line = tiles[s] + l;  // line[m * C] is row m of this column
    auto nbr = [=](int m) {  // rows past the chain's own, wrapped around the column
      const int mm = m < 0 ? m + n : (m >= n ? m - n : m);
      return line[mm * C];
    };
    const bool walls = !c.periodic;
    solve_chain<K, false>(c, LineTab(fam.ch[s], n / nb, nb, k, fam.h[s], fam.win[s], c.periodic),
                          nb, k, line, C, nbr, walls, walls, faces + s * 2 * nb * C + l, C, 0.f,
                          0.f, [=](int g, float v) { line[g * C] = v; });
  } else {
    for (int b = 0; b < CHAIN_BARRIERS; ++b) __syncthreads();
  }
  __syncthreads();

  // the RK update, row by row: blockDim.x is a multiple of C, so each
  // thread keeps its column
  const int l = threadIdx.x % C;
  if (l >= valid) return;
  const int rows = blockDim.x / C;
  for (int m = threadIdx.x / C; m < n; m += rows) {
    const long long e = m * cols + j0 + l;
    const float fz = tiles[0][m * C + l];
    const float lap = tiles[1][m * C + l];
    const float adv = __ldg(axy + e) + __ldg(uz + e) * fz;
    float qn = rk.dt_nu * lap - rk.dt * adv;
    if (q) qn += rk.a * __ldg(q + e);
    if (write_q) qout[e] = qn;
    fout[e] = __ldg(f + e) + rk.b * qn;
  }
}

template <int K>
static void mega_launch(const float* f, const float* r, const float* axy, const float* uz,
                        const float* q, float* qout, float* fout, const MegaFamilies& fam,
                        const Rk3Coef& rk, int write_q, long long cols, int C, int nb,
                        int aligned, int threads, size_t smem, cudaStream_t s) {
  const unsigned blocks = (unsigned)((cols + C - 1) / C);
  rk3_mega_kernel<K><<<blocks, threads, smem, s>>>(f, r, axy, uz, q, qout, fout, fam, rk,
                                                    write_q, cols, C, nb, aligned);
}

// The shared memory a K4 block may take on the current device, in *bytes:
// its opt-in maximum, opted in once per device. cfd_rk3_mega sizes its
// blocks against it, and ops/megastep.py `rk3_mega_supported` routes by it.
extern "C" int cfd_rk3_mega_smem_limit(int* bytes) {
  const void* kernels[] = {(const void*)rk3_mega_kernel<1>, (const void*)rk3_mega_kernel<2>,
                           (const void*)rk3_mega_kernel<3>};
  return (int)dist_smem_limit(mega_optin, kernels, 3, bytes);
}

// Fields (n, cols) with n = c1->n = c2->n rows of `cols` columns each:
// (nz, ny * nx). q may be null (first substep); qout is q' and is written
// only when write_q is 1 (it may be null otherwise). c1 with ch1, h1, win1:
// the d1 scheme (scaled by 1/dz) and its chain table (ops/lane.py
// `chain_table`) for nb sub-blocks a column (a divisor of n); c2 with ch2,
// h2, win2: the identity RHS of the d2 scheme's LHS (centre 1, scale 1, no
// closure rows; its `periodic` the d2 scheme's) and that scheme's chain
// table. A z-line whose two tiles of one column pass the device's opt-in
// maximum of shared memory, and any other launch the kernel does not
// take, return cudaErrorInvalidValue.
extern "C" int cfd_rk3_mega(const float* f, const float* r, const float* axy, const float* uz,
                            const float* q, float* qout, float* fout, const float* ch1,
                            const float* ch2, const Coef* c1, const Coef* c2, float a, float b,
                            float dt, float dt_nu, int write_q, long long cols, int nb, int h1,
                            int win1, int h2, int win2, void* stream) {
  const int n = c1->n;
  if (c2->n != n || nb < 1 || n % nb || c1->K < 1 || c1->K > CFD_MAX_K || win1 < 1 ||
      win1 > 2 * nb || win2 < 1 || win2 > 2 * nb || !ch1 || !ch2 || (write_q && !qout) ||
      cols < 1 || 2 * nb > MEGA_MAX_THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  int limit;
  const int err = cfd_rk3_mega_smem_limit(&limit);
  if (err != (int)cudaSuccess) return err;
  int C = MEGA_COLS;
  while (C > 1 && C / 2 >= cols) C /= 2;
  while (C > 1 && (2 * nb * C > MEGA_MAX_THREADS || mega_bytes(n, nb, C) > (size_t)limit)) C /= 2;
  const size_t smem = mega_bytes(n, nb, C);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  const int chains = 2 * nb * C;
  const int lead = chains < MEGA_STAGERS ? (MEGA_STAGERS - chains + 31) / 32 * 32 : 0;
  const int aligned = C % 4 == 0 && cols % 4 == 0 && ((uintptr_t)f | (uintptr_t)r) % 16 == 0;
  MegaFamilies fam;
  fam.c[0] = *c1;
  fam.c[1] = *c2;
  fam.ch[0] = ch1;
  fam.ch[1] = ch2;
  fam.h[0] = h1;
  fam.h[1] = h2;
  fam.win[0] = win1;
  fam.win[1] = win2;
  const Rk3Coef rk = {a, b, dt, dt_nu};
  cudaStream_t s = (cudaStream_t)stream;
#define MEGA_ARGS f, r, axy, uz, q, qout, fout, fam, rk, write_q, cols, C, nb, aligned, \
                  lead + chains, smem, s
  if (c1->K == 1) {
    mega_launch<1>(MEGA_ARGS);
  } else if (c1->K == 2) {
    mega_launch<2>(MEGA_ARGS);
  } else {
    mega_launch<3>(MEGA_ARGS);
  }
#undef MEGA_ARGS
  return (int)cudaGetLastError();
}
