// K3 `adv_lap_rhs`: the advection term in x and y and the right-hand side
// of the compact Laplacian's z solve, for a float32 (nz, ny, nx) field:
//
//   axy[p] = ux[p] D1x f[p] + uy[p] D1y f[p]
//   r[p]   = sum_k btab[p,k] f[p+k] + D2x h[p] + D2y h[p],
//   h[p]   = sum_{k=-1..1} ttab[p,k] f[p+k]                (planes wrap)
//
// with D1 the d1 scheme, D2 the periodic d2 scheme and (btab, ttab) its z
// operators B_z / dz^2 and T_z (ops/adv_lap.z_tables). Since the xy
// operator does not depend on z, T_z (D2x f + D2y f) = D2x h + D2y h:
// solving T_z lap = r along z (K4) gives the Laplacian.
//
// Replaces: cfd_tpu/ops/pallas_lap.py `_adv_lap_kernel` (called by
// `_call_adv_lap`), which streams z-slabs through a ring of three in VMEM
// and applies the x and y fold bodies to each slab with the matrix unit.
//
// Bound on Hopper: by its work, bytes. The least it must move is 3 reads
// (f, ux, uy) and 2 writes (axy, r) of f32 per point, 336 MB at 256^3; the
// four line solves, h and B_z f are ~127 flops per point. A 256^2 plane (256 KB) does not
// fit one block's 227 KB of shared memory, so the work is split in two
// launches, counted as one call by the wrapper:
//
// 1. y phase, one thread per (z, x) column and family, walking y as K2 does
//    (neighbouring threads on neighbouring x, so each row access of a warp
//    is coalesced). The d1 family solves D1y f and stores uy * D1y f into
//    axy; the d2 family solves D2y h, forming h from three planes of f as it
//    reads, and stores D2y h + B_z f into r. Each family's forward sweep
//    keeps its intermediate in the output it will overwrite.
// 2. x phase, as K1: a block stages L consecutive x-lines of f and of h
//    (formed from three planes) in shared memory with coalesced loads; one
//    warp solves the f lines with D1x, another the h lines with D2x, in
//    place; the block then adds ux * D1x f to axy and D2x h to r, coalesced.
//
// This moves ~11 passes, not 5: the y phase's scratch round trip, and the
// x phase's read-modify-write of both outputs. The neighbouring planes' reads
// of f that form h and B_z f mostly hit L2 (all columns walk y together).
// Both phases are latency-bound recurrences like K1 and K2 (PERF.md), each
// thread here running one line solve; the two families double the threads
// in flight over K2.
//
// B_z f is formed from differences to the point's own value,
// sum_{k != 0} btab[p,k] (f[p+k] - f[p]): a d2 row annihilates constants
// (its weights sum to 0, which the wrapper checks), and on a smooth field
// the raw sum of three O(1/dz^2) products would lose ~1e-4 of an O(1) r in
// float32.

#include "compact_common.cuh"

#define ADV_COLS 64                         // y phase: columns per block
#define ADV_Y_THREADS (2 * ADV_COLS)        // one thread per column and family
#define ADV_X_THREADS 128                   // x phase: >= 32 + lines per block
#define ADV_X_SMEM (48 * 1024)              // x phase: bytes a block stages
#define ADV_MAX_TAPS (2 * CFD_MAX_K + 1)

struct ZTab {
  const float* bt;  // (nz, 2W + 1): B_z / dz^2, row p, offset k at [p][k + W]
  const float* tt;  // (nz, 3): T_z, row p, offset k at [p][k + 1]
  int nz, W;
};

__device__ __forceinline__ long long wrap_plane(long long p, int d, int nz) {
  return ((p + d) % nz + nz) % nz;
}

// At most 64 registers, so 8 blocks (1,024 threads) fit an SM: at 256^3
// the phase's 131,072 threads then run as one wave.
__global__ void __launch_bounds__(ADV_Y_THREADS, 8) adv_lap_y_kernel(const float* __restrict__ f,
                                 const float* __restrict__ uy,
                                 float* axy, float* r,
                                 const float* __restrict__ tab1,
                                 const float* __restrict__ tab2,
                                 const __grid_constant__ Coef c1,
                                 const __grid_constant__ Coef c2,
                                 const ZTab zt, long long nx) {
  const int family = threadIdx.x / ADV_COLS;
  const long long col = (long long)blockIdx.x * ADV_COLS + threadIdx.x % ADV_COLS;
  if (col >= zt.nz * nx) return;
  const int ny = c1.n;
  const long long plane = ny * nx;
  const long long p = col / nx;
  const long long base = p * plane + (col - p * nx);
  if (family == 0) {
    auto src = [&](int m) {
      if (m >= ny) {
        if (!c1.periodic) return 0.f;
        m %= ny;
      }
      return __ldg(f + base + m * nx);
    };
    solve_line(c1, tab1, src, axy + base, nx, [&](int i, float v) {
      const long long e = base + i * nx;
      axy[e] = __ldg(uy + e) * v;
    });
    return;
  }
  const long long below = base + (wrap_plane(p, -1, zt.nz) - p) * plane;
  const long long above = base + (wrap_plane(p, 1, zt.nz) - p) * plane;
  const float t0 = __ldg(zt.tt + 3 * p), t1 = __ldg(zt.tt + 3 * p + 1),
              t2 = __ldg(zt.tt + 3 * p + 2);
  auto src = [&](int m) {  // h at row m
    if (m >= ny) {
      if (!c2.periodic) return 0.f;
      m %= ny;
    }
    const long long o = m * nx;
    return t0 * __ldg(f + below + o) + t1 * __ldg(f + base + o) + t2 * __ldg(f + above + o);
  };
  long long off[ADV_MAX_TAPS];  // plane offsets of B_z's taps
  float bw[ADV_MAX_TAPS];
  const int taps = 2 * zt.W + 1;
#pragma unroll
  for (int k = 0; k < ADV_MAX_TAPS; ++k) {
    const bool on = k < taps && k != zt.W;
    off[k] = on ? (wrap_plane(p, k - zt.W, zt.nz) - p) * plane : 0;
    bw[k] = on ? __ldg(zt.bt + taps * p + k) : 0.f;
  }
  solve_line(c2, tab2, src, r + base, nx, [&](int i, float v) {
    const long long e = base + i * nx;
    const float fe = __ldg(f + e);
    float bz = 0.f;
#pragma unroll
    for (int k = 0; k < ADV_MAX_TAPS; ++k) {
      if (bw[k] != 0.f) bz += bw[k] * (__ldg(f + e + off[k]) - fe);
    }
    r[e] = v + bz;
  });
}

__global__ void adv_lap_x_kernel(const float* __restrict__ f,
                                 const float* __restrict__ ux,
                                 float* axy, float* r,
                                 const float* __restrict__ tab1,
                                 const float* __restrict__ tab2,
                                 const __grid_constant__ Coef c1,
                                 const __grid_constant__ Coef c2,
                                 const ZTab zt, int ny, int lines_per_block) {
  extern __shared__ float tile[];
  const int n = c1.n;
  const int ld = cfd_line_ld(n);
  const long long lines = (long long)zt.nz * ny;
  const long long plane = (long long)ny * n;
  const long long line0 = (long long)blockIdx.x * lines_per_block;
  const long long rest = lines - line0;
  const int nl = rest < lines_per_block ? (int)rest : lines_per_block;
  const int count = nl * n;
  const long long e_base = line0 * n;
  float* tf = tile;                          // f lines, then D1x f
  float* th = tile + lines_per_block * ld;   // h lines, then D2x h

  float* const tiles[2] = {tf, th};
  stage_lines(tiles, count, n, [&](int e, float* v) {
    const long long g = e_base + e;
    const long long p = g / plane;
    const float* tp = zt.tt + 3 * p;
    const long long below = g + (wrap_plane(p, -1, zt.nz) - p) * plane;
    const long long above = g + (wrap_plane(p, 1, zt.nz) - p) * plane;
    v[0] = __ldg(f + g);
    v[1] = __ldg(tp) * __ldg(f + below) + __ldg(tp + 1) * v[0] + __ldg(tp + 2) * __ldg(f + above);
  });
  __syncthreads();

  // warp 0 solves the f lines, warp 1 the h lines: no divergence in a warp
  const int t = threadIdx.x;
  if (t < nl || (t >= 32 && t - 32 < nl)) {
    const bool d2 = t >= 32;
    float* line = (d2 ? th : tf) + (d2 ? t - 32 : t) * ld;
    wrap_line(line, n);
    auto src = [&](int m) { return line[m]; };
    if (d2) {
      solve_line(c2, tab2, src, line, 1);
    } else {
      solve_line(c1, tab1, src, line, 1);
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int l = e / n;
    const int s = l * ld + (e - l * n);
    const long long g = e_base + e;
    axy[g] += __ldg(ux + g) * tf[s];
    r[g] += th[s];
  }
}

// f, ux, uy, axy, r: (nz, ny, nx). tab1y/c1y, tab2y/c2y: the d1 and d2
// schemes along y (n = ny, scaled by 1/dy and 1/dy^2); tab1x/c1x, tab2x/c2x
// along x. bt, tt: the z tables (nz, 2W + 1) and (nz, 3). An x line whose
// two staged copies pass 48 KB returns cudaErrorInvalidValue.
extern "C" int cfd_adv_lap(const float* f, const float* ux, const float* uy,
                           float* axy, float* r, const float* tab1y,
                           const float* tab2y, const float* tab1x,
                           const float* tab2x, const float* bt, const float* tt,
                           const Coef* c1y, const Coef* c2y, const Coef* c1x,
                           const Coef* c2x, int nz, int W, void* stream) {
  const int ny = c1y->n, nx = c1x->n;
  if (c2y->n != ny || c2x->n != nx || W < 0 || W > CFD_MAX_K) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t line_bytes = (size_t)cfd_line_ld(nx) * sizeof(float);
  if (2 * line_bytes > ADV_X_SMEM) return (int)cudaErrorInvalidValue;
  const ZTab zt = {bt, tt, nz, W};
  cudaStream_t s = (cudaStream_t)stream;

  const long long cols = (long long)nz * nx;
  adv_lap_y_kernel<<<(unsigned)((cols + ADV_COLS - 1) / ADV_COLS), ADV_Y_THREADS, 0, s>>>(
      f, uy, axy, r, tab1y, tab2y, *c1y, *c2y, zt, nx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int per_block = 32;
  while (per_block > 1 && 2 * per_block * line_bytes > ADV_X_SMEM) per_block /= 2;
  const long long lines = (long long)nz * ny;
  const long long blocks = (lines + per_block - 1) / per_block;
  adv_lap_x_kernel<<<(unsigned)blocks, ADV_X_THREADS, 2 * per_block * line_bytes, s>>>(
      f, ux, axy, r, tab1x, tab2x, *c1x, *c2x, zt, ny, per_block);
  return (int)cudaGetLastError();
}
