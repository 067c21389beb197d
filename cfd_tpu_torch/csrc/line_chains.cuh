// A whole line cut into sub-block Thomas chains (K1, compact_lane.cu, on
// lines of every length; the x phases of K3, K5, K6, K9 and K13 in
// xy_phase.cuh's xy_chain_x_kernel; K4's z-lines, rk3_mega.cu, in a layout
// of its own): the chain layout of a block's lines in shared memory and the
// table a chain reads, for dist_common.cuh's solve_chain. Any kernel that
// stages whole lines can run them (the weighted x phase of xy_phase.cuh,
// K8's and K10's, and K7's stage the same lines and still solve each with
// one thread).
//
// A line of n points is cut into nb sub-blocks of bz = n / nb rows; chain
// k runs rows s = k bz .. e = s + bz - 1. A periodic line is one ring: the
// wrap couples sub-block nb - 1 to sub-block 0, so the (2nb, 2nb) reduced
// matrix is cyclic and there is no Sherman–Morrison term; its stencil reads
// across the line's ends from the line itself. A non-periodic line is a
// shard that is both first and last: chain 0 and chain nb - 1 form the
// closure rows from f, and the reduced matrix has identity end rows
// (parallel/dist_tables.py `line_block_tables`).
//
// Layout. Chain c = l nb + k of a block (line l, sub-block k) is its thread
// c, and row i of every chain sits in one row of the tile: f[k bz + i] of
// line l at tile[i * cs + c], with cs = (L nb) | 1. A warp's 32 chains read
// and write 32 consecutive words at each step of their sweeps, and the
// coalesced staging, which walks a line's rows in order, hits 32 banks too
// (cs odd).
//
// Table (ops/lane.py `chain_table`, float32). All sub-blocks of a line but
// its first and last are the same block, and on a periodic line all of
// them are: the table holds three kinds q, the first (q = 0), an interior
// (1) and the last (2) sub-block, each (bz + 2) rows with a zero row before
// row 0 and after row bz - 1 (the sweeps load a row ahead): float4 (invd,
// du, uh, lh) for the backward sweep, then float2 (w, t0) for the forward
// sweep. So a warp's chains read one or two rows of a table of a few KB,
// which stays in L1, where per-chain factors would move six floats from L2
// for every point.
//
// Reduced solve. Each chain needs its two rows of the reduced inverse
// dotted with the line's 2nb faces. The reduced matrix pairs the two
// unknowns on either side of each interface; pairs couple only through the
// corners of the sub-block inverses, which are the tridiagonal's decay rate
// to the power bz (below 1e-6 at bz = 32 for every scheme of the port, the
// filters' alpha = 0.45 included). So a row of the inverse falls off
// geometrically from its diagonal, and the host keeps, for every row, the
// win = 2h + 2 columns 2k - h .. 2k + 1 + h (cyclically on a periodic line,
// clamped inside the line otherwise), with h the least that holds every
// entry above 1e-14 of the largest: at bz = 32, h is 1 for the fourth-order
// schemes, 3 for the sixth-order ones and 5 for the filters. Each chain
// dots win faces: O(1) work a chain, no serial step across the line (a
// second-level sweep over 2nb faces would be 2nb dependent steps; a dense
// (2nb)^2 inverse is 256 KB at nb = 128). The table's last part holds
// those weights, red[(o * win + j) * nb + k] for row 2k + o, column c0(k) +
// j (mod 2nb).

#pragma once

#include "dist_common.cuh"

#define LINE_KINDS 3  // first, interior and last sub-block

// Float32 words of a chain table's per-row part: LINE_KINDS kinds of bz + 2
// rows, four words backward and two forward.
__host__ __device__ __forceinline__ int line_tab_rows(int bz) { return LINE_KINDS * (bz + 2); }

// The row stride of a block's tile of L lines of nb chains.
__host__ __device__ __forceinline__ int line_chain_stride(int chains) { return chains | 1; }

// What chain k of nb reads of the table (dist_common.cuh's table interface).
struct LineTab {
  const float4* __restrict__ bwd4;  // this chain's kind at its row -1
  const float2* __restrict__ fwd2;
  const float* __restrict__ red;
  int s, h, win, periodic;
  __device__ __forceinline__ LineTab(const float* __restrict__ tab, int bz, int nb, int k, int h_,
                                     int win_, int periodic_)
      : s(k * bz), h(h_), win(win_), periodic(periodic_) {
    const int q = k == 0 ? 0 : (k == nb - 1 ? 2 : 1);
    const int rows = line_tab_rows(bz);
    bwd4 = reinterpret_cast<const float4*>(tab) + q * (bz + 2);
    fwd2 = reinterpret_cast<const float2*>(tab + 4 * rows) + q * (bz + 2);
    red = tab + 6 * rows;
  }
  // row g of the chain, s - 1 <= g <= e + 1
  __device__ __forceinline__ float2 fwd(int g) const { return __ldg(fwd2 + (g - s + 1)); }
  __device__ __forceinline__ float4 bwd(int g) const { return __ldg(bwd4 + (g - s + 1)); }
  __device__ __forceinline__ float2 shard(int) const { return make_float2(0.f, 0.f); }
  __device__ __forceinline__ void reduce(const float* faces, int fstride, int k, int nb,
                                         float& alpha, float& beta) const {
    const int m = 2 * nb;
    int c0 = 2 * k - h;
    if (periodic) {
      if (c0 < 0) c0 += m;
    } else {
      c0 = min(max(c0, 0), m - win);
    }
#pragma unroll 2
    for (int j = 0; j < win; ++j) {
      int col = c0 + j;
      if (col >= m) col -= m;
      const float fj = faces[col * fstride];
      alpha += __ldg(red + j * nb + k) * fj;
      beta += __ldg(red + (win + j) * nb + k) * fj;
    }
  }
};

// The tile offset of element e = l n + k bz + i of a block's lines, walked
// without a division: `body(e, i * cs + l * nb + k, l)` for e = threadIdx.x,
// threadIdx.x + blockDim.x, ... below count.
template <class Body>
__device__ __forceinline__ void walk_chains(int count, int n, int nb, int cs, Body body) {
  const int bz = n / nb;
  const int T = blockDim.x;
  const int dl = T / n, rem = T - dl * n, dk = rem / bz, di = rem - dk * bz;
  int l = threadIdx.x / n;
  const int g = threadIdx.x - l * n;
  int k = g / bz;
  int i = g - k * bz;
  for (int e = threadIdx.x; e < count; e += T) {
    body(e, i * cs + l * nb + k, l);
    i += di;
    if (i >= bz) {
      i -= bz;
      ++k;
    }
    k += dk;
    if (k >= nb) {
      k -= nb;
      ++l;
    }
    l += dl;
  }
}

// The thread of chain index t = l nb + k solves chain k of its block's
// line l in place in the tile (layout above), against the chain table
// `tab` (h, win: its reduced rows' window); `faces` holds 2 nb slots a
// line. The block's chains are L nb consecutive threads; each calls it,
// and every other thread passes solve_chain's CHAIN_BARRIERS barriers in
// whole warps. A line past the block's last runs on whatever its slots
// hold and is never written back.
template <int K>
__device__ __forceinline__ void solve_line_chain(const Coef& c, const float* __restrict__ tab,
                                                 int nb, int h, int win, float* tile, int cs,
                                                 float* faces, int t) {
  const int n = c.n;
  const int bz = n / nb;
  const int l = t / nb;
  const int k = t - l * nb;
  // line[g * cs] is row g of this chain (k bz <= g < (k + 1) bz)
  float* line = tile + t - k * bz * cs;
  const float* mine = tile + l * nb;
  // f[m] of this line for the rows it reads past its own, wrapped around
  // the line (a non-periodic line reads them and never uses them)
  auto nbr = [=](int m) {
    const int mm = m < 0 ? m + n : (m >= n ? m - n : m);
    const int kk = mm / bz;
    return mine[(mm - kk * bz) * cs + kk];
  };
  const bool walls = !c.periodic;
  solve_chain<K, false>(c, LineTab(tab, bz, nb, k, h, win, c.periodic), nb, k, line, cs, nbr,
                        walls, walls, faces + l * 2 * nb, 1, 0.f, 0.f,
                        [=](int g, float v) { line[g * cs] = v; });
}
