// The right-hand sides that move T_z through the xy derivatives, shared by
// K3 (adv_lap.cu), K5 (adv_lap3.cu), K6 (div_rhs.cu), K8 (d2_sum.cu), K9
// (lap_rhs.cu), K10 (curl_rhs.cu) and K13 (adv_pair.cu). For a float32 (nz, ny, nx) field and
// a periodic scheme with z operators T_z (LHS) and B_z / dz**order (RHS),
// each "family" writes one output, of one of three kinds:
//
//   advection:  out = my * Dy sy + mx * Dx sx
//   z-RHS:      out = B_z bz + Dy (T_z sy) + Dx (T_z sx)
//   weighted:   out = wy Dy (Z sy) + wb B_z bz + wx Dx (Z sx)
//
// where Dy and Dx are the family's compact scheme along y and x (the d1 or
// the d2 of the launch), wy, wx, wb are constants (0 drops a term) and Z is
// T_z (`tz` set; then wb != 0) or the identity (no z work at all). Since the
// xy operators do not depend on z, T_z (Dx s + Dy s) = Dx (T_z s) + Dy
// (T_z s), so solving T_z x = out along z (K4, or K2's solve_only mode)
// turns a z-RHS into Dx sx + Dy sy plus the z derivative of bz without ever
// storing the xy derivatives:
//
//   K3  axy = ux Dx f + uy Dy f;   r = B_z f + D2x h + D2y h,  h = T_z f
//   K5  K3's two families for each of u0, u1, u2, advected by u0 and u1
//   K6  r = B_z uz + D1x (T_z ux) + D1y (T_z uy)               (divergence)
//   K9  r = B_z f + D2x h + D2y h                     (periodic Laplacian)
//   K8  s = D2x f + D2y f                 (weighted, no z: the xy Laplacian)
//   K10 wz = D1x uy - D1y ux;  rA = T_z (D1y uz) - B_z uy;
//       rB = B_z ux - T_z (D1x uz)                    (weighted: the curl)
//   K13 axy = ux Dx f + uy Dy f          (advection alone: no z work at all)
//
// A launch is of the first two kinds (`weighted` = 0), weighted throughout,
// or, unpaired, advection throughout. The z-RHS launches of K6 and K9, the
// advection-only launch of K13 and the paired launches of K3 and K5 run the
// chained x phase (below), which takes any line an opted-in block holds;
// only the weighted launches of K8 and K10 (`xy_launch`) still run an x
// phase of one thread a line.
//
// A 256^2 plane (256 KB) does not fit one block's 227 KB of shared memory,
// so a launch is two kernels on one stream:
//
// 1. y phase, in one of two forms:
//    - staged y-tile sub-block chains (every launch of the first two kinds
//      and the advection-only kind: `xy_y_kernel<K, KIND>`, with the chain
//      tables of ops/lane.py `chain_table` along y in XYArgs, `nby` > 0;
//      ops/lane.py `y_phase_fits` keeps the routes off y-lines whose
//      column does not fit):
//      as K4 runs z (rk3_mega.cu), a block takes C consecutive x-columns of
//      one plane and stages their whole y-lines once in shared memory,
//      tile[m * C + l] row m of column l: sy (K13, with cp.async), T_z sy
//      (K6, K9, formed from three planes with the plane's one TzRow), or
//      both from one read of sy (the pairs of K3 and K5). Each y-line is
//      cut into nby = ops/lane.py `line_nb(ny)` sub-blocks of >= 32 rows,
//      and every sub-block of every column is one thread running
//      solve_chain on the chain table; chain (k, l) of a tile is thread k C
//      + l of it, so a warp's 32 chains touch 32 consecutive words at
//      every step. The block then writes my * Dy sy, or Dy (T_z sy) + B_z
//      bz, once to `out`, coalesced: nothing goes to device memory before
//      the final value. Staging and the epilogue move 4 columns a thread
//      at a time (16-byte accesses) where the rows are aligned. C is 32
//      where the tiles fit, fewer (down to 1, in the opt-in maximum past 48
//      KB) until the block has at most 512 threads, so that three blocks
//      of 68 KB share an SM and one's staging overlaps another's chains,
//      and its shared memory fits: C = 32 at 256^3 for a pair and at 512^3
//      for one tile, 16 at 512^3 for a pair (512 chains, 68 KB: on an
//      H100, K5's y phase took 4.29 ms there, and 4.66 ms with 32 columns
//      and 1024 chains a block), 1 for a pair on prime y-lines of 29,033
//      points (one chain a line, 227 KB).
//    - one thread a (z, x) column of one family (the weighted kind,
//      `xyw_y_kernel`), walking y as K2 does: the forward sweep keeps its
//      values in `out`, and the backward sweep stores the result there.
// 2. x phase, in one of two forms:
//    - one thread a line (K8 and K10, weighted: `xy_launch`): a block
//      stages consecutive x-lines of a family's Z sx in shared memory with
//      coalesced loads; a warp solves them in place, one thread a line; the
//      block adds wx times them into the output, coalesced. At nx = 8192
//      that would be one busy thread a block.
//    - sub-block chains (K6, K9, K13, K3 and K5: `xy_chain_launch`, with the
//      chain tables of ops/lane.py `chain_table` in XYArgs, `nb` > 0): as
//      K1 does (compact_lane.cu, line_chains.cuh), a block stages L lines
//      of T_z sx (K6, K9, formed from three planes with each line's TzRow,
//      made once a line), of sx (K13, with cp.async), or of both from one
//      read of sx (the pairs of K3 and K5) into the chain layout, cuts each
//      line into nb sub-blocks of >= 32 rows (ops/lane.py `line_nb`) and
//      runs their Thomas chains one a thread, L nb threads a block a
//      family; then adds them, times mx for advection, into the outputs,
//      coalesced.
//
// Families (of the paired kind: pairs of them) sit on the grid's y axis, so
// the branch on a family's kind is uniform in a block, and each kind's body
// is compiled apart. A weighted family with wy = 0 runs no y solve (its y phase writes
// wb B_z bz), and one with wx = 0 has no x blocks.
//
// Bound on Hopper: by its work, bytes. Each output is written once and each
// distinct input read once at the least. The staged y phase moves, a
// family, its source once and its output once, and my (advection) once;
// the neighbouring planes that form T_z sy and B_z bz are mostly L2 hits,
// since the blocks in flight hold a few consecutive planes. So K5's y
// phase moves 12 passes, not the ~27 of a walk of one thread a column
// (each pass's scratch round trip in `out`). The x phase adds a read-modify-write of every
// output. Both phases run latency-bound sub-block recurrences like K1's and
// K4's (PERF.md).
//
// B_z g is formed from differences to the point's own value,
// sum_{k != 0} bt[p,k] (g[p+k] - g[p]): a derivative's row annihilates
// constants (the wrappers check it), and on a smooth field the raw sum of
// O(1/dz**order) products would lose ~1e-4 of an O(1) result in float32.
//
// Everything here is in an anonymous namespace: each source that includes
// it gets its own copy of the kernels. The chained x phase is a template
// of its kind (`xy_chain_launch<KIND>`), so each source that calls it
// builds the kernels of its own kind, and the sources that do not, none.
#pragma once

#include <cstdint>

#include "line_chains.cuh"

namespace {

#define XY_MAX_FAMILIES 6
#define XY_Z_TAPS (2 * CFD_MAX_K + 1)
#define XY_Y_THREADS 128         // weighted y phase: columns per block
#define XY_Y_COLS 32             // staged y phase: columns a block takes where they fit
#define XY_Y_MAX_THREADS 512     // staged y phase: the most threads a block runs
#define XY_Y_STAGERS 128         // staged y phase: the fewest threads a block stages with
#define XY_X_THREADS 128         // weighted x phase: threads a block, >= the lines it stages
#define XY_X_LINES 32            // weighted x phase: lines per block, halved to fit
#define XY_X_SMEM (48 * 1024)    // x phase: bytes a block stages without opting in
#define XY_CHAIN_THREADS 256     // chained x phase: the most chains a block runs
#define XY_CHAIN_STAGERS 128     // chained x phase: the fewest threads a block stages with

struct ZTab {
  const float* bt;  // (nz, 2W + 1): B_z / dz**order, row p, offset k at [p][k + W]
  const float* tt;  // (nz, 3): T_z, row p, offset k at [p][k + 1]
  int nz, W;
};

struct XYFamily {
  const float* sy;  // the field differentiated along y
  const float* sx;  // the field differentiated along x
  const float* my;  // advection: multiplies Dy sy (unused by a z-RHS)
  const float* mx;  // advection: multiplies Dx sx (unused by a z-RHS)
  const float* bz;  // z-RHS: the field under B_z (unused by advection)
  float* out;       // never an input of any family
  int d2;           // 1: the launch's second scheme (the d2), 0: its first
  int rhs;          // 1: a z-RHS family, 0: an advection family (not weighted)
  float wy, wx, wb; // weighted: the constants of Dy, Dx and B_z (0: no term)
  int tz;           // weighted: 1 applies T_z to sy and sx and adds wb B_z bz
};

struct XYArgs {
  XYFamily fam[XY_MAX_FAMILIES];
  Coef cy[2], cx[2];  // the launch's two schemes along y (n = ny) and x (n = nx)
  // each scheme's table along y: its chain table (ops/lane.py
  // `chain_table`) for nby sub-blocks a y-line, with its reduced rows'
  // window (hy, winy), for the staged y phase (xy_y_chains); its per-point
  // table for the weighted kind (nby = 0)
  const float* taby[2];
  int hy[2], winy[2];
  int nby;
  const float* tabx[2];
  ZTab zt;
  int nfam;
  int paired;  // 1: families 2g and 2g + 1 are an advection and a z-RHS family
               // over the same sx (K3, K5); 0: every family is a z-RHS family
  int weighted;                  // 1: every family is weighted (paired = 0)
  int xfam[XY_MAX_FAMILIES];     // weighted: the families with an x term
  int nxfam;                     //   (set by xy_launch)
  // the chained x phase (xy_chain_launch, xy_chain_table): the chain table
  // of each scheme along x (ops/lane.py `chain_table`) and its reduced
  // rows' window (h, win), for the nb sub-blocks of a line, which the line
  // length alone sets; nb = 0 for the one-thread-a-line forms
  const float* chx[2];
  int h[2], win[2];
  int nb;
};

__device__ __forceinline__ long long wrap_plane(long long p, int d, int nz) {
  return ((p + d) % nz + nz) % nz;
}

// V consecutive floats at p (device memory: read-only; 16-byte aligned
// where V = 4) into v, and from v to p (device or shared memory).
template <int V>
__device__ __forceinline__ void ldg_vec(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = __ldg(p + j);
  }
}
template <int V>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = v[j];
  }
}

// Row p of T_z: h[e] = t0 s[e - plane] + t1 s[e] + t2 s[e + plane], planes
// wrapped; `e` is an element of plane p.
struct TzRow {
  float t0, t1, t2;
  long long below, above;  // offsets to the wrapped neighbouring planes
  __device__ __forceinline__ TzRow(const ZTab& zt, long long p, long long plane)
      : t0(__ldg(zt.tt + 3 * p)), t1(__ldg(zt.tt + 3 * p + 1)), t2(__ldg(zt.tt + 3 * p + 2)),
        below((wrap_plane(p, -1, zt.nz) - p) * plane),
        above((wrap_plane(p, 1, zt.nz) - p) * plane) {}
  // h at V consecutive elements from e; se: s there, where the caller has
  // it already
  template <int V>
  __device__ __forceinline__ void at(const float* __restrict__ s, long long e,
                                     const float (&se)[V], float (&h)[V]) const {
    float b[V], a[V];
    ldg_vec<V>(s + e + below, b);
    ldg_vec<V>(s + e + above, a);
#pragma unroll
    for (int j = 0; j < V; ++j) h[j] = t0 * b[j] + t1 * se[j] + t2 * a[j];
  }
  __device__ __forceinline__ float at(const float* __restrict__ s, long long e, float se) const {
    const float v[1] = {se};
    float h[1];
    at<1>(s, e, v, h);
    return h[0];
  }
  __device__ __forceinline__ float at(const float* __restrict__ s, long long e) const {
    return at(s, e, __ldg(s + e));
  }
};

// Row p of B_z in difference form (see the top of this file).
struct BzRow {
  long long off[XY_Z_TAPS];
  float w[XY_Z_TAPS];
  __device__ __forceinline__ BzRow(const ZTab& zt, long long p, long long plane) {
    const int taps = 2 * zt.W + 1;
#pragma unroll
    for (int k = 0; k < XY_Z_TAPS; ++k) {
      const bool on = k < taps && k != zt.W;
      off[k] = on ? (wrap_plane(p, k - zt.W, zt.nz) - p) * plane : 0;
      w[k] = on ? __ldg(zt.bt + taps * p + k) : 0.f;
    }
  }
  // B_z g at V consecutive elements from e
  template <int V>
  __device__ __forceinline__ void at(const float* __restrict__ g, long long e,
                                     float (&s)[V]) const {
    float ge[V], gk[V];
    ldg_vec<V>(g + e, ge);
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = 0.f;
#pragma unroll
    for (int k = 0; k < XY_Z_TAPS; ++k) {
      if (w[k] != 0.f) {
        ldg_vec<V>(g + e + off[k], gk);
#pragma unroll
        for (int j = 0; j < V; ++j) s[j] += w[k] * (gk[j] - ge[j]);
      }
    }
  }
  __device__ __forceinline__ float at(const float* __restrict__ g, long long e) const {
    float s[1];
    at<1>(g, e, s);
    return s[0];
  }
};

// The kinds of the chained launches (xy_chain_launch<KIND>): unpaired
// z-RHS families (XY_RHS: K6, K9), advection families (XY_ADV: K13), or
// pairs of an advection family 2g on scheme 0 and a z-RHS family 2g + 1 on
// scheme 1 over the same sy and sx (XY_PAIR: K3, K5). A pair stages two
// tiles, from one read of its source.
enum XYChainKind { XY_RHS, XY_ADV, XY_PAIR };

template <int KIND>
__host__ __device__ constexpr int xy_chain_tiles() {
  return KIND == XY_PAIR ? 2 : 1;
}

// The staged y phase's shared memory for C columns of ny rows in nb chains:
// `tiles` tiles, and each tile's 2 nb face slots a column.
__host__ inline size_t xy_y_bytes(int ny, int nb, int tiles, int C) {
  return (size_t)C * tiles * (ny + 2 * nb) * sizeof(float);
}

// The staged y phase (top of this file): block (blockIdx.x, blockIdx.y)
// takes the C = 1 << cshift columns x0 .. x0 + C - 1 of plane p, x0 = (x
// mod groups) C, p = x / groups, of family (pair) blockIdx.y. Tile s sits
// at smem + s ny C, row m of column l at [m C + l]; then the faces, tile s
// and column l at [(s 2 nb + j) C + l]. Staging and the epilogue move V
// consecutive columns a thread at a time (V = 4: 16-byte accesses, where
// the rows and every field are aligned), and a thread keeps its V columns
// in both. Chain (k, l) of tile s is thread lead + s nb C + k C + l: the
// chains are the block's last threads, and where they are fewer than
// XY_Y_STAGERS whole warps before them help stage and write back, and pass
// solve_chain's barriers on their own. Columns past nx are staged as 0,
// solved and never written.
template <int K, int KIND, int V>
__global__ void __launch_bounds__(XY_Y_MAX_THREADS)
    xy_y_kernel(const __grid_constant__ XYArgs a, int cshift) {
  extern __shared__ __align__(16) float y_smem[];
  constexpr int tiles = xy_chain_tiles<KIND>();
  const XYFamily& F = a.fam[tiles * blockIdx.y];              // a pair's advection family
  const XYFamily& R = a.fam[tiles * blockIdx.y + tiles - 1];  // a pair's z-RHS family
  const int C = 1 << cshift;
  const int ny = a.cy[0].n, nx = a.cx[0].n, nb = a.nby;
  const long long plane = (long long)ny * nx;
  const int groups = (nx + C - 1) >> cshift;
  const long long p = blockIdx.x / groups;
  const int x0 = (blockIdx.x - (int)(p * groups)) << cshift;
  const int valid = min(C, nx - x0);  // a multiple of V
  const long long base = p * plane + x0;  // row 0 of the block's column 0
  const int count = ny << cshift;         // a tile's elements
  float* faces = y_smem + tiles * count;
  // this thread's V columns from l, and its first row, in staging and the
  // epilogue; `rows` threads' rows a step
  const int l = (threadIdx.x * V) & (C - 1);
  const int m0 = (threadIdx.x * V) >> cshift;
  const int rows = (blockDim.x * V) >> cshift;

  if constexpr (KIND == XY_ADV) {
    for (int m = m0; m < ny; m += rows) {
      float* dst = y_smem + (m << cshift) + l;
      const float* src = F.sy + base + (long long)m * nx + l;
      if constexpr (V == 4) {
        if (l < valid) {
          cp_async16(dst, src);
        } else {
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        cp_async4(dst, l < valid ? src : F.sy + base, l < valid);
      }
    }
    cp_async_wait_all();
  } else {
    const TzRow tz(a.zt, p, plane);
#pragma unroll 2
    for (int m = m0; m < ny; m += rows) {
      const int e = (m << cshift) + l;
      const long long g = base + (long long)m * nx + l;
      float v[V], h[V];
      for (int j = 0; j < V; ++j) v[j] = h[j] = 0.f;
      if (l < valid) {
        ldg_vec<V>(F.sy + g, v);  // a pair: one read of sy for both tiles
        tz.at<V>(F.sy, g, v, h);
      }
      if constexpr (KIND == XY_PAIR) st_vec<V>(y_smem + e, v);
      st_vec<V>(y_smem + (tiles - 1) * count + e, h);
    }
  }
  __syncthreads();

  const int chains = nb << cshift;  // a tile's
  const int lead = blockDim.x - tiles * chains;
  if ((int)threadIdx.x >= lead) {
    const int t = threadIdx.x - lead;
    const int s = KIND == XY_PAIR && t >= chains;  // the tile, and its scheme
    const int u = t - s * chains;
    const int k = u >> cshift;
    const Coef& c = a.cy[s];
    float* line = y_smem + s * count + (u & (C - 1));  // line[m C] is row m of this column
    auto nbr = [=](int m) {  // rows past the chain's own, wrapped around the column
      const int mm = m < 0 ? m + ny : (m >= ny ? m - ny : m);
      return line[mm << cshift];
    };
    const bool walls = !c.periodic;
    solve_chain<K, false>(c, LineTab(a.taby[s], ny / nb, nb, k, a.hy[s], a.winy[s], c.periodic),
                          nb, k, line, C, nbr, walls, walls, faces + s * 2 * nb * C + (u & (C - 1)),
                          C, 0.f, 0.f, [=](int g, float v) { line[g << cshift] = v; });
  } else {
    for (int b = 0; b < CHAIN_BARRIERS; ++b) __syncthreads();
  }
  __syncthreads();

  // the epilogue, row by row, coalesced: my Dy sy, Dy (T_z sy) + B_z bz
  if (l >= valid) return;
  auto advection = [&](int e, long long g) {
    float w[V], v[V];
    ldg_vec<V>(F.my + g, w);
    for (int j = 0; j < V; ++j) v[j] = w[j] * y_smem[e + j];
    st_vec<V>(F.out + g, v);
  };
  if constexpr (KIND == XY_ADV) {
    for (int m = m0; m < ny; m += rows) advection((m << cshift) + l, base + (long long)m * nx + l);
  } else {
    const BzRow bz(a.zt, p, plane);
    for (int m = m0; m < ny; m += rows) {
      const int e = (m << cshift) + l;
      const long long g = base + (long long)m * nx + l;
      if constexpr (KIND == XY_PAIR) advection(e, g);
      float w[V], v[V];
      bz.at<V>(R.bz, g, w);
      for (int j = 0; j < V; ++j) v[j] = y_smem[(tiles - 1) * count + e + j] + w[j];
      st_vec<V>(R.out + g, v);
    }
  }
}

// A weighted family's column of the y phase: out = wy Dy (Z sy) + wb B_z bz,
// Z = T_z with TZ, else the identity (and no B_z term).
template <bool TZ>
__device__ __forceinline__ void xyw_y_column(const XYArgs& a, const XYFamily& F, long long col) {
  const Coef& c = a.cy[F.d2];
  const int ny = c.n;
  const long long nx = a.cx[0].n;
  const long long plane = ny * nx;
  const long long p = col / nx;
  const long long base = p * plane + (col - p * nx);
  if constexpr (TZ) {
    if (F.wy == 0.f) {  // no y term: out = wb B_z bz
      const BzRow bz(a.zt, p, plane);
      for (int i = 0; i < ny; ++i) {
        const long long e = base + i * nx;
        F.out[e] = F.wb * bz.at(F.bz, e);
      }
      return;
    }
  }
  // row m of the column (wrapped on periodic lines), -1 past a wall
  auto row = [&](int m) -> long long {
    if (m < ny) return base + m * nx;
    return c.periodic ? base + (m % ny) * nx : -1;
  };
  if constexpr (TZ) {
    const TzRow tz(a.zt, p, plane);
    const BzRow bz(a.zt, p, plane);
    auto src = [&](int m) {
      const long long e = row(m);
      return e < 0 ? 0.f : tz.at(F.sy, e);
    };
    solve_line(c, a.taby[F.d2], src, F.out + base, nx, [&](int i, float v) {
      const long long e = base + i * nx;
      F.out[e] = F.wy * v + F.wb * bz.at(F.bz, e);
    });
  } else {
    auto src = [&](int m) {
      const long long e = row(m);
      return e < 0 ? 0.f : __ldg(F.sy + e);
    };
    solve_line(c, a.taby[F.d2], src, F.out + base, nx, [&](int i, float v) {
      F.out[base + i * nx] = F.wy * v;
    });
  }
}

__global__ void __launch_bounds__(XY_Y_THREADS, 8) xyw_y_kernel(const __grid_constant__ XYArgs a) {
  const XYFamily& F = a.fam[blockIdx.y];
  const long long col = (long long)blockIdx.x * XY_Y_THREADS + threadIdx.x;
  if (col >= a.zt.nz * a.cx[0].n) return;
  if (F.tz) {
    xyw_y_column<true>(a, F, col);
  } else {
    xyw_y_column<false>(a, F, col);
  }
}

// The weighted x phase: a block stages consecutive x-lines of Z sx for one
// family with an x term, warp 0 solves them in place, and the block adds wx
// times them into the family's output.
__global__ void xyw_x_kernel(const __grid_constant__ XYArgs a, int lines_per_block) {
  extern __shared__ float tile[];
  const XYFamily& F = a.fam[a.xfam[blockIdx.y]];
  const int n = a.cx[0].n;
  const int ld = cfd_line_ld(n);
  const long long lines = (long long)a.zt.nz * a.cy[0].n;
  const long long plane = (long long)a.cy[0].n * n;
  const long long line0 = (long long)blockIdx.x * lines_per_block;
  const long long rest = lines - line0;
  const int nl = rest < lines_per_block ? (int)rest : lines_per_block;
  const int count = nl * n;
  const long long e_base = line0 * n;

  float* const tiles[1] = {tile};
  if (F.tz) {
    stage_lines(tiles, count, n, [&](int e, float* v) {
      const long long g = e_base + e;
      v[0] = TzRow(a.zt, g / plane, plane).at(F.sx, g);
    });
  } else {
    stage_lines(tiles, count, n, [&](int e, float* v) { v[0] = __ldg(F.sx + e_base + e); });
  }
  __syncthreads();

  if (threadIdx.x < nl) {
    float* line = tile + threadIdx.x * ld;
    wrap_line(line, n);
    solve_line(a.cx[F.d2], a.tabx[F.d2], [&](int m) { return line[m]; }, line, 1);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int l = e / n;
    F.out[e_base + e] += F.wx * tile[l * ld + (e - l * n)];
  }
}

// The launch's tables: scheme 0 along y and x (c0y, c0x with their per-point
// tables), scheme 1 likewise (may repeat scheme 0), and the z tables of the
// scheme whose T_z and B_z the families use (the chained launches pass no
// x tables: their chain tables come from xy_chain_table).
__host__ inline XYArgs xy_args(const float* tab0y, const float* tab1y, const float* tab0x,
                               const float* tab1x, const Coef* c0y, const Coef* c1y,
                               const Coef* c0x, const Coef* c1x, const float* bt,
                               const float* tt, int nz, int W) {
  XYArgs a = {};
  a.cy[0] = *c0y;
  a.cy[1] = *c1y;
  a.cx[0] = *c0x;
  a.cx[1] = *c1x;
  a.taby[0] = tab0y;
  a.taby[1] = tab1y;
  a.tabx[0] = tab0x;
  a.tabx[1] = tab1x;
  a.zt = {bt, tt, nz, W};
  return a;
}

// The weighted kind's two phases on `s`; `a` is checked by xy_launch.
__host__ inline int xyw_launch(XYArgs a, cudaStream_t s) {
  const int ny = a.cy[0].n, nx = a.cx[0].n;
  a.nxfam = 0;
  for (int k = 0; k < a.nfam; ++k) {
    if (a.fam[k].wx != 0.f) a.xfam[a.nxfam++] = k;
  }
  const long long cols = (long long)a.zt.nz * nx;
  const dim3 ygrid((unsigned)((cols + XY_Y_THREADS - 1) / XY_Y_THREADS), a.nfam);
  xyw_y_kernel<<<ygrid, XY_Y_THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nxfam == 0) return (int)err;
  const size_t line_bytes = (size_t)cfd_line_ld(nx) * sizeof(float);
  int per_block = XY_X_LINES;
  while (per_block > 1 && per_block * line_bytes > XY_X_SMEM) per_block /= 2;
  const long long lines = (long long)a.zt.nz * ny;
  const dim3 xgrid((unsigned)((lines + per_block - 1) / per_block), a.nxfam);
  xyw_x_kernel<<<xgrid, XY_X_THREADS, per_block * line_bytes, s>>>(a, per_block);
  return (int)cudaGetLastError();
}

// An unpaired launch whose first family is an advection family is an
// advection-only launch: every family must be one, and none reads a z
// table.
__host__ inline bool xy_advection(const XYArgs& a) {
  return !a.paired && !a.weighted && !a.fam[0].rhs;
}

// Whether `a` is a launch the kernels take: families, line lengths and a z
// width (each launch checks its x phase's shared memory).
__host__ inline bool xy_valid(const XYArgs& a) {
  const int ny = a.cy[0].n, nx = a.cx[0].n;
  bool ok = a.nfam >= 1 && a.nfam <= XY_MAX_FAMILIES && a.cy[1].n == ny && a.cx[1].n == nx &&
            a.zt.W >= 0 && a.zt.W <= CFD_MAX_K && a.zt.nz >= 1 && (!a.paired || a.nfam % 2 == 0) &&
            !(a.paired && a.weighted);
  const bool advection = ok && xy_advection(a);
  for (int k = 0; ok && k < a.nfam; ++k) {
    const XYFamily& F = a.fam[k];
    if (a.weighted) {
      // every output point is written by the y phase: a y term or B_z
      ok = (F.wy != 0.f || F.tz) && (F.wy == 0.f || F.sy) && (F.wx == 0.f || F.sx) &&
           (!F.tz || (F.bz && F.wb != 0.f && a.zt.bt && a.zt.tt));
      continue;
    }
    if (advection) {
      ok = !F.rhs && F.sy && F.sx && F.my && F.mx;
      continue;
    }
    const bool rhs = !a.paired || k % 2 == 1;
    ok = F.rhs == (int)rhs &&
         (!a.paired || rhs || (F.sx == a.fam[k + 1].sx && F.sy == a.fam[k + 1].sy));
  }
  return ok;
}

// Both phases of a weighted launch `a` on `stream` (K8, K10), the x phase
// one thread a line. Families, line lengths or a z width the kernels do
// not take, x lines past 48 KB, and any launch that is not weighted
// (xy_chain_launch takes those) return cudaErrorInvalidValue.
__host__ inline int xy_launch(const XYArgs& a, void* stream) {
  if (!xy_valid(a) || a.nb != 0 || !a.weighted) return (int)cudaErrorInvalidValue;
  if ((size_t)cfd_line_ld(a.cx[0].n) * sizeof(float) > XY_X_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  return xyw_launch(a, (cudaStream_t)stream);
}

// The chained x phase, of one of three kinds (xy_chain_launch<KIND>):
// unpaired z-RHS families (XY_RHS: K6, K9), advection families (XY_ADV:
// K13), or pairs of an advection family 2g on scheme 0 and a z-RHS family
// 2g + 1 on scheme 1 over the same sx (XY_PAIR: K3, K5). A block runs
// `lines_per_block` = L lines of one family (one pair), nb chains a line,
// one thread a chain (line_chains.cuh, as compact_lane.cu's kernel). The
// shared memory holds, where a z-RHS family is staged, the L lines' T_z
// rows (each made once, by one thread, so that staging an element costs no
// division or wrap), then the tile in the chain layout and 2 nb face slots
// a line. Staging writes T_z sx (three planes; plain stores) or sx
// (cp.async) there; a pair stages both from one read of each element of
// sx, sx as lines 0 .. L - 1 of the tile and T_z sx as lines L .. 2L - 1,
// so that one walk and one layout serve both. solve_line_chain solves in
// place, a pair's first L nb chains on scheme 0's chain table and the rest
// on scheme 1's, all at the wider stencil K of the two (the narrower
// scheme's weights past its own are 0, so its rows are the same sums); the
// block adds the result, times mx for advection, into the outputs,
// coalesced on the element. The chains are the block's last threads. Where
// they are fewer than XY_CHAIN_STAGERS (a line with few chains: one on a
// prime line, 14 at nx = 12278), whole warps before them help stage and
// write back, and pass solve_chain's barriers on their own.
template <int K, int KIND>
__global__ void __launch_bounds__(XY_CHAIN_THREADS)
    xy_chain_x_kernel(const __grid_constant__ XYArgs a, int lines_per_block) {
  extern __shared__ float4 chain_smem[];
  constexpr int tiles = xy_chain_tiles<KIND>();
  const XYFamily& F = a.fam[tiles * blockIdx.y];              // a pair's advection family
  const XYFamily& R = a.fam[tiles * blockIdx.y + tiles - 1];  // a pair's z-RHS family
  const int n = a.cx[0].n, nb = a.nb, L = lines_per_block;
  const long long ny = a.cy[0].n;
  const long long lines = (long long)a.zt.nz * ny;
  const long long line0 = (long long)blockIdx.x * L;
  const long long rest = lines - line0;
  const int nl = rest < L ? (int)rest : L;
  const int count = nl * n;
  const long long e_base = line0 * n;
  const int half = L * nb;  // a pair's z-RHS chains start here
  TzRow* tz = reinterpret_cast<TzRow*>(chain_smem);  // L rows (a z-RHS family only)
  float* tile = reinterpret_cast<float*>(tz + (KIND == XY_ADV ? 0 : L));
  const int cs = line_chain_stride(tiles * half);
  float* faces = tile + (n / nb) * cs;  // 2 nb a line

  if constexpr (KIND == XY_ADV) {
    walk_chains(count, n, nb, cs,
                [&](int e, int at, int) { cp_async4(tile + at, F.sx + e_base + e); });
    cp_async_wait_all();
  } else {
    if (threadIdx.x < nl) tz[threadIdx.x] = TzRow(a.zt, (line0 + threadIdx.x) / ny, ny * n);
    __syncthreads();
    walk_chains(count, n, nb, cs, [&](int e, int at, int l) {
      const long long g = e_base + e;
      if constexpr (KIND == XY_PAIR) {
        const float v = __ldg(F.sx + g);
        tile[at] = v;
        tile[at + half] = tz[l].at(R.sx, g, v);
      } else {
        tile[at] = tz[l].at(F.sx, g);
      }
    });
  }
  __syncthreads();
  const int lead = blockDim.x - tiles * half;  // staging threads before the chains, whole warps
  if ((int)threadIdx.x >= lead) {
    const int t = threadIdx.x - lead;
    const int s = KIND == XY_PAIR && t >= half;  // the chain's scheme
    solve_line_chain<K>(a.cx[s], a.chx[s], nb, a.h[s], a.win[s], tile, cs, faces, t);
  } else {
    for (int b = 0; b < CHAIN_BARRIERS; ++b) __syncthreads();
  }
  __syncthreads();
  walk_chains(count, n, nb, cs, [&](int e, int at, int) {
    const long long g = e_base + e;
    if constexpr (KIND == XY_PAIR) {
      F.out[g] += __ldg(F.mx + g) * tile[at];
      R.out[g] += tile[at + half];
    } else {
      F.out[g] += KIND == XY_ADV ? __ldg(F.mx + g) * tile[at] : tile[at];
    }
  });
}

// The chained x phase's shared memory for L lines of n points in nb chains.
template <int KIND>
__host__ inline size_t xy_chain_bytes(int n, int nb, int L) {
  constexpr int tiles = xy_chain_tiles<KIND>();
  return (KIND == XY_ADV ? 0 : (size_t)L * sizeof(TzRow)) +
         ((size_t)(n / nb) * line_chain_stride(tiles * L * nb) + (size_t)tiles * L * 2 * nb) *
             sizeof(float);
}

template <int K, int KIND>
__host__ inline void xy_chain_x(const XYArgs& a, unsigned blocks, int per_block, size_t smem,
                                cudaStream_t s) {
  constexpr int tiles = xy_chain_tiles<KIND>();
  const int chains = tiles * per_block * a.nb;
  const int lead = chains < XY_CHAIN_STAGERS ? (XY_CHAIN_STAGERS - chains + 31) / 32 * 32 : 0;
  xy_chain_x_kernel<K, KIND><<<dim3(blocks, a.nfam / tiles), lead + chains, smem, s>>>(a,
                                                                                      per_block);
}

// The y phase of every family of the chained launch `a` (of kind KIND) on
// `s`: staged, C columns a block (XY_Y_COLS, halved while half of them
// still covers the plane's nx, then while the block passes
// XY_Y_MAX_THREADS or its shared memory the device's opt-in maximum), K
// the chains' stencil width. A column whose tiles pass the opt-in maximum
// returns cudaErrorInvalidValue.
template <int KIND>
__host__ inline cudaError_t xy_y_launch(const XYArgs& a, int K, cudaStream_t s) {
  constexpr int tiles = xy_chain_tiles<KIND>();
  const int ny = a.cy[0].n, nx = a.cx[0].n, nb = a.nby;
  // per device: the dynamic shared memory these kernels have been opted in
  // to (the device's per-block maximum)
  static int optin[DIST_MAX_DEVICES];
  const void* kernels[] = {(const void*)xy_y_kernel<1, KIND, 1>, (const void*)xy_y_kernel<2, KIND, 1>,
                           (const void*)xy_y_kernel<3, KIND, 1>, (const void*)xy_y_kernel<1, KIND, 4>,
                           (const void*)xy_y_kernel<2, KIND, 4>, (const void*)xy_y_kernel<3, KIND, 4>};
  int limit;
  cudaError_t err = dist_smem_limit(optin, kernels, 6, &limit);
  if (err != cudaSuccess) return err;
  int cshift = 0;
  while ((1 << cshift) < XY_Y_COLS) ++cshift;
  while (cshift > 0 && (1 << (cshift - 1)) >= nx) --cshift;
  while (cshift > 0 && (tiles * nb << cshift > XY_Y_MAX_THREADS ||
                        xy_y_bytes(ny, nb, tiles, 1 << cshift) > (size_t)limit)) {
    --cshift;
  }
  const int C = 1 << cshift;
  const size_t smem = xy_y_bytes(ny, nb, tiles, C);
  const int chains = tiles * nb * C;
  if (smem > (size_t)limit || chains > XY_Y_MAX_THREADS) return cudaErrorInvalidValue;
  const int lead = chains < XY_Y_STAGERS ? (XY_Y_STAGERS - chains + 31) / 32 * 32 : 0;
  const dim3 grid((unsigned)((long long)a.zt.nz * ((nx + C - 1) / C)), a.nfam / tiles);
  // 16-byte accesses where every row of every field the families read or
  // write starts on 16 bytes
  uintptr_t ptrs = 0;
  for (int k = 0; k < a.nfam; ++k) {
    const XYFamily& F = a.fam[k];
    ptrs |= (uintptr_t)F.sy | (uintptr_t)F.my | (uintptr_t)F.bz | (uintptr_t)F.out;
  }
  const bool v4 = C % 4 == 0 && nx % 4 == 0 && ptrs % 16 == 0;
#define XY_Y_LAUNCH(k)                                                        \
  if (v4) {                                                                   \
    xy_y_kernel<k, KIND, 4><<<grid, lead + chains, smem, s>>>(a, cshift);     \
  } else {                                                                    \
    xy_y_kernel<k, KIND, 1><<<grid, lead + chains, smem, s>>>(a, cshift);     \
  }
  if (K == 1) {
    XY_Y_LAUNCH(1);
  } else if (K == 2) {
    XY_Y_LAUNCH(2);
  } else {
    XY_Y_LAUNCH(3);
  }
#undef XY_Y_LAUNCH
  return cudaGetLastError();
}

// Scheme s's chain table along x (ops/lane.py `chain_table`) for nb
// sub-blocks a line, and its reduced rows' window (h, win), into `a`.
__host__ inline void xy_chain_table(XYArgs& a, int s, const float* chx, int nb, int h, int win) {
  a.chx[s] = chx;
  a.nb = nb;
  a.h[s] = h;
  a.win[s] = win;
}

// Scheme s's reduced rows' window (h, win) along y, for the nb sub-blocks
// of a y-line whose chain table a.taby[s] is, into `a`.
__host__ inline void xy_y_chains(XYArgs& a, int s, int nb, int h, int win) {
  a.nby = nb;
  a.hy[s] = h;
  a.winy[s] = win;
}

// Whether the families of `a` are of the chained kind KIND: every family
// on scheme 0 (XY_RHS, XY_ADV), or each pair's advection family on scheme
// 0 and its z-RHS family on scheme 1 (XY_PAIR).
template <int KIND>
__host__ inline bool xy_chain_kind(const XYArgs& a) {
  if (a.weighted || (a.paired != 0) != (KIND == XY_PAIR) ||
      (KIND != XY_PAIR && xy_advection(a) != (KIND == XY_ADV))) {
    return false;
  }
  for (int k = 0; k < a.nfam; ++k) {
    if (a.fam[k].d2 != (KIND == XY_PAIR ? k % 2 : 0)) return false;
  }
  return true;
}

// Both phases of `a` on `stream`, the x phase in sub-block chains, of the
// kind KIND (above): K6 and K9 (XY_RHS), K13 (XY_ADV), K3 and K5 (XY_PAIR).
// `a.chx[s]`, `a.h[s]` and `a.win[s]` (xy_chain_table) describe the chain
// table along x of each scheme s the families use, for `a.nb` sub-blocks a
// line (a divisor of nx; at most XY_CHAIN_THREADS chains a line in all);
// `a.taby[s]`, `a.hy[s]` and `a.winy[s]` (xy_y_chains) its chain table
// along y for `a.nby` sub-blocks a y-line (a divisor of ny). An x block runs
// XY_CHAIN_THREADS / (nb tiles) lines, fewer until they fit 48 KB, at least
// one, in the device's opt-in maximum where one line passes 48 KB, with at
// least XY_CHAIN_STAGERS threads. Anything else, and an x-line or a y
// block's column past that maximum, returns cudaErrorInvalidValue before
// either phase runs.
template <int KIND>
__host__ inline int xy_chain_launch(const XYArgs& a, void* stream) {
  constexpr int tiles = xy_chain_tiles<KIND>();
  const int nx = a.cx[0].n, nb = a.nb;
  const int ny = a.cy[0].n, nby = a.nby;
  bool ok = xy_valid(a) && xy_chain_kind<KIND>(a) && nb >= 1 &&
            tiles * nb <= XY_CHAIN_THREADS && nx % nb == 0 && nby >= 1 &&
            tiles * nby <= XY_Y_MAX_THREADS && ny % nby == 0;
  int K = 0;
  for (int s = 0; ok && s < tiles; ++s) {
    ok = a.chx[s] && a.win[s] >= 1 && a.win[s] <= 2 * nb && a.taby[s] &&
         a.winy[s] >= 1 && a.winy[s] <= 2 * nby;
    const int k = a.cx[s].K > a.cy[s].K ? a.cx[s].K : a.cy[s].K;
    ok = ok && a.cx[s].K >= 1 && a.cy[s].K >= 1 && k <= CFD_MAX_K;
    K = k > K ? k : K;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  int per_block = XY_CHAIN_THREADS / (tiles * nb);
  while (per_block > 1 && xy_chain_bytes<KIND>(nx, nb, per_block) > XY_X_SMEM) --per_block;
  const size_t smem = xy_chain_bytes<KIND>(nx, nb, per_block);
  if (smem > XY_X_SMEM) {
    // per device: the dynamic shared memory these kernels have been opted
    // in to (the device's per-block maximum), 0 until the first launch
    // there that needs it
    static int optin[DIST_MAX_DEVICES];
    const void* kernels[] = {(const void*)xy_chain_x_kernel<1, KIND>,
                             (const void*)xy_chain_x_kernel<2, KIND>,
                             (const void*)xy_chain_x_kernel<3, KIND>};
    int limit;
    const cudaError_t err = dist_smem_limit(optin, kernels, 3, &limit);
    if (err != cudaSuccess) return (int)err;
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = xy_y_launch<KIND>(a, K, s);
  if (err != cudaSuccess) return (int)err;
  const long long lines = (long long)a.zt.nz * a.cy[0].n;
  const unsigned blocks = (unsigned)((lines + per_block - 1) / per_block);
  if (K == 1) {
    xy_chain_x<1, KIND>(a, blocks, per_block, smem, s);
  } else if (K == 2) {
    xy_chain_x<2, KIND>(a, blocks, per_block, smem, s);
  } else {
    xy_chain_x<3, KIND>(a, blocks, per_block, smem, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace
