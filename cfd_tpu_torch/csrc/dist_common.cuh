// Shared pieces of the shard-local kernels K11 (lane_dist.cu) and K12
// (strided_dist.cu): one shard's line of a distributed compact solve, cut
// into sub-blocks whose Thomas chains run side by side. K1 runs the same
// chains on whole lines (line_chains.cuh): solve_chain takes
// the table and the rows past a chain's own through an interface, so that
// both layouts share the sweeps.
//
// A line of a shard holds n = c.n points f[0 .. n) and the w = c.K halo
// rows of its neighbours, f[-w .. 0) and f[n .. n + w). Its local block T_r
// is a plain tridiagonal block, never cyclic: under a periodic scheme the
// ring of shards closes in the reduced interface system (parallel/
// compact.py), so there is no Sherman–Morrison term here. The end shards of
// a non-periodic line carry the closure rows: `first` forms rows 0 ..
// n_rows-1 and `last` rows n-1 .. n-n_rows from f itself, in the difference
// (or second-difference) form of compact_common.cuh, and never read their
// open-side halo. Every other row is the interior stencil, reading halo rows
// where it crosses the shard's ends.
//
// Sub-blocks (the substructuring of cfd_tpu/ops/pallas_leading.py, one
// level inside the shard). T_r is cut into nb sub-blocks of bz = n / nb
// rows (parallel/dist_tables.py `pick_nb`: 8, 4 or 2 of at least 32 rows,
// else 1), and one thread runs sub-block k's chain over rows s = k bz ..
// e = s + bz - 1 (`solve_chain`):
//
//   1. a forward sweep against the sub-block's own factors (its couplings
//      to the neighbouring sub-blocks cut), forming the RHS from the staged
//      line; the sub-block-first face of x_R accumulates against t0, the
//      first row of the sub-block's inverse, and the sub-block-last face is
//      the final carry times the last pivot;
//   2. the line's 2 nb faces meet in shared memory, and the chain's weights
//      (alpha, beta) are its two rows of the (2nb, 2nb) intra reduced
//      inverse dotted with them;
//   3. a backward sweep storing x_R + alpha uh + beta lh, plus the shard's
//      outer update a suh + b slh.
//
// With nb = 1 the reduced inverse and the intra loads are zero, and the one
// chain is the plain Thomas solve of the block.
//
// The forward intermediate overwrites f in place in the staged line. A
// chain's stencil reads the w <= 3 rows of each neighbouring sub-block next
// to its own ends; it loads them into registers before a barrier, after
// which every chain writes only its own rows and reads only its own rows
// and those registers. So one tile, staged once, serves the whole solve.

#pragma once

#include "compact_common.cuh"

// Per-point table of a shard's block, float32, point-major: row g at
// tab + DIST_TAB_ROW * g holds the eight values a chain reads at row g,
// ordered so that the backward sweep reads a float4 and a float2 and the
// forward sweep a float2. Rows -1 and n are zero, so that the sweeps load
// a row ahead without a test; the (2nb, 2nb) intra reduced inverse follows
// row n, row-major (ops/dist.py `_chain_table`). The kernels take the
// table at row -1 (`dist_rows` gives row 0).
#define DIST_TAB_INVD 0  // 1 / pivots of the sub-block
#define DIST_TAB_DU 1    // superdiagonal (0 on a sub-block's last row)
#define DIST_TAB_UH 2    // intra unit load of the coupling to the sub-block above
#define DIST_TAB_LH 3    // intra unit load of the coupling to the sub-block below
#define DIST_TAB_SUH 4   // shard unit load of the left neighbour's coupling
#define DIST_TAB_SLH 5   // shard unit load of the right neighbour's coupling
#define DIST_TAB_W 6     // forward multipliers (0 on a sub-block's first row)
#define DIST_TAB_T0 7    // first row of the sub-block's inverse
#define DIST_TAB_ROW 8

#define DIST_MAX_NB 8                  // pick_nb's most sub-blocks
#define DIST_AHEAD 4                   // f rows from its own a forward step holds (> CFD_MAX_K)
#define DIST_BEHIND 4                  // z rows the backward sweep holds below its row
#define DIST_STEP 4                    // rows a sweep takes at a time in a chain's middle
#define DIST_SMEM_DEFAULT (48 * 1024)  // bytes a block gets without opting in
#define CHAIN_BARRIERS 2               // the __syncthreads() of one solve_chain call
#define DIST_MAX_DEVICES 64

// v[j] for a register array, 0 <= j < K.
template <int K>
__device__ __forceinline__ float pick(const float (&v)[K], int j) {
  float r = v[0];
#pragma unroll
  for (int i = 1; i < K; ++i) r = j == i ? v[i] : r;
  return r;
}

// The scaled right-hand side of a chain's rows, from a window of f held in
// registers: f[g - K .. g + DIST_AHEAD) while row g is formed. K is the
// scheme's widest offset (c.K), so the interior row takes exactly its taps.
// The constructor reads the rows below the chain's first row s and the
// closure rows; `src(m)` returns f[m] for -K <= m < n + K and 0 outside.
template <int K, class Src>
struct ChainRhs {
  const Coef& c;
  Src src;
  const bool first, last;  // this chain forms the line's left / right closure rows
  float cl[CFD_MAX_ROWS], cr[CFD_MAX_ROWS];
  float b[K];           // f[g - 1], ..., f[g - K]
  float a[DIST_AHEAD];  // f[g], ..., f[g + DIST_AHEAD - 1]
  __device__ __forceinline__ ChainRhs(const Coef& c_, Src src_, int s, bool first_, bool last_)
      : c(c_), src(src_), first(first_), last(last_) {
    const int n = c.n;
#pragma unroll
    for (int j = 0; j < CFD_MAX_ROWS; ++j) {
      cl[j] = first && j < c.n_rows ? c.scale * closure_row(c, src, j) : 0.f;
      cr[j] = last && j < c.n_rows ? c.scale * closure_row(c, src, n - 1 - j) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) b[j] = src(s - 1 - j);
#pragma unroll
    for (int j = 0; j < DIST_AHEAD; ++j) a[j] = src(s + j);
  }
  // Row g: a closure row where WALLS and the chain forms one, else the
  // interior stencil.
  template <bool WALLS>
  __device__ __forceinline__ float row(int g) const {
    if (WALLS) {
      if (first && g < c.n_rows) return pick(cl, g);
      if (last && g >= c.n - c.n_rows) return pick(cr, c.n - 1 - g);
    }
    const float fi = a[0];
    float r = c.center * fi;
#pragma unroll
    for (int k = 0; k < K; ++k) r += c.w[k] * ((a[k + 1] - fi) + c.sign * (b[k] - fi));
    return r * c.scale;
  }
  // Move the window one row on; `ahead` is f[g + DIST_AHEAD].
  __device__ __forceinline__ void shift(float ahead) {
#pragma unroll
    for (int k = K - 1; k > 0; --k) b[k] = b[k - 1];
    b[0] = a[0];
#pragma unroll
    for (int k = 0; k < DIST_AHEAD - 1; ++k) a[k] = a[k + 1];
    a[DIST_AHEAD - 1] = ahead;
  }
};

__device__ __forceinline__ const float* dist_rows(const float* table) {
  return table + DIST_TAB_ROW;
}
__device__ __forceinline__ float4 dist_row4(const float* __restrict__ tab, int g) {
  return __ldg(reinterpret_cast<const float4*>(tab + DIST_TAB_ROW * g));
}
__device__ __forceinline__ float2 dist_row2(const float* __restrict__ tab, int g, int at) {
  return __ldg(reinterpret_cast<const float2*>(tab + DIST_TAB_ROW * g + at));
}

// The table of a shard's block as K11/K12 read it (point-major, DIST_TAB_*,
// `tab` at row 0): what a chain reads at row g on its forward sweep (w,
// t0), on its backward sweep (invd, du, uh, lh) and for the shard update
// (suh, slh); and the chain's weights (alpha, beta), its two rows of the
// (2nb, 2nb) intra reduced inverse dotted with the line's 2 nb faces.
struct DistTab {
  const float* __restrict__ tab;
  int n;
  __device__ __forceinline__ float2 fwd(int g) const { return dist_row2(tab, g, DIST_TAB_W); }
  __device__ __forceinline__ float4 bwd(int g) const { return dist_row4(tab, g); }
  __device__ __forceinline__ float2 shard(int g) const { return dist_row2(tab, g, DIST_TAB_SUH); }
  __device__ __forceinline__ void reduce(const float* faces, int fstride, int k, int nb,
                                         float& alpha, float& beta) const {
    const float* rinv = tab + DIST_TAB_ROW * (n + 1) + 2 * k * 2 * nb;
#pragma unroll
    for (int j = 0; j < 2 * DIST_MAX_NB; ++j) {
      if (j < 2 * nb) {
        const float fj = faces[j * fstride];
        alpha += __ldg(rinv + j) * fj;
        beta += __ldg(rinv + 2 * nb + j) * fj;
      }
    }
  }
};

// Chain k of nb of one staged line, solved in place against the table
// `tab` (DistTab's interface): `line[g * stride]` is f[g] for the chain's
// own rows s <= g <= e, and `nbr(m)` returns f[m] for the rows of the
// neighbouring sub-blocks it reads, s - K <= m < s and e < m <= e + K (K =
// c.K). `store(g, x_g)` receives the solution with the intra update and,
// with AB, the shard update a suh + b slh, from row e down to s.
// `faces[j * fstride]`, j < 2 nb, is this line's face slot in shared
// memory. Every thread of the block calls it, or passes CHAIN_BARRIERS
// barriers of its own in whole warps: it holds two barriers.
//
// The sweeps are bound by the instructions they issue and by latency (16
// warps an SM at a 128^3 shard). Each runs its middle rows without a test
// (no closure row, every row it reads inside the chain), DIST_STEP rows at
// a time, and its first and last rows with them.
template <int K, bool AB, class Tab, class Nbr, class Store>
__device__ __forceinline__ void solve_chain(const Coef& c, const Tab& tab, int nb, int k,
                                            float* line, int stride, Nbr nbr, bool first,
                                            bool last, float* faces, int fstride, float a,
                                            float b, Store store) {
  const int n = c.n;
  const int bz = n / nb;
  const int s = k * bz;
  const int e = s + bz - 1;
  float right[K];  // f[e + 1 .. e + K]: the next sub-block's first rows
#pragma unroll
  for (int j = 0; j < K; ++j) right[j] = nbr(e + 1 + j);
  auto src = [&](int m) {
    if (m > e) return m - e - 1 < K ? pick(right, m - e - 1) : 0.f;
    if (m < s) return m >= -K ? nbr(m) : 0.f;
    return line[m * stride];
  };
  ChainRhs<K, decltype(src)> rhs(c, src, s, first && k == 0, last && k == nb - 1);
  __syncthreads();  // every chain holds what it reads of its neighbours' rows

  // Each row's table values are loaded a row ahead: a load issued after the
  // previous row's store would wait in the row's path.
  float z = 0.f, ff = 0.f;
  float2 wt_next = tab.fwd(s);
  auto forward = [&](int g, float r) {
    const float2 wt = wt_next;
    wt_next = tab.fwd(g + 1);
    z = r - wt.x * z;
    ff += wt.y * r;
    line[g * stride] = z;
  };
  int g = s;
  for (; g < s + CFD_MAX_ROWS && g <= e; ++g) {  // may hold the left closure rows
    const float r = rhs.template row<true>(g);
    rhs.shift(src(g + DIST_AHEAD));
    forward(g, r);
  }
  // interior rows with f[g + DIST_AHEAD] in the chain, DIST_STEP at a time:
  // no exit inside a step, so the window moves by renaming registers
#pragma unroll 1
  for (; g + DIST_STEP - 1 <= e - DIST_AHEAD; g += DIST_STEP) {
#pragma unroll
    for (int u = 0; u < DIST_STEP; ++u) {
      const float r = rhs.template row<false>(g + u);
      rhs.shift(line[(g + u + DIST_AHEAD) * stride]);
      forward(g + u, r);
    }
  }
#pragma unroll 1
  for (; g <= e; ++g) {  // the rest, which may hold the right closure rows
    const float r = rhs.template row<true>(g);
    rhs.shift(src(g + DIST_AHEAD));
    forward(g, r);
  }
  const float4 te = tab.bwd(e);
  faces[2 * k * fstride] = -ff;
  faces[(2 * k + 1) * fstride] = -(z * te.x);
  __syncthreads();  // the line's 2 nb faces are in

  float alpha = 0.f, beta = 0.f;
  tab.reduce(faces, fstride, k, nb, alpha, beta);

  auto shard_loads = [&](int g) {
    if constexpr (AB) {
      return tab.shard(g);
    } else {
      return make_float2(0.f, 0.f);
    }
  };
  auto update = [&](float x, const float4& t, const float2& sl) {
    float v = x + alpha * t.z + beta * t.w;
    if (AB) v += a * sl.x + b * sl.y;
    return v;
  };
  float x = z * te.x;
  float4 t_next = tab.bwd(e - 1);
  float2 sl_next = shard_loads(e - 1);
  auto backward = [&](int g, float zg) {
    const float4 t = t_next;
    const float2 sl = sl_next;
    t_next = tab.bwd(g - 1);
    sl_next = shard_loads(g - 1);
    x = (zg - t.y * x) * t.x;
    store(g, update(x, t, sl));
  };
  float zb[DIST_BEHIND];  // z[g - 1], z[g - 2], ... below the row being solved
#pragma unroll
  for (int j = 0; j < DIST_BEHIND; ++j) zb[j] = e - 1 - j >= s ? line[(e - 1 - j) * stride] : 0.f;
  store(e, update(x, te, shard_loads(e)));
  auto behind = [&](float below) {  // z[g], with z[g - DIST_BEHIND] = `below` taken in
    const float zg = zb[0];
#pragma unroll
    for (int j = 0; j < DIST_BEHIND - 1; ++j) zb[j] = zb[j + 1];
    zb[DIST_BEHIND - 1] = below;
    return zg;
  };
  g = e - 1;
#pragma unroll 1
  for (; g - (DIST_STEP - 1) >= s + DIST_BEHIND; g -= DIST_STEP) {
#pragma unroll
    for (int u = 0; u < DIST_STEP; ++u) {
      backward(g - u, behind(line[(g - u - DIST_BEHIND) * stride]));
    }
  }
#pragma unroll 1
  for (; g >= s; --g) {
    backward(g, behind(g - DIST_BEHIND >= s ? line[(g - DIST_BEHIND) * stride] : 0.f));
  }
}

// solve_chain for one staged shard line of K11/K12, line[m * stride] =
// f[m] for -K <= m < n + K (K = c.K), against the table `tab` at row 0. A
// warp's threads share k, so every table read is one load a row for the
// warp.
template <int K, bool AB, class Store>
__device__ __forceinline__ void solve_chain(const Coef& c, const float* __restrict__ tab, int nb,
                                            int k, float* line, int stride, bool first,
                                            bool last, float* faces, int fstride, float a,
                                            float b, Store store) {
  solve_chain<K, AB>(c, DistTab{tab, c.n}, nb, k, line, stride,
                     [=](int m) { return line[m * stride]; }, first, last, faces, fstride, a, b,
                     store);
}

// cp.async copies from device memory to shared memory: 16 bytes (both
// addresses 16-byte aligned), or 4 bytes, zero-filled where `valid` is false
// (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid = true) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The dynamic shared memory a block of `kernels` may use on the current
// device: its opt-in maximum, opted in once per device (`optin` caches it).
static inline cudaError_t dist_smem_limit(int* optin, const void* const* kernels, int count,
                                          int* bytes) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= DIST_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!optin[dev]) {
    int most;
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    for (int i = 0; i < count; ++i) {
      err = cudaFuncSetAttribute(kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (err != cudaSuccess) return err;
    }
    optin[dev] = most;
  }
  *bytes = optin[dev];
  return cudaSuccess;
}
