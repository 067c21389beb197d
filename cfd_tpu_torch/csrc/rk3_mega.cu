// K4 `rk3_mega`: one low-storage RK3 substep's z-work of the advection–
// diffusion model on a float32 (nz, ny, nx) field, in one pass down z:
//
//   fz  = d1z f                    (the d1 scheme's RHS, Thomas sweep)
//   lap = T2z^{-1} r               (r is the RHS; the d2 scheme's LHS)
//   q'  = a q + dt (nu lap - (axy + uz fz))     (no q on the first substep)
//   f'  = f + b q'
//
// Replaces: cfd_tpu/ops/pallas_megastep.py `_mega_kernel` (called by
// `_call_mega`). The TPU kernel interleaves substructured sub-block chains
// in VMEM for its (8, 128) tiles; here one thread owns one (y, x) column and
// runs the two sweep families interleaved down z, as K2 walks one: family A
// solves the d1 system of f (with closure rows, or the periodic wrap and its
// Sherman–Morrison term), family B the d2 LHS against r. The backward sweeps
// meet row by row, so the RK update is their epilogue.
//
// Bound on Hopper: by its work, bytes. The least it must move is 5 reads
// (f, r, axy, uz, q) and 2 writes (q', f') of f32 per point, 470 MB at
// 256^3: 6 passes on the first substep (no q) and on the last (q' is dead,
// write_q = 0). The sweeps are ~45 flops per point. This simple form moves
// more: each family's forward sweep stores its intermediate and the backward
// sweep reads it back (in the q' and f' buffers, so the scratch costs no
// memory; with write_q = 0 the wrapper gives a scratch buffer in q's place),
// and f is read twice: 11 passes. At 256^3 there are only 65,536 columns,
// about 500 threads per SM, each row waiting on memory latency as in K2
// (PERF.md); the two interleaved families give each thread two independent
// recurrences. Splitting each column into chains with a reduced interface
// solve, as pallas_leading.py does, is the way to more parallelism.

#include "compact_common.cuh"

#define MEGA_THREADS 128  // columns per block

struct Rk3Coef {
  float a, b, dt, dt_nu;  // q' = a q + dt_nu lap - dt adv;  f' = f + b q'
};

__global__ void rk3_mega_kernel(const float* __restrict__ f,
                                const float* __restrict__ r,
                                const float* __restrict__ axy,
                                const float* __restrict__ uz,
                                const float* __restrict__ q,  // null: no q
                                float* qout, float* fout,
                                const float* __restrict__ tab1,
                                const float* __restrict__ tab2,
                                const __grid_constant__ Coef c1,
                                const __grid_constant__ Coef c2,
                                const Rk3Coef k, int write_q, long long cols) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const int n = c1.n;
  auto fsrc = [&](int m) {
    if (m >= n) {
      if (!c1.periodic) return 0.f;
      m %= n;
    }
    return __ldg(f + col + m * cols);
  };
  auto rsrc = [&](int m) { return m < n ? __ldg(r + col + m * cols) : 0.f; };
  LineRhs<decltype(fsrc)> rhs_a(c1, fsrc);
  Ahead<decltype(rsrc)> rhs_b(rsrc);
  Sweep sa(c1, tab1), sb(c2, tab2);
  float* ya = fout + col;  // family A's forward values
  float* yb = qout + col;  // family B's
  for (int i = 0; i < n; ++i) {
    ya[i * cols] = sa.forward(i, rhs_a.next(i));
    yb[i * cols] = sb.forward(i, rhs_b.next(i));
  }
  Behind za(ya, cols, n), zb(yb, cols, n);
  // row i of q' and f' overwrites row i of the scratch, which the backward
  // sweeps have read (Behind reads only rows below i from here on)
  auto update = [&](int i, float fz, float lap) {
    const long long e = col + i * cols;
    const float adv = __ldg(axy + e) + __ldg(uz + e) * fz;
    float qn = k.dt_nu * lap - k.dt * adv;
    if (q) qn += k.a * __ldg(q + e);
    if (write_q) qout[e] = qn;
    fout[e] = __ldg(f + e) + k.b * qn;
  };
  update(n - 1, sa.last(c1), sb.last(c2));
  for (int i = n - 2; i >= 0; --i) {
    const float fz = sa.backward(i, za.next(i));
    const float lap = sb.backward(i, zb.next(i));
    update(i, fz, lap);
  }
}

// Fields (n, cols) with n = c1->n = c2->n rows of `cols` columns each:
// (nz, ny * nx). q may be null (first substep); qout is q' when write_q is
// 1 and scratch otherwise.
extern "C" int cfd_rk3_mega(const float* f, const float* r, const float* axy,
                            const float* uz, const float* q, float* qout,
                            float* fout, const float* tab1, const float* tab2,
                            const Coef* c1, const Coef* c2, float a, float b,
                            float dt, float dt_nu, int write_q, long long cols,
                            void* stream) {
  if (c1->n != c2->n) return (int)cudaErrorInvalidValue;
  const long long blocks = (cols + MEGA_THREADS - 1) / MEGA_THREADS;
  const Rk3Coef k = {a, b, dt, dt_nu};
  rk3_mega_kernel<<<(unsigned)blocks, MEGA_THREADS, 0, (cudaStream_t)stream>>>(
      f, r, axy, uz, q, qout, fout, tab1, tab2, *c1, *c2, k, write_q, cols);
  return (int)cudaGetLastError();
}
