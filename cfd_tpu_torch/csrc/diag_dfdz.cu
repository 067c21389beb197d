// K15 `diag_dfdz`: the stripped stages of the dfdz kernel on the (nz, L)
// layout of a 3-D field (L = ny * nx), one mode per stage.
//
// Replaces: benchmarks/diag_dfdz.py `_pallas2d` with its bodies `k_copy`
// (mode 0: out = f), `k_rolls` (mode 1: the RHS stage alone, cyclic along
// the leading axis, g[i] = f[i+1] - f[i] then out[i] = g[i] + g[i-1], the
// body's own two roundings), `k_dots` (mode 2: the per-block solve
// out[128b : 128b+128, :] = T[b] @ f[128b : 128b+128, :], the TPU's
// Precision.HIGHEST product, float32 accuracy) and `k_dots_default` (mode
// 3: the same product as the TPU's default-precision dot computes it, bf16
// operands rounded to nearest even with float32 accumulation). The Pallas
// grid walks (nz, C) column tiles, L / C of them; here C only has to
// divide L (L % C == 0, C % 64 == 0, as there): blocks walk 64-column
// sub-tiles (below), whatever the tile.
//
// Bound on Hopper: by bytes, every mode (one read and one write a point,
// 0.0401 ms at 256^3). The dots modes run their 256 flops a point on the
// tensor cores: dots_default one bf16 pass (989 TFLOP/s, a tenth of the
// bytes' time), dots three TF32 passes (495 TFLOP/s, two thirds of it). On
// the FMA units (67 TFLOP/s) the same dot would be bound by operations, at
// 0.0641 ms.
//
// Design. Copy and rolls stream: a thread owns four neighbouring columns
// (16-byte loads, neighbouring threads on neighbouring addresses) and walks
// a segment of 32 rows, keeping g[i-1] in registers, with one more row
// read on each side for the cyclic neighbours. A C-column tile runs as
// C / 4 / threads blocks of up to 256 threads; segments give the grid its
// second axis, so that a 256-row field runs 8 blocks deep and the card has
// enough threads in flight.
// Dots and dots_default: a block of eight warps stages T[b] in shared
// memory once, in the operands' form (bf16 pairs; or the two tf32 halves
// hi and lo of each value), then walks 64-column sub-tiles of f[128b :
// 128b+128] a grid's width apart (about one wave of blocks), copied in
// float32 by 16-byte cp.async into two buffers, the next one in flight
// while the tensor cores work on the current one. Each warp computes a 32 x
// 32 tile of the output with mma.sync (m16n8k16 bf16, or m16n8k8 tf32),
// its operands read from shared memory at pitches that put the 32 words of
// an operand load in 32 banks, f rounded as it is read: to bf16, nearest
// even (the products of two bf16 values are exact in float32, so the
// tensor cores add exactly the terms of the TPU's bf16 pass); or split x =
// hi + lo, lo the tf32 rounding of x - hi, and summed as hi*lo + lo*hi +
// hi*hi (3xTF32: the lo*lo term and the roundings leave ~2^-22 of each
// product, where plain TF32 leaves 2^-11). The float32 sums go out as
// float2 stores, each warp's row a 32-byte run. Shared memory: 104 KB a
// block for dots_default (two blocks an SM), 204 KB for dots (one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SEG = 32;            // rows a streaming thread walks
constexpr int M = 128;             // rows of a diagonal block of T
constexpr int SUB = 64;            // columns of f a dots sub-tile stages
constexpr int DOT_THREADS = 256;   // eight warps, 4 x 2 tiles of 32 x 32 outputs

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <bool ROLLS>
__global__ void stream_kernel(const float4* __restrict__ f, float4* __restrict__ out, int nz,
                              long long L4) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int r0 = blockIdx.y * SEG;
  const int r1 = r0 + SEG < nz ? r0 + SEG : nz;
  if (!ROLLS) {
#pragma unroll 8
    for (int i = r0; i < r1; ++i) out[i * L4 + col] = __ldg(f + i * L4 + col);
    return;
  }
  float4 fi = __ldg(f + r0 * L4 + col);
  float4 gprev = sub4(fi, __ldg(f + (r0 == 0 ? nz - 1 : r0 - 1) * L4 + col));
#pragma unroll 8
  for (int i = r0; i < r1; ++i) {
    const float4 fn = __ldg(f + (i + 1 == nz ? 0 : i + 1) * L4 + col);
    const float4 g = sub4(fn, fi);
    out[i * L4 + col] = add4(g, gprev);
    gprev = g;
    fi = fn;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// bf16 pair (lo, hi), rounded to nearest even, lo in the low half: the
// order of two consecutive k in an mma operand register
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// x rounded to tf32 (10 mantissa bits, to nearest, ties away), as the bits
// of a float32
__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a tf32: lo is the rest x - hi (exact in float32)
// rounded to tf32, so hi + lo holds x to ~2^-22 of |x|
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The shared-memory plan of a dots block (MODE below). T[b] once: bf16
// pairs, TW words a row (dots_default), or its tf32 halves hi and lo, TW
// floats a row each (dots); then two buffers of a 128 x SUB sub-tile of f,
// float32, FW floats a row. The pitches put the 32 words a warp reads for
// an mma operand in 32 banks (TW = 4, FW = 4 or 8 modulo 32).
template <bool BF16>
struct DotPlan {
  static constexpr int TW = BF16 ? M / 2 + 4 : M + 4;
  static constexpr int FW = BF16 ? SUB + 4 : SUB + 8;
  static constexpr int T_WORDS = (BF16 ? 1 : 2) * M * TW;
  static constexpr int F_WORDS = M * FW;
  static constexpr size_t BYTES = sizeof(float) * (T_WORDS + 2 * F_WORDS);
  static constexpr int BLOCKS_PER_SM = BF16 ? 2 : 1;
};

template <bool BF16>
__global__ void __launch_bounds__(DOT_THREADS, DotPlan<BF16>::BLOCKS_PER_SM)
dots_kernel(const float* __restrict__ f, const float* __restrict__ T, float* __restrict__ out,
            long long L) {
  using P = DotPlan<BF16>;
  extern __shared__ float4 smem4[];
  unsigned* Ts = reinterpret_cast<unsigned*>(smem4);  // T[b]: bf16 pairs, or hi then lo
  float* Fs = reinterpret_cast<float*>(smem4) + P::T_WORDS;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const long long nsub = L / SUB;
  const float* fb = f + (size_t)b * M * L;
  float* ob = out + (size_t)b * M * L;

  // a sub-tile of f, 128 rows of SUB floats, into buffer `buf`: 16-byte
  // copies, 16 threads a row
  auto load = [&](long long st, int buf) {
    float* dst = Fs + buf * P::F_WORDS;
    const float* src = fb + st * SUB;
#pragma unroll
    for (int e = tid; e < M * SUB / 4; e += DOT_THREADS) {
      const int row = e / (SUB / 4), c4 = e % (SUB / 4);
      cp_async16(dst + row * P::FW + 4 * c4, src + row * L + 4 * c4);
    }
  };
  long long st = blockIdx.x;
  if (st < nsub) load(st, 0);

  const float* Tb = T + (size_t)b * M * M;
  for (int e = tid; e < M * M / 4; e += DOT_THREADS) {
    const int row = e / (M / 4), c4 = e % (M / 4);
    const float4 v = __ldg(reinterpret_cast<const float4*>(Tb) + e);
    if (BF16) {
      *reinterpret_cast<uint2*>(Ts + row * P::TW + 2 * c4) =
          make_uint2(bf16x2(v.x, v.y), bf16x2(v.z, v.w));
    } else {
      uint4 hi, lo;
      split_tf32(v.x, hi.x, lo.x);
      split_tf32(v.y, hi.y, lo.y);
      split_tf32(v.z, hi.z, lo.z);
      split_tf32(v.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(Ts + row * P::TW + 4 * c4) = hi;
      *reinterpret_cast<uint4*>(Ts + M * P::TW + row * P::TW + 4 * c4) = lo;
    }
  }

  // warp w owns the 32 x 32 output tile at rows 32 (w % 4), columns 32 (w / 4)
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 32 * (warp % 4), n0 = 32 * (warp / 4);
  for (int it = 0; st < nsub; ++it, st += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // this sub-tile is in; the other buffer is read
    if (st + gridDim.x < nsub) load(st + gridDim.x, (it + 1) % 2);
    const float* F = Fs + (it % 2) * P::F_WORDS;
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
          acc[mt][nt][3] = 0.f;
    if (BF16) {
#pragma unroll 2
      for (int ks = 0; ks < M / 16; ++ks) {
        unsigned a[2][4], bb[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const unsigned* Ta = Ts + (r0 + 16 * mt + g) * P::TW + 8 * ks + t;
          a[mt][0] = Ta[0];
          a[mt][1] = Ta[8 * P::TW];
          a[mt][2] = Ta[4];
          a[mt][3] = Ta[8 * P::TW + 4];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* Fb = F + (16 * ks + 2 * t) * P::FW + n0 + 8 * nt + g;
          bb[nt][0] = bf16x2(Fb[0], Fb[P::FW]);
          bb[nt][1] = bf16x2(Fb[8 * P::FW], Fb[9 * P::FW]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], bb[nt]);
      }
    } else {
#pragma unroll 2
      for (int ks = 0; ks < M / 8; ++ks) {
        unsigned ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const unsigned* Ta = Ts + (r0 + 16 * mt + g) * P::TW + 8 * ks + t;
          const int at[4] = {0, 8 * P::TW, 4, 8 * P::TW + 4};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ahi[mt][j] = Ta[at[j]];
            alo[mt][j] = Ta[M * P::TW + at[j]];
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* Fb = F + (8 * ks + t) * P::FW + n0 + 8 * nt + g;
          split_tf32(Fb[0], bhi[nt][0], blo[nt][0]);
          split_tf32(Fb[4 * P::FW], bhi[nt][1], blo[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_tf32(acc[mt][nt], ahi[mt], blo[nt]);
            mma_tf32(acc[mt][nt], alo[mt], bhi[nt]);
            mma_tf32(acc[mt][nt], ahi[mt], bhi[nt]);
          }
      }
    }
    float* o = ob + st * SUB + n0 + 2 * t;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const size_t row = r0 + 16 * mt + g;
        *reinterpret_cast<float2*>(o + row * L + 8 * nt) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(o + (row + 8) * L + 8 * nt) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
  }
}

int widest_divisor(int n, const int* choices, int count) {
  for (int i = 0; i < count; ++i)
    if (n % choices[i] == 0) return choices[i];
  return 0;
}

#define DOT_MAX_DEVICES 64
static int dot_sms[DOT_MAX_DEVICES];  // per device: its SM count, 0 until its first launch

template <bool BF16>
cudaError_t launch_dots(const float* f, const float* T, float* out, int nz, long long L,
                        cudaStream_t s) {
  if (nz % M || L % SUB) return cudaErrorInvalidValue;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= DOT_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!dot_sms[dev]) {
    err = cudaDeviceGetAttribute(&dot_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(dots_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DotPlan<BF16>::BYTES);
  if (err != cudaSuccess) return err;
  // about one wave: each block walks its sub-tiles gridDim.x apart
  const int blocks_b = nz / M;
  const long long nsub = L / SUB;
  long long per_b = (dot_sms[dev] * DotPlan<BF16>::BLOCKS_PER_SM + blocks_b - 1) / blocks_b;
  if (per_b > nsub) per_b = nsub;
  const dim3 grid((unsigned)per_b, (unsigned)blocks_b);
  dots_kernel<BF16><<<grid, DOT_THREADS, DotPlan<BF16>::BYTES, s>>>(f, T, out, L);
  return cudaGetLastError();
}

}  // namespace

// One stage on f (nz, L) in C-column tiles: mode 0 copy, 1 rolls, 2 dots,
// 3 dots_default (T: (nz / 128, 128, 128), modes 2 and 3 only). The caller
// checks L % C == 0, C % 64 == 0, the 16-byte alignment of f and out, and
// nz % 128 == 0 for the dots modes.
extern "C" int cfd_diag_dfdz(const float* f, float* out, const float* T, int mode, int nz,
                             long long L, int C, void* stream) {
  if (nz <= 0 || L <= 0 || C <= 0 || L % C || C % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 2) return (int)launch_dots<false>(f, T, out, nz, L, s);
  if (mode == 3) return (int)launch_dots<true>(f, T, out, nz, L, s);
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  static const int widths[] = {256, 128, 64, 32, 16};
  const int threads = widest_divisor(C / 4, widths, 5);
  if (L / 4 / threads > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(L / 4 / threads), (unsigned)((nz + SEG - 1) / SEG));
  const float4* f4 = reinterpret_cast<const float4*>(f);
  float4* o4 = reinterpret_cast<float4*>(out);
  if (mode == 1) {
    stream_kernel<true><<<grid, threads, 0, s>>>(f4, o4, nz, L / 4);
  } else {
    stream_kernel<false><<<grid, threads, 0, s>>>(f4, o4, nz, L / 4);
  }
  return (int)cudaGetLastError();
}
