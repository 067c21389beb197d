// K15 `diag_dfdz`: the stripped stages of the dfdz kernel on the (nz, L)
// layout of a 3-D field (L = ny * nx), one mode per stage.
//
// Replaces: benchmarks/diag_dfdz.py `_pallas2d` with its bodies `k_copy`
// (mode 0: out = f), `k_rolls` (mode 1: the RHS stage alone, cyclic along
// the leading axis, g[i] = f[i+1] - f[i] then out[i] = g[i] + g[i-1], the
// body's own two roundings), `k_dots` (mode 2: the per-block solve
// out[128b : 128b+128, :] = T[b] @ f[128b : 128b+128, :], float32 FMA) and
// `k_dots_default` (mode 3: the same product as the TPU's default-precision
// dot computes it, bf16 operands rounded to nearest even with float32
// accumulation). The Pallas grid walks (nz, C) column tiles, L / C of them;
// here a tile of C columns is a group of blocks (below), and L % C == 0 as
// there.
//
// Bound on Hopper: copy and rolls by bytes (one read and one write a
// point); dots by operations: 2 * 128 flops a point, 256 in all, which at
// the card's float32 rate (67 TFLOP/s, no tensor cores: a derivative
// stage takes no TF32) outlasts moving its 8 bytes a point. dots_default
// by bytes: its bf16 operands would run on the tensor cores (989 TFLOP/s),
// where the 256 flops take a tenth of the time of the 8 bytes. This
// kernel does them on the FMA units, as dots does, and takes about as
// long as dots: a tensor-core form (mma.sync on bf16) is what would close
// that gap.
//
// Design. Copy and rolls stream: a thread owns four neighbouring columns
// (16-byte loads, neighbouring threads on neighbouring addresses) and walks
// a segment of 32 rows, keeping g[i-1] in registers, with one more row
// read on each side for the cyclic neighbours. A C-column tile runs as
// C / 4 / threads blocks of up to 256 threads; segments give the grid its
// second axis, so that a 256-row field runs 8 blocks deep and the card has
// enough threads in flight.
// Dots and dots_default stage T[b] (128 x 128, rows padded to 132 floats)
// in shared memory once per block, then walk the block's columns in
// sub-tiles of 128 x 64 values of f, each staged in shared memory, and
// keep the output in registers: a thread holds an 8-row x 4-column
// outer product (rows rg + 16 j, columns 4 cg .. 4 cg + 3), reading f as
// one 16-byte load per k and T's rows as 16-byte warp broadcasts, 12
// loads from shared memory for every 128 FMAs. The padding puts the two
// rows a warp reads at once in different banks. dots_default rounds T and
// f to bf16 as it stages them: the products of two bf16 values are exact
// in float32, so the same FMA chain then accumulates exactly what the
// TPU's bf16 pass adds up, in float32. 100 KB of shared memory a block,
// two blocks an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SEG = 32;            // rows a streaming thread walks
constexpr int M = 128;             // rows of a diagonal block of T
constexpr int T_LD = M + 4;        // padded row of T in shared memory
constexpr int SUB = 64;            // columns of f a dots sub-tile stages
constexpr int DOT_THREADS = 256;   // 16 column groups x 16 row groups
constexpr int ROWS = M / 16;       // output rows a dots thread holds
constexpr size_t DOT_SMEM = sizeof(float) * (M * T_LD + M * SUB);

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

template <bool BF16>
__device__ __forceinline__ float4 staged(float4 v) {
  if (BF16) {
    v.x = __bfloat162float(__float2bfloat16_rn(v.x));
    v.y = __bfloat162float(__float2bfloat16_rn(v.y));
    v.z = __bfloat162float(__float2bfloat16_rn(v.z));
    v.w = __bfloat162float(__float2bfloat16_rn(v.w));
  }
  return v;
}

template <bool BF16>
__global__ void __launch_bounds__(DOT_THREADS, 2)
dots_kernel(const float* __restrict__ f, const float* __restrict__ T, float* __restrict__ out,
            long long L, int cols) {
  extern __shared__ float4 smem4[];
  float* Ts = reinterpret_cast<float*>(smem4);
  float* Fs = Ts + M * T_LD;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const long long col0 = (long long)blockIdx.x * cols;
  const float* Tb = T + (size_t)b * M * M;
  for (int e = tid; e < M * M / 4; e += DOT_THREADS) {
    const int row = e / (M / 4), c4 = e % (M / 4);
    *reinterpret_cast<float4*>(Ts + row * T_LD + 4 * c4) =
        staged<BF16>(__ldg(reinterpret_cast<const float4*>(Tb) + e));
  }
  const int cg = tid % 16, rg = tid / 16;
  const float* fb = f + (size_t)b * M * L + col0;
  float* ob = out + (size_t)b * M * L + col0;
  for (int s = 0; s < cols; s += SUB) {
    __syncthreads();  // T staged; the previous sub-tile read
    for (int e = tid; e < M * SUB / 4; e += DOT_THREADS) {
      const int row = e / (SUB / 4), c4 = e % (SUB / 4);
      *reinterpret_cast<float4*>(Fs + row * SUB + 4 * c4) =
          staged<BF16>(__ldg(reinterpret_cast<const float4*>(fb + row * L + s) + c4));
    }
    __syncthreads();
    float acc[ROWS][4];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < M; k += 4) {
      float4 fv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        fv[kk] = *reinterpret_cast<const float4*>(Fs + (k + kk) * SUB + 4 * cg);
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const float4 t = *reinterpret_cast<const float4*>(Ts + (rg + 16 * j) * T_LD + k);
        const float tk[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[j][0] = fmaf(tk[kk], fv[kk].x, acc[j][0]);
          acc[j][1] = fmaf(tk[kk], fv[kk].y, acc[j][1]);
          acc[j][2] = fmaf(tk[kk], fv[kk].z, acc[j][2]);
          acc[j][3] = fmaf(tk[kk], fv[kk].w, acc[j][3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      *reinterpret_cast<float4*>(ob + (size_t)(rg + 16 * j) * L + s + 4 * cg) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
}

int widest_divisor(int n, const int* choices, int count) {
  for (int i = 0; i < count; ++i)
    if (n % choices[i] == 0) return choices[i];
  return 0;
}

template <bool BF16>
cudaError_t launch_dots(const float* f, const float* T, float* out, int nz, long long L, int C,
                        cudaStream_t s) {
  static const int sub_tiles[] = {512, 256, 128, 64};
  const int cols = widest_divisor(C, sub_tiles, 4);
  if (!cols || nz % M) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(dots_kernel<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DOT_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(L / cols), (unsigned)(nz / M));
  dots_kernel<BF16><<<grid, DOT_THREADS, DOT_SMEM, s>>>(f, T, out, L, cols);
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
  if (mode == 2) return (int)launch_dots<false>(f, T, out, nz, L, C, s);
  if (mode == 3) return (int)launch_dots<true>(f, T, out, nz, L, C, s);
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
