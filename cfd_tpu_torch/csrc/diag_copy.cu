// K14 `diag_copy`: a pure copy over tiles of a float32 array, the copy
// floor of one access pattern.
//
// Replaces: benchmarks/diag_lane.py `copy2d` (a (B, n) array copied over
// (rows, cols) tiles) and `copy3d` (a (nz, ny, nx) array over (bz, by, nx)
// slabs). The output is bitwise the input. What those cases measure is the
// access pattern of a tile: `rows` contiguous runs of `cols` floats strided
// by `n` (2-D), `bz` runs of `by * nx` floats strided by `ny * nx` (3-D).
// Both are one form here: a tile of R runs of `run` floats, `stride` floats
// apart, and a grid of tiles.
//
// Bound on Hopper: bytes. One read and one write of each float is all a
// copy moves; it does no arithmetic.
//
// Design: the tile is a block's share of work, not a shared-memory stage
// (a tile of (256, 8192) floats is 8 MB): each float goes from device
// memory to a register and back. Each tile keeps its run length and stride.
// Its runs, flattened, are cut into `parts` equal ranges, one block each,
// where the grid would otherwise have fewer than two blocks an SM (a (256,
// 65536) array in 8 tiles of 8192 columns runs 264 blocks, not 8). Each
// thread moves 16 bytes at a time where runs, stride and tile offsets are
// multiples of 4 floats and the pointers 16-byte aligned, else 4 bytes;
// neighbouring threads move neighbouring addresses, and each thread issues
// four loads before its four stores, so that a warp keeps 2 KB in flight.

#include <cuda_runtime.h>

namespace {

constexpr int COPY_THREADS = 256;
constexpr int COPY_UNROLL = 4;

template <typename V>
__global__ void tile_copy_kernel(const V* __restrict__ x, V* __restrict__ y, int tiles_j,
                                 long long tile_stride_i, long long tile_stride_j,
                                 unsigned run, long long stride, unsigned per_tile,
                                 int parts) {
  // run, stride, tile strides and per_tile in units of V; a tile's flat
  // index fits 32 bits (the host checks), so its division is a 32-bit one
  const long long tile = blockIdx.x / parts;
  const unsigned part = blockIdx.x - (unsigned)tile * parts;
  const long long ti = tile / tiles_j, tj = tile - ti * tiles_j;
  const V* xt = x + ti * tile_stride_i + tj * tile_stride_j;
  V* yt = y + ti * tile_stride_i + tj * tile_stride_j;
  const unsigned share = (per_tile + parts - 1) / parts;
  const unsigned lo = part * share;
  const unsigned hi = lo >= per_tile ? lo : (per_tile - lo < share ? per_tile : lo + share);
  for (unsigned k0 = lo + threadIdx.x; k0 < hi; k0 += COPY_THREADS * COPY_UNROLL) {
    V v[COPY_UNROLL];
    long long at[COPY_UNROLL];
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      const unsigned k = k0 + u * COPY_THREADS;
      const unsigned r = k / run;
      at[u] = k < hi ? r * stride + (k - r * run) : -1;
      if (at[u] >= 0) v[u] = __ldg(xt + at[u]);
    }
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u)
      if (at[u] >= 0) yt[at[u]] = v[u];
  }
}

int sm_count(int* sms) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

}  // namespace

// Copy `tiles_i * tiles_j` tiles: tile (i, j) starts at i * tile_stride_i +
// j * tile_stride_j and holds `runs` runs of `run` floats, `stride` apart
// (all in floats). The caller checks that the tiles cover the array.
extern "C" int cfd_diag_copy(const float* x, float* y, long long tiles_i, long long tiles_j,
                             long long tile_stride_i, long long tile_stride_j, long long runs,
                             long long run, long long stride, void* stream) {
  const long long tiles = tiles_i * tiles_j;
  if (tiles <= 0 || runs <= 0 || run <= 0) return 0;
  if (tiles_j > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int sms;
  int err = sm_count(&sms);
  if (err) return err;
  // at least two blocks an SM, and no block with less than a thread's worth
  const long long per_tile = runs * run;
  if (per_tile >= 0x7fffffffLL - 2LL * COPY_THREADS * COPY_UNROLL) return (int)cudaErrorInvalidValue;
  long long parts = (2LL * sms + tiles - 1) / tiles;
  if (parts > per_tile / COPY_THREADS) parts = per_tile / COPY_THREADS;
  if (parts < 1) parts = 1;
  const long long blocks = tiles * parts;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool wide = run % 4 == 0 && stride % 4 == 0 && tile_stride_i % 4 == 0 &&
                    tile_stride_j % 4 == 0 && (reinterpret_cast<size_t>(x) % 16) == 0 &&
                    (reinterpret_cast<size_t>(y) % 16) == 0;
  if (wide) {
    tile_copy_kernel<float4><<<(unsigned)blocks, COPY_THREADS, 0, s>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), (int)tiles_j,
        tile_stride_i / 4, tile_stride_j / 4, (unsigned)(run / 4), stride / 4,
        (unsigned)(per_tile / 4), (int)parts);
  } else {
    tile_copy_kernel<float><<<(unsigned)blocks, COPY_THREADS, 0, s>>>(
        x, y, (int)tiles_j, tile_stride_i, tile_stride_j, (unsigned)run, stride,
        (unsigned)per_tile, (int)parts);
  }
  return (int)cudaGetLastError();
}
