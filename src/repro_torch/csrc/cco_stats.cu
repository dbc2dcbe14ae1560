// Fused encoding statistics, "cross" moment set, f32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cco_stats.py::_stats_kernel
// (launched by cco_stats_pallas with moments="cross"). From zf, zg (N, d),
// row-major, it computes in ONE pass over N:
//   mean_f = sum_n zf * inv_n,  sq_f = sum_n zf^2 * inv_n    (d,)
//   mean_g = sum_n zg * inv_n,  sq_g = sum_n zg^2 * inv_n    (d,)
//   cross  = zf^T zg * inv_n                                 (d, d)
// with inv_n = 1 / max(*num_valid, 1) when num_valid is given (pre-masked
// rows; read on the device, so the caller never syncs), else 1 / N.
//
// Design. Each block owns one TILE x TILE tile of `cross` and loops over N,
// staging BN-row chunks of the zf and zg column slices it needs in shared
// memory; 256 threads each hold a 4 x 4 register tile and accumulate with
// f32 FFMA (no tensor cores, no TF32), so it agrees with the plain f32
// version to f32 rounding. Ragged N and d are masked on load and store; the
// host pads nothing. Blocks of the first tile column (blockIdx.x == 0) also
// emit the f vector statistics of their rows, blocks of the first tile row
// (blockIdx.y == 0) the g ones, as the TPU kernel does with j == 0 / i == 0.
// Every output element has exactly one writer and no atomics are used, so
// the result is the same from run to run.
//
// Bound on an H100 SXM at the main-path shape N = 128, d = 1024:
// 2*N*d^2 = 268 MFLOP at the 67 TFLOP/s FP32 non-tensor rate is 4.0 us;
// ~1 MB read and ~4.2 MB written at 3.35 TB/s is 1.6 us. So it is bound by
// operations on paper, but at 256 blocks of 4 N-chunks each it is in
// practice launch- and latency-bound. Making it fast (wgmma/TMA, split-N
// for small d) is later work.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE = 64;     // output tile edge
constexpr int BN = 32;       // rows of N staged per step
constexpr int THREADS = 256; // 16 x 16 threads
constexpr int MICRO = 4;     // 4 x 4 outputs per thread
constexpr int TDIM = 16;

__global__ void __launch_bounds__(THREADS)
cco_stats_cross_kernel(const float* __restrict__ zf,
                       const float* __restrict__ zg,
                       const float* __restrict__ num_valid,
                       float* __restrict__ cross,
                       float* __restrict__ mean_f, float* __restrict__ sq_f,
                       float* __restrict__ mean_g, float* __restrict__ sq_g,
                       int n, int d) {
  __shared__ float sf[BN][TILE];
  __shared__ float sg[BN][TILE];

  const int tid = threadIdx.x;
  const int tx = tid % TDIM;
  const int ty = tid / TDIM;
  const int i0 = blockIdx.y * TILE;  // zf columns = rows of cross
  const int j0 = blockIdx.x * TILE;  // zg columns = columns of cross
  const bool f_stats = blockIdx.x == 0;
  const bool g_stats = blockIdx.y == 0;

  float acc[MICRO][MICRO];
#pragma unroll
  for (int r = 0; r < MICRO; ++r)
#pragma unroll
    for (int c = 0; c < MICRO; ++c) acc[r][c] = 0.f;
  // threads [0, TILE) sum f column i0 + tid; [TILE, 2 TILE) g column j0 + tid - TILE
  float vsum = 0.f, vsq = 0.f;

  for (int n0 = 0; n0 < n; n0 += BN) {
    for (int e = tid; e < BN * TILE; e += THREADS) {
      const int r = e / TILE;
      const int c = e % TILE;
      const int row = n0 + r;
      const size_t base = (size_t)row * (size_t)d;
      sf[r][c] = (row < n && i0 + c < d) ? zf[base + i0 + c] : 0.f;
      sg[r][c] = (row < n && j0 + c < d) ? zg[base + j0 + c] : 0.f;
    }
    __syncthreads();

    if (f_stats && tid < TILE) {
      for (int k = 0; k < BN; ++k) {
        const float v = sf[k][tid];
        vsum += v;
        vsq = fmaf(v, v, vsq);
      }
    } else if (g_stats && tid >= TILE && tid < 2 * TILE) {
      for (int k = 0; k < BN; ++k) {
        const float v = sg[k][tid - TILE];
        vsum += v;
        vsq = fmaf(v, v, vsq);
      }
    }

#pragma unroll 8
    for (int k = 0; k < BN; ++k) {
      float a[MICRO], b[MICRO];
#pragma unroll
      for (int r = 0; r < MICRO; ++r) a[r] = sf[k][ty + TDIM * r];
#pragma unroll
      for (int c = 0; c < MICRO; ++c) b[c] = sg[k][tx + TDIM * c];
#pragma unroll
      for (int r = 0; r < MICRO; ++r)
#pragma unroll
        for (int c = 0; c < MICRO; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

  const float inv_n =
      num_valid != nullptr ? 1.f / fmaxf(*num_valid, 1.f) : 1.f / (float)n;

#pragma unroll
  for (int r = 0; r < MICRO; ++r) {
    const int i = i0 + ty + TDIM * r;
    if (i >= d) continue;
#pragma unroll
    for (int c = 0; c < MICRO; ++c) {
      const int j = j0 + tx + TDIM * c;
      if (j < d) cross[(size_t)i * (size_t)d + j] = acc[r][c] * inv_n;
    }
  }
  if (f_stats && tid < TILE && i0 + tid < d) {
    mean_f[i0 + tid] = vsum * inv_n;
    sq_f[i0 + tid] = vsq * inv_n;
  } else if (g_stats && tid >= TILE && tid < 2 * TILE && j0 + tid - TILE < d) {
    mean_g[j0 + tid - TILE] = vsum * inv_n;
    sq_g[j0 + tid - TILE] = vsq * inv_n;
  }
}

}  // namespace

// C interface, loaded with ctypes. All pointers are device pointers to
// contiguous f32 arrays; num_valid may be null. Launches on `stream` and
// returns cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int cco_stats_cross_f32(const float* zf, const float* zg,
                                   const float* num_valid, float* cross,
                                   float* mean_f, float* sq_f, float* mean_g,
                                   float* sq_g, int n, int d, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (d + TILE - 1) / TILE;
  const dim3 grid(tiles, tiles);
  cco_stats_cross_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      zf, zg, num_valid, cross, mean_f, sq_f, mean_g, sq_g, n, d);
  return (int)cudaGetLastError();
}
