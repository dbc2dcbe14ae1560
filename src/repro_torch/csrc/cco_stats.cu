// Fused encoding statistics, f32, for Hopper (sm_90a), in two moment sets.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cco_stats.py:
// _stats_kernel (cco_stats_pallas with moments="cross") and
// _stats_kernel_full (moments="full"). From zf, zg (N, d), row-major, it
// computes in ONE pass over N:
//   mean_f = sum_n zf * inv_n,  sq_f = sum_n zf^2 * inv_n    (d,)
//   mean_g = sum_n zg * inv_n,  sq_g = sum_n zg^2 * inv_n    (d,)
//   cross  = zf^T zg * inv_n                                 (d, d)
// and, in the "full" set, the within-view second moments
//   cov_f  = zf^T zf * inv_n,   cov_g = zg^T zg * inv_n      (d, d)
// with inv_n = 1 / max(*num_valid, 1) when num_valid is given (pre-masked
// rows; read on the device, so the caller never syncs), else 1 / N.
//
// Design. Each block owns one TILE x TILE tile (i, j) of the (d, d) outputs
// and loops over N, staging BN-row chunks of the zf and zg column slices it
// needs in shared memory; 256 threads each hold a 4 x 4 register tile per
// output and accumulate with f32 FFMA (no tensor cores, no TF32), so it
// agrees with the plain f32 version to f32 rounding. Ragged N and d are
// masked on load and store; the host pads nothing. Blocks of the first
// tile column (blockIdx.x == 0) also emit the f vector statistics of their
// rows, blocks of the first tile row (blockIdx.y == 0) the g ones, as the
// TPU kernel does with j == 0 / i == 0.
//
// The "full" set: cov_f and cov_g are symmetric, so only blocks with j >= i
// accumulate them (48 accumulators a thread instead of 16). Those blocks
// also stage the zf slice at j and the zg slice at i (the TPU kernel's
// zfj / zgi operands); the cov_f product reuses the cross product's zf
// operand and the cov_g product its zg operand. A block with j > i writes
// its cov tiles at (i, j) and, transposed through shared memory so the
// stores stay coalesced, at (j, i); a block with j < i writes no cov tile.
// Diagonal tiles sum a*b and b*a in the same order, so they are symmetric
// too. Every output element has exactly one writer and no atomics are used:
// cov_f and cov_g come out exactly symmetric, and the result is the same
// from run to run. The host mirrors nothing (the TPU version mirrors the
// upper block triangle on the host afterwards).
//
// Bound on an H100 SXM at the main-path shape N = 128, d = 1024: the cross
// set needs 2*N*d^2 = 268 MFLOP, 4.0 us at the 67 TFLOP/s FP32 non-tensor
// rate (~1 MB read and ~4.2 MB written at 3.35 TB/s is 1.6 us); the full
// set adds the upper triangles of the two symmetric products, about
// 2*N*d^2 more, 8.0 us (12.6 MB written, 3.8 us). So both are bound by
// operations on paper, and at 256 blocks of 4 N-chunks each they are in
// practice latency-bound. Making them fast (wgmma/TMA, split-N for small d)
// is later work.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE = 64;     // output tile edge
constexpr int BN = 32;       // rows of N staged per step
constexpr int THREADS = 256; // 16 x 16 threads
constexpr int MICRO = 4;     // 4 x 4 outputs per thread
constexpr int TDIM = 16;

// Writes a thread's 4 x 4 share of the cov tile (i, j) and, when `mirror`
// (j > i), the whole tile transposed at (j, i), staged through `tile`
// (TILE x (TILE + 1) floats of shared memory, padded so that the transposed
// reads hit distinct banks) so the global stores stay coalesced. Called by
// every thread of the block (it synchronises); `tile` may alias the staging
// buffers, which are no longer read.
__device__ __forceinline__ void store_cov_tile(const float (&acc)[MICRO][MICRO],
                                               float* __restrict__ cov,
                                               float* tile, int i0, int j0,
                                               int d, float inv_n,
                                               bool mirror) {
  const int tid = threadIdx.x;
  const int tx = tid % TDIM;
  const int ty = tid / TDIM;
#pragma unroll
  for (int r = 0; r < MICRO; ++r) {
    const int i = i0 + ty + TDIM * r;
#pragma unroll
    for (int c = 0; c < MICRO; ++c) {
      const int j = j0 + tx + TDIM * c;
      const float v = acc[r][c] * inv_n;
      if (i < d && j < d) cov[(size_t)i * (size_t)d + j] = v;
      if (mirror) tile[(ty + TDIM * r) * (TILE + 1) + tx + TDIM * c] = v;
    }
  }
  if (!mirror) return;
  __syncthreads();
  for (int e = tid; e < TILE * TILE; e += THREADS) {
    const int jr = e / TILE;  // row of the (j, i) tile
    const int ic = e % TILE;  // its column
    const int j = j0 + jr;
    const int i = i0 + ic;
    if (i < d && j < d) cov[(size_t)j * (size_t)d + i] = tile[ic * (TILE + 1) + jr];
  }
  __syncthreads();
}

// FULL = false: the "cross" set; FULL = true: the "full" set (cov_f and
// cov_g may be null only when FULL is false).
template <bool FULL>
__global__ void __launch_bounds__(THREADS)
cco_stats_kernel(const float* __restrict__ zf, const float* __restrict__ zg,
                 const float* __restrict__ num_valid,
                 float* __restrict__ cross,
                 float* __restrict__ mean_f, float* __restrict__ sq_f,
                 float* __restrict__ mean_g, float* __restrict__ sq_g,
                 float* __restrict__ cov_f, float* __restrict__ cov_g,
                 int n, int d) {
  // [0]: zf slice at i, [1]: zg slice at j; in the full set also
  // [2]: zf slice at j, [3]: zg slice at i
  __shared__ float smem[FULL ? 4 : 2][BN][TILE];
  float(*sf)[TILE] = smem[0];
  float(*sg)[TILE] = smem[1];

  const int tid = threadIdx.x;
  const int tx = tid % TDIM;
  const int ty = tid / TDIM;
  const int i0 = blockIdx.y * TILE;  // zf columns = rows of cross
  const int j0 = blockIdx.x * TILE;  // zg columns = columns of cross
  const bool f_stats = blockIdx.x == 0;
  const bool g_stats = blockIdx.y == 0;
  // block-uniform: this block accumulates the within-view moments
  const bool upper = FULL && blockIdx.x >= blockIdx.y;

  float acc[MICRO][MICRO];
  float acc_f[MICRO][MICRO];  // cov_f tile (i, j), full set only
  float acc_g[MICRO][MICRO];  // cov_g tile (i, j), full set only
#pragma unroll
  for (int r = 0; r < MICRO; ++r)
#pragma unroll
    for (int c = 0; c < MICRO; ++c) {
      acc[r][c] = 0.f;
      acc_f[r][c] = 0.f;
      acc_g[r][c] = 0.f;
    }
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
      if constexpr (FULL) {
        if (upper) {
          smem[2][r][c] = (row < n && j0 + c < d) ? zf[base + j0 + c] : 0.f;
          smem[3][r][c] = (row < n && i0 + c < d) ? zg[base + i0 + c] : 0.f;
        }
      }
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
      if constexpr (FULL) {
        if (upper) {
          float bf[MICRO], ag[MICRO];
#pragma unroll
          for (int c = 0; c < MICRO; ++c) bf[c] = smem[2][k][tx + TDIM * c];
#pragma unroll
          for (int r = 0; r < MICRO; ++r) ag[r] = smem[3][k][ty + TDIM * r];
#pragma unroll
          for (int r = 0; r < MICRO; ++r)
#pragma unroll
            for (int c = 0; c < MICRO; ++c) {
              acc_f[r][c] = fmaf(a[r], bf[c], acc_f[r][c]);
              acc_g[r][c] = fmaf(ag[r], b[c], acc_g[r][c]);
            }
        }
      }
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
  if constexpr (FULL) {
    if (upper) {
      store_cov_tile(acc_f, cov_f, &smem[0][0][0], i0, j0, d, inv_n,
                     blockIdx.x != blockIdx.y);
      store_cov_tile(acc_g, cov_g, &smem[0][0][0], i0, j0, d, inv_n,
                     blockIdx.x != blockIdx.y);
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
// contiguous f32 arrays; num_valid may be null. Each launches on `stream`
// and returns cudaGetLastError() (0 on success); neither synchronises.
extern "C" int cco_stats_cross_f32(const float* zf, const float* zg,
                                   const float* num_valid, float* cross,
                                   float* mean_f, float* sq_f, float* mean_g,
                                   float* sq_g, int n, int d, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (d + TILE - 1) / TILE;
  const dim3 grid(tiles, tiles);
  cco_stats_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      zf, zg, num_valid, cross, mean_f, sq_f, mean_g, sq_g, nullptr, nullptr,
      n, d);
  return (int)cudaGetLastError();
}

extern "C" int cco_stats_full_f32(const float* zf, const float* zg,
                                  const float* num_valid, float* cross,
                                  float* mean_f, float* sq_f, float* mean_g,
                                  float* sq_g, float* cov_f, float* cov_g,
                                  int n, int d, void* stream) {
  if (n <= 0 || d <= 0 || cov_f == nullptr || cov_g == nullptr)
    return (int)cudaErrorInvalidValue;
  const int tiles = (d + TILE - 1) / TILE;
  const dim3 grid(tiles, tiles);
  cco_stats_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      zf, zg, num_valid, cross, mean_f, sq_f, mean_g, sq_g, cov_f, cov_g, n,
      d);
  return (int)cudaGetLastError();
}
