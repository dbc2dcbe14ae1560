// Weighted segment sum of per-client rows, f32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/segment_sum.py:
// _segment_sum_kernel, launched by segment_sum_pallas. On (K, D) rows,
// (K,) int32 ids and (K,) f32 weights:
//   out[e, c] = sum over k with ids[k] == e, in ascending k, of w[k] * rows[k, c]
// for e in [0, E). Ids outside [0, E) (the padding id E) contribute
// nothing, and an empty segment is written as zeros. A null weight pointer
// means w = 1. Each sum is taken as acc = acc + (w * x) from acc = 0, with
// __fmul_rn / __fadd_rn so that no fused multiply-add changes the rounding:
// the kernel equals its plain PyTorch version bit for bit, and every run
// gives the same result (no atomics).
//
// Design. The TPU kernel turns the fold into a one-hot (E x bk) matrix
// product on the MXU, with the output tile resident across the row axis.
// On the GPU the fold is bound by memory, not arithmetic, so the kernel
// instead avoids reading anything twice: the grid is (column tiles, E),
// a block owns one segment e and a tile of 1024 columns, and it walks the
// ids in chunks of 256. For each chunk the block compacts the members of
// segment e into shared memory in ascending order (a warp ballot and a
// prefix over the 8 warps), then loads only those rows. The loop over
// members is uniform across the block, so there is no divergence, and
// each row is read by exactly one segment's blocks: the traffic is K * D
// reads plus E * D writes whatever E is. Four member rows are loaded
// before they are added, to keep loads in flight. A thread holds four
// columns: one float4 where D % 4 == 0 and both pointers are 16-byte
// aligned, four strided scalars otherwise (a ragged or odd D). Offsets
// are 64-bit (K * D reaches 4e8); grid rows past 65535 segments loop.
//
// Bound on an H100 SXM at 3.35 TB/s, 4 * (K * D + E * D) bytes plus the
// ids and weights: 0.4416 ms for the (64, 5,136,704) -> 8 deltas fold of
// the full-width ResNet-14, 0.0905 ms for the (64, 1,052,672) -> 8
// statistics fold, 0.5321 ms for the (64, 6,189,379) -> 8 buffered
// dispatch fold.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 4;                  // columns a thread holds
constexpr int TILE = THREADS * COLS;     // columns a block holds
constexpr int UNROLL = 4;                // member rows loaded before adding
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ void fold(float (&acc)[COLS], float w,
                                     const float (&x)[COLS]) {
#pragma unroll
  for (int j = 0; j < COLS; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(w, x[j]));
}

// The four columns of row `row` this thread holds; columns past D read 0
// and are never stored.
template <bool VEC>
__device__ __forceinline__ void load_cols(const float* __restrict__ rows,
                                          int64_t row, int64_t d,
                                          int64_t col0, float (&x)[COLS]) {
  const float* r = rows + row * d;
  if (VEC) {
    // col0 = 4 * (tile float4 index): the whole float4 is in range or not
    if (col0 < d) {
      const float4 v = *reinterpret_cast<const float4*>(r + col0);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
      x[0] = x[1] = x[2] = x[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int64_t c = col0 + (int64_t)j * THREADS;
      x[j] = c < d ? r[c] : 0.f;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const float* __restrict__ rows, const int* __restrict__ ids,
                   const float* __restrict__ w, float* __restrict__ out,
                   int64_t k, int64_t d, int e_count) {
  __shared__ int s_row[THREADS];
  __shared__ float s_w[THREADS];
  __shared__ int s_warp[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t tile0 = (int64_t)blockIdx.x * TILE;
  // VEC: thread t holds columns tile0 + 4t .. 4t+3; scalar: tile0 + t + 256j
  const int64_t col0 = VEC ? tile0 + (int64_t)COLS * tid : tile0 + tid;

  for (int seg = blockIdx.y; seg < e_count; seg += gridDim.y) {
    float acc[COLS] = {0.f, 0.f, 0.f, 0.f};
    for (int64_t base = 0; base < k; base += THREADS) {
      // compact this chunk's members of `seg`, keeping ascending k
      const int64_t kk = base + tid;
      const bool hit = kk < k && ids[kk] == seg;
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_warp[warp] = __popc(ballot);
      __syncthreads();
      int off = 0, total = 0;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) {
        const int c = s_warp[i];
        off += i < warp ? c : 0;
        total += c;
      }
      if (hit) {
        const int pos = off + __popc(ballot & ((1u << lane) - 1u));
        s_row[pos] = (int)kk;
        s_w[pos] = w == nullptr ? 1.f : w[kk];
      }
      __syncthreads();

      int m = 0;
      for (; m + UNROLL <= total; m += UNROLL) {
        float x[UNROLL][COLS];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          load_cols<VEC>(rows, s_row[m + u], d, col0, x[u]);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) fold(acc, s_w[m + u], x[u]);
      }
      for (; m < total; ++m) {
        float x[COLS];
        load_cols<VEC>(rows, s_row[m], d, col0, x);
        fold(acc, s_w[m], x);
      }
      __syncthreads();   // s_warp, s_row and s_w are rewritten next chunk
    }

    float* o = out + (int64_t)seg * d;
    if (VEC) {
      if (col0 < d)
        *reinterpret_cast<float4*>(o + col0) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int64_t c = col0 + (int64_t)j * THREADS;
        if (c < d) o[c] = acc[j];
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// C interface, loaded with ctypes. rows: device pointer to contiguous
// (k, d) f32; ids: (k,) int32; w: (k,) f32 or null (unit weights); out:
// (e, d) f32, every element written. Requires 0 < k < 2^31, d > 0, e > 0.
// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// does not synchronise.
extern "C" int segment_sum_f32(const float* rows, const int* ids,
                               const float* w, float* out, int64_t k,
                               int64_t d, int e, void* stream) {
  if (k <= 0 || k > INT32_MAX || d <= 0 || e <= 0)
    return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && aligned16(rows) && aligned16(out);
  const int64_t gx = (d + TILE - 1) / TILE;
  if (gx > INT32_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)(e < MAX_GRID_Y ? e : MAX_GRID_Y));
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    segment_sum_kernel<true><<<grid, THREADS, 0, st>>>(rows, ids, w, out, k,
                                                        d, e);
  } else {
    segment_sum_kernel<false><<<grid, THREADS, 0, st>>>(rows, ids, w, out, k,
                                                         d, e);
  }
  return (int)cudaGetLastError();
}
