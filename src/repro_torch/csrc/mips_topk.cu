// Maximum inner product search with a fused top-k, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/mips_topk.py:
// _mips_kernel and its shard-local form _mips_kernel_offset, launched by
// mips_topk_pallas. On queries q (Q, d) f32 and a corpus (N, d) f32 or
// bf16 (upcast to f32 as it is loaded), it returns for each query the k
// rows of largest score q . c, as (Q, k) f32 scores and (Q, k) int32
// indices, ordered by score descending and, on equal scores, by ascending
// index. The rows are rows [offset, offset + N) of a corpus of n_total
// rows: a row at local position p is valid when p < N and offset + p <
// n_total, and its emitted index is offset + p. A query with fewer than k
// valid rows is padded with (NEG_INF, BIG_IDX). The (Q, N) score matrix is
// never written to device memory.
//
// Scores. Each score is one thread's f32 sum over d in ascending order,
// acc = fmaf(q[j], c[j], acc) from acc = 0: no tensor cores, no split of
// d. A score therefore depends on its two vectors alone, not on the grid,
// the split or the shard its row lies in. That is what makes a sharded
// search equal the unsharded one bit for bit, and every run equal the
// last (there are no atomics, and no result depends on block order).
//
// Design. The TPU kernel walks the corpus in order on one core, carrying
// the running top-k in scratch from one grid step to the next. On the GPU
// a serving batch of 16-64 queries is one query tile, so the grid instead
// splits N: pass 1 runs a block per (split of N, tile of BQ queries),
// with as many splits as fill the card twice over. A block walks its
// split in tiles of 256 rows. For each 32-wide chunk of d it stages the
// rows (transposed, coalesced loads, 16 bytes a thread where alignment
// allows) and the query tile in shared memory; thread t owns row t of the
// tile and keeps BQ sums in registers. The tile's scores then go to
// shared memory, and warp w merges queries w, w + 8, ... into their
// running top-k lists (shared memory, sorted): a ballot finds the rows
// that beat the list's k-th score, and each is inserted in ascending row
// order. Rows come in ascending index order, so a row that only ties the
// k-th score loses to it, which is the lowest-index rule. Each block
// writes its lists to (S, Q, k) partial results. Pass 2 runs a warp per
// query and merges the S sorted lists by the same (score, index) key,
// k rounds of a warp-wide pick among the lists' heads.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 without tensor cores):
// the corpus read once, N * d * 4 bytes (2 for bf16), against 2 Q N d
// operations: bytes below Q of about 20 (f32), operations above. Q = 16,
// N = 2^20, d = 1024, f32: 1.28 ms (bytes); Q = 64: 2.05 ms (operations).
// This first kernel reaches neither: its inner loop is bound by shared
// memory reads (BQ / 4 + 1 loads for BQ fused multiply-adds), and each
// query tile reads the corpus again. wgmma with a 3xTF32 split, TMA
// streaming and a score threshold shared across splits are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BN = THREADS;          // rows a tile, one a thread
constexpr int DT = 32;               // columns of d staged at a time
constexpr int CS = BN + 1;           // padded stride of the staged rows
constexpr int MAX_K = 256;
constexpr int KCH = MAX_K / 32;      // list entries a lane holds at most
constexpr float NEG_INF = -1e30f;
constexpr int BIG_IDX = 1 << 30;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Stage columns [c0, c0 + DT) of tile rows [row0, row0 + BN) into
// s_c[col * CS + r], zeros past the valid rows or past d. VEC: 16-byte
// loads (d and the base pointer are aligned for them).
template <typename T, bool VEC>
__device__ __forceinline__ void stage_rows(const T* __restrict__ corpus,
                                           int64_t row0, int64_t rows_end,
                                           int64_t d, int64_t c0,
                                           float* __restrict__ s_c) {
  const int tid = threadIdx.x;
  if (VEC) {
    constexpr int PER = 16 / sizeof(T);          // elements a 16-byte load
    constexpr int LPR = DT / PER;                // loads a row
    constexpr int RPI = THREADS / LPR;           // rows an iteration
#pragma unroll
    for (int it = 0; it < BN / RPI; ++it) {
      const int r = it * RPI + tid / LPR;
      const int cl = (tid % LPR) * PER;
      const int64_t row = row0 + r;
      const int64_t col = c0 + cl;
      alignas(16) T v[PER];
      if (row < rows_end && col < d) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(corpus + row * d + col);
        *reinterpret_cast<uint4*>(v) = raw;
      } else {
#pragma unroll
        for (int e = 0; e < PER; ++e) v[e] = T(0.f);
      }
#pragma unroll
      for (int e = 0; e < PER; ++e) s_c[(cl + e) * CS + r] = to_f32(v[e]);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < DT * BN / THREADS; ++it) {
      const int idx = it * THREADS + tid;
      const int r = idx / DT, cl = idx % DT;
      const int64_t row = row0 + r;
      const int64_t col = c0 + cl;
      s_c[cl * CS + r] =
          (row < rows_end && col < d) ? to_f32(corpus[row * d + col]) : 0.f;
    }
  }
}

// Insert (cv, ci) into the sorted list (lv, li) of length k, after every
// entry with a score >= cv: the caller guarantees ci is larger than every
// index in the list, so equal scores keep ascending index order. One
// warp, all lanes.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int k,
                                            float cv, int ci) {
  const int lane = threadIdx.x & 31;
  int p = 0;
  float tv[KCH];
  int ti[KCH];
#pragma unroll
  for (int c = 0; c < KCH; ++c) {
    const int j = c * 32 + lane;
    tv[c] = NEG_INF;
    ti[c] = BIG_IDX;
    if (c * 32 < k) {
      if (j < k) {
        tv[c] = lv[j];
        ti[c] = li[j];
      }
      p += __popc(__ballot_sync(0xffffffffu, j < k && tv[c] >= cv));
    }
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < KCH; ++c) {
    const int j = c * 32 + lane;
    if (c * 32 < k && j >= p && j + 1 < k) {
      lv[j + 1] = tv[c];
      li[j + 1] = ti[c];
    }
  }
  if (lane == 0) {
    lv[p] = cv;
    li[p] = ci;
  }
  __syncwarp();
}

template <typename T, int BQ, bool VEC>
__global__ void __launch_bounds__(THREADS)
mips_partial_kernel(const float* __restrict__ q, const T* __restrict__ corpus,
                    float* __restrict__ part_v, int* __restrict__ part_i,
                    int qn, int64_t n, int64_t d, int k, int64_t offset,
                    int64_t n_total, int64_t rows_per_split) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int QS = BQ + 4;                        // padded query stride
  float* s_q = smem;                                // [DT][QS]
  float* s_c = s_q + DT * QS;                       // [DT][CS], then scores
  float* s_s = s_c;                                 // [BQ][BN], reuses s_c
  constexpr int TILE_FLOATS = (DT * CS > BQ * BN) ? DT * CS : BQ * BN;
  float* lv = s_c + TILE_FLOATS;                    // [BQ][k]
  int* li = reinterpret_cast<int*>(lv + BQ * k);    // [BQ][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int64_t begin = (int64_t)split * rows_per_split;
  int64_t end = begin + rows_per_split;
  if (end > n) end = n;
  // rows past n_total are invalid too: local position < n_total - offset
  int64_t valid_end = n_total - offset;
  if (valid_end > end) valid_end = end;

  for (int j = tid; j < BQ * k; j += THREADS) {
    lv[j] = NEG_INF;
    li[j] = BIG_IDX;
  }

  for (int64_t row0 = begin; row0 < end; row0 += BN) {
    float acc[BQ];
#pragma unroll
    for (int m = 0; m < BQ; ++m) acc[m] = 0.f;
    for (int64_t c0 = 0; c0 < d; c0 += DT) {
      __syncthreads();   // the previous chunk (or tile's lists) is done
      for (int idx = tid; idx < BQ * DT; idx += THREADS) {
        const int qq = idx / DT, cl = idx % DT;
        const int64_t col = c0 + cl;
        s_q[cl * QS + qq] = (q0 + qq < qn && col < d)
                                ? q[(int64_t)(q0 + qq) * d + col] : 0.f;
      }
      stage_rows<T, VEC>(corpus, row0, end, d, c0, s_c);
      __syncthreads();
#pragma unroll 4
      for (int cl = 0; cl < DT; ++cl) {
        const float c = s_c[cl * CS + tid];
        const float4* qv = reinterpret_cast<const float4*>(s_q + cl * QS);
#pragma unroll
        for (int m = 0; m < BQ / 4; ++m) {
          const float4 w = qv[m];
          acc[4 * m + 0] = fmaf(w.x, c, acc[4 * m + 0]);
          acc[4 * m + 1] = fmaf(w.y, c, acc[4 * m + 1]);
          acc[4 * m + 2] = fmaf(w.z, c, acc[4 * m + 2]);
          acc[4 * m + 3] = fmaf(w.w, c, acc[4 * m + 3]);
        }
      }
    }
    __syncthreads();     // s_c is read by all; it becomes the score tile
#pragma unroll
    for (int m = 0; m < BQ; ++m) s_s[m * BN + tid] = acc[m];
    __syncthreads();

    // warp w merges queries w, w + WARPS, ... of the tile
    for (int qq = warp; qq < BQ; qq += WARPS) {
      if (q0 + qq >= qn) break;
      float* qv = lv + qq * k;
      int* qi = li + qq * k;
      for (int base = 0; base < BN; base += 32) {
        const int64_t row = row0 + base + lane;
        const float v = s_s[qq * BN + base + lane];
        unsigned hits =
            __ballot_sync(0xffffffffu, row < valid_end && v > qv[k - 1]);
        while (hits) {
          const int src = __ffs(hits) - 1;
          hits &= hits - 1;
          const float cv = __shfl_sync(0xffffffffu, v, src);
          if (cv > qv[k - 1])   // the list may have moved on
            warp_insert(qv, qi, k, cv, (int)(offset + row0 + base + src));
        }
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < BQ * k; j += THREADS) {
    const int qq = j / k, r = j % k;
    if (q0 + qq < qn) {
      const int64_t o = ((int64_t)split * qn + q0 + qq) * k + r;
      part_v[o] = lv[j];
      part_i[o] = li[j];
    }
  }
}

__device__ __forceinline__ bool beats(float v, int i, int s, float bv, int bi,
                                      int bs) {
  if (v != bv) return v > bv;
  if (i != bi) return i < bi;
  return s < bs;
}

// Pass 2: a warp per query merges the S sorted lists of pass 1 by
// (score descending, index ascending), k rounds of a pick among heads.
__global__ void __launch_bounds__(THREADS)
mips_merge_kernel(const float* __restrict__ part_v,
                  const int* __restrict__ part_i, float* __restrict__ out_v,
                  int* __restrict__ out_i, int qn, int k, int splits) {
  extern __shared__ int heads[];                    // [WARPS][splits]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int query = blockIdx.x * WARPS + warp;
  if (query >= qn) return;                          // whole warps leave
  int* h = heads + warp * splits;
  for (int s = lane; s < splits; s += 32) h[s] = 0;
  __syncwarp();
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = INT32_MAX, bs = INT32_MAX;
    for (int s = lane; s < splits; s += 32) {
      const int hs = h[s];
      if (hs < k) {
        const int64_t o = ((int64_t)s * qn + query) * k + hs;
        const float v = part_v[o];
        const int i = part_i[o];
        if (beats(v, i, s, bv, bi, bs)) { bv = v; bi = i; bs = s; }
      }
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, w);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, w);
      const int os = __shfl_xor_sync(0xffffffffu, bs, w);
      if (beats(ov, oi, os, bv, bi, bs)) { bv = ov; bi = oi; bs = os; }
    }
    if (lane == 0) {
      const bool found = bs != INT32_MAX;
      out_v[(int64_t)query * k + r] = found ? bv : NEG_INF;
      out_i[(int64_t)query * k + r] = found ? bi : BIG_IDX;
    }
    if (bs != INT32_MAX && (bs & 31) == lane) h[bs] += 1;
    __syncwarp();
  }
}

size_t partial_smem(int bq, int k) {
  const int tile = DT * CS > bq * BN ? DT * CS : bq * BN;
  return sizeof(float) * ((size_t)DT * (bq + 4) + tile) +
         (sizeof(float) + sizeof(int)) * (size_t)bq * k;
}

template <typename T, int BQ, bool VEC>
int launch_partial(const float* q, const T* corpus, float* pv, int* pi, int qn,
                   int64_t n, int64_t d, int k, int64_t offset,
                   int64_t n_total, int splits, int64_t rps,
                   cudaStream_t st) {
  const size_t smem = partial_smem(BQ, k);
  auto kern = mips_partial_kernel<T, BQ, VEC>;
  static size_t allowed = 48 * 1024;   // dynamic shared memory opted into
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const dim3 grid((unsigned)splits, (unsigned)((qn + BQ - 1) / BQ));
  kern<<<grid, THREADS, smem, st>>>(q, corpus, pv, pi, qn, n, d, k, offset,
                                    n_total, rps);
  return (int)cudaGetLastError();
}

template <typename T, int BQ>
int dispatch_vec(const float* q, const void* corpus, float* pv, int* pi,
                 int qn, int64_t n, int64_t d, int k, int64_t offset,
                 int64_t n_total, int splits, int64_t rps, cudaStream_t st) {
  const T* c = reinterpret_cast<const T*>(corpus);
  const bool vec = (d * (int64_t)sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(corpus) & 15) == 0;
  if (vec)
    return launch_partial<T, BQ, true>(q, c, pv, pi, qn, n, d, k, offset,
                                       n_total, splits, rps, st);
  return launch_partial<T, BQ, false>(q, c, pv, pi, qn, n, d, k, offset,
                                      n_total, splits, rps, st);
}

int search(const float* q, const void* corpus, int bf16, float* part_v,
           int* part_i, float* out_v, int* out_i, int qn, int64_t n,
           int64_t d, int k, int64_t offset, int64_t n_total, int splits,
           int64_t rps, int bq, void* stream) {
  // rps: rows a split, whole tiles; the splits cover [0, n) exactly
  if (qn <= 0 || n <= 0 || d <= 0 || k < 1 || k > MAX_K || k > n ||
      splits < 1 || splits > 1024 || rps < BN || rps % BN != 0 ||
      (n + rps - 1) / rps != splits || offset < 0 || n_total > BIG_IDX ||
      (bq != 16 && bq != 32) || (qn + bq - 1) / bq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (bf16) {
    err = bq == 16 ? dispatch_vec<__nv_bfloat16, 16>(
                         q, corpus, part_v, part_i, qn, n, d, k, offset,
                         n_total, splits, rps, st)
                   : dispatch_vec<__nv_bfloat16, 32>(
                         q, corpus, part_v, part_i, qn, n, d, k, offset,
                         n_total, splits, rps, st);
  } else {
    err = bq == 16 ? dispatch_vec<float, 16>(q, corpus, part_v, part_i, qn, n,
                                             d, k, offset, n_total, splits,
                                             rps, st)
                   : dispatch_vec<float, 32>(q, corpus, part_v, part_i, qn, n,
                                             d, k, offset, n_total, splits,
                                             rps, st);
  }
  if (err != 0) return err;
  const size_t smem = sizeof(int) * (size_t)WARPS * splits;
  mips_merge_kernel<<<(qn + WARPS - 1) / WARPS, THREADS, smem, st>>>(
      part_v, part_i, out_v, out_i, qn, k, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. q: device pointer to contiguous (qn, d)
// f32; corpus: contiguous (n, d), f32 or (bf16 != 0) bf16; part_v/part_i:
// (splits, qn, k) scratch; out_v/out_i: (qn, k). Split s holds local rows
// [s * rps, (s + 1) * rps): rps is a multiple of 256 and splits equals
// ceil(n / rps), at most 1024. bq is 16 or 32, 1 <= k <= 256,
// k <= n, n_total <= 2^30. Launches pass 1 and pass 2 on `stream` and
// returns the first CUDA error (0 on success); it does not synchronise.
//
// mips_topk_search: the whole corpus, indices 0..n-1 (valid rows: those
// below min(n, n_total)); the counterpart of _mips_kernel.
extern "C" int mips_topk_search(const float* q, const void* corpus, int bf16,
                                float* part_v, int* part_i, float* out_v,
                                int* out_i, int qn, int64_t n, int64_t d,
                                int k, int64_t n_total, int splits,
                                int64_t rps, int bq, void* stream) {
  return search(q, corpus, bf16, part_v, part_i, out_v, out_i, qn, n, d, k, 0,
                n_total < n ? n_total : n, splits, rps, bq, stream);
}

// mips_topk_offset: the corpus is rows [offset, offset + n) of an
// n_total-row corpus; indices are global; the counterpart of
// _mips_kernel_offset.
extern "C" int mips_topk_offset(const float* q, const void* corpus, int bf16,
                                float* part_v, int* part_i, float* out_v,
                                int* out_i, int qn, int64_t n, int64_t d,
                                int k, int64_t offset, int64_t n_total,
                                int splits, int64_t rps, int bq,
                                void* stream) {
  return search(q, corpus, bf16, part_v, part_i, out_v, out_i, qn, n, d, k,
                offset, n_total, splits, rps, bq, stream);
}
