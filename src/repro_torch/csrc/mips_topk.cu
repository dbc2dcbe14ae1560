// Maximum inner product search with a fused top-k, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/mips_topk.py:
// _mips_kernel and its shard-local form _mips_kernel_offset, launched by
// mips_topk_pallas. On queries q (Q, d) f32 and a corpus (N, d) f32 or
// bf16, it returns for each query the k rows of largest score q . c, as
// (Q, k) f32 scores and (Q, k) int32 indices, ordered by score descending
// and, on equal scores, by ascending index. The rows are rows [offset,
// offset + N) of a corpus of n_total rows: a row at local position p is
// valid when p < N and offset + p < n_total, and its emitted index is
// offset + p. A query with fewer than k valid rows is padded with
// (NEG_INF, BIG_IDX). The (Q, N) score matrix is never written to device
// memory.
//
// Scores, on the tensor cores at f32 accuracy. Write h(x) for x rounded
// to TF32 and b(x) for x rounded to bf16. A score is q . c = h(q) . h(c)
// + (q - h(q)) . c + h(q) . (c - h(c)) up to the products of the two
// remainders (below 2^-22 of a product). The first term runs on
// mma.sync.m16n8k8 tf32 (products of TF32 values are exact in f32); the
// two remainder terms, 2^-11 of the first, need only bf16 operands and run
// together as b(q - h(q)) . b(c) + b(q) . b(c - h(c)) on one
// mma.sync.m16n8k16 bf16, which does twice the work of a TF32 m16n8k8 at
// twice the rate (989 against 495 TFLOP/s on the data sheet), so in the
// same time. An f32 corpus costs two MMA issues per 8 columns of d where
// 3xTF32 costs three.
// A bf16 corpus is exact in both types: h(q) . c + b(q - h(q)) . c. The
// scores are within ~5e-7 of exact on unit vectors (see
// tests/test_torch_kernel_numerics.py). An MMA rounds its sum toward
// zero, so a long chain of MMAs into one accumulator drifts (a row scored
// against itself, every product positive, lost ~1e-5 over 384 MMAs): each
// chunk of 32 columns is summed in a fresh fragment and then added to the
// score in f32 with round-to-nearest, which keeps the drift to one chunk.
// A score takes its chunks in ascending order, and each chunk's MMAs in
// one fixed order; d is never split across warps or blocks. So a score
// depends on its two vectors alone, not on the tile, the split, the shard
// or the fragment slot its row or query lies in. That is what makes a
// sharded search equal the unsharded one bit for bit, duplicated rows tie
// on equal bits, and every run equal the last (there are no atomics, and
// no result depends on block order).
//
// Bound on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32 on the tensor cores,
// the fastest rate at which any route multiplies f32 inputs): the corpus
// read once, N d 4 bytes (2 for bf16), against 2 Q N d operations. At the
// serving shape (Q 64, N 2^20, d 1024, f32) the bytes bound it: 1.28 ms
// (0.28 ms of operations).
//
// What held the first design back: every score was one thread's fmaf sum
// on the CUDA cores (67 TFLOP/s at most) with shared-memory reads bounding
// its inner loop (BQ / 4 + 1 loads for BQ FMAs); a serving batch of 64
// was two query tiles, so the 4 GiB corpus was read twice; and each
// 32-column chunk ran two __syncthreads around an unpipelined staging
// pass, so loads never overlapped the math. Now:
// - Pass 0 splits the queries into their parts once (h(q) as f32; b(q)
//   and b(q - h(q)) side by side, 16 bytes a group of 4 columns), rows
//   padded to a multiple of 4 columns, so the warps that share them do not
//   each split them again and their chunks always go by 16-byte copies.
// - Pass 1 runs a block per (split of N, tile of BQ <= 64 queries): a
//   serving batch of 64 reads the corpus once. 8 warps score a tile of
//   BN = 256 rows x BQ queries; warp w owns rows 32w .. 32w + 31 (it
//   alone splits them) and every query of the tile, BQ / 16 x 4 MMA tiles
//   of accumulators in registers. The queries' parts are re-read from L2
//   once a row tile.
// - The block walks its split as one stream of (row tile, 32-column
//   chunk) stages through a 3-stage cp.async ring (16-byte copies, rows
//   and columns past the end zero-filled), so chunk i + 2 loads while
//   chunk i computes, across row tiles too. Each row of a chunk is one
//   128-byte line of the corpus (64 for bf16). Chunks are staged at 144
//   bytes a row (64 for a bf16 corpus), at which each thread's 16-byte
//   fragment loads are free of bank conflicts.
// - Fragments use a fixed permutation of d within a chunk: a thread holds
//   columns 8 t .. 8 t + 7 of its rows (t = lane % 4), so one 16-byte load
//   gives it 4 of them. TF32 k-step s takes columns 8 t + 2 s and
//   8 t + 2 s + 1; a bf16 k16 MMA takes the same pair for both remainder
//   products (f32 corpus) or 8 t + 4 p .. + 3 (bf16 corpus); the same for
//   queries and rows.
// - After a row tile's last chunk each warp takes its best score for each
//   query; the scores go to the tile's ring slot (free until the next
//   issue), and warp w merges queries w, w + 8, ... into their running
//   top-k lists (shared memory, sorted), skipping a query whose best
//   score in the tile cannot enter its list: a ballot finds the rows of
//   each 32 that beat the list's k-th score, and one warp-wide merge puts
//   them all in place, as inserting them one by one in ascending row
//   order would. Rows come in ascending index order, so a row that only
//   ties the k-th score loses to it, which is the lowest-index rule. Each
//   block writes its lists to (S, Q, k) partial results. A block fills an
//   SM's shared memory (200 KB at BQ = 64: the ring, the lists of BQ k 8
//   bytes (so BQ = 64 takes k <= 64, a larger k BQ = 32), the best
//   scores), and the plan runs one wave of as few, long splits as keep
//   every SM busy (a split's lists take in ~k ln(rows / k) rows), with
//   32-query tiles where 64-query tiles would leave SMs idle.
// - Pass 2 runs a warp per query and merges the S sorted lists by the same
//   (score, index) key, k rounds of a warp-wide pick among the lists'
//   heads.
// wgmma is not used: it reads B from shared memory in its own layouts, so
// the corpus's parts would each have to be staged there after the split.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BN = 256;              // rows a tile, 32 a warp
constexpr int DK = 32;               // columns of d a stage holds
constexpr int FLD = DK + 4;          // row stride of a staged f32 chunk
constexpr int STAGES = 3;            // the cp.async ring
constexpr int SLD = BN + 8;          // row stride of the score tile
constexpr int MAX_K = 256;
constexpr int FULL_TILE_K = 64;      // largest k a 64-query tile takes
constexpr int KCH = MAX_K / 32;      // list entries a lane holds at most
constexpr float NEG_INF = -1e30f;
constexpr int BIG_IDX = 1 << 30;
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on an H100

typedef __nv_bfloat16 bf16;

// row stride, in elements, of a staged corpus chunk: 144 bytes for f32,
// 64 for bf16, at which the fragment loads are free of bank conflicts
template <typename T>
__host__ __device__ constexpr int corpus_ld() {
  return sizeof(T) == 4 ? FLD : DK;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src-size
// 0: nothing is read, but src must still be a mapped address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (to nearest, ties away), as the bits of an f32
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) rounded to bf16, x0 in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16 x 8, row) . b (8 x 8, col), tf32 in, f32 accumulate; FIRST:
// from a zero accumulator instead
template <bool FIRST>
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if (FIRST)
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f));
  else
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Pass 0: the queries' parts, rows padded with zeros to dp (a multiple
// of 4) columns: h(q) as f32 at hi[r * dp + c]; and per group of 4
// columns 16 bytes, the 4 b(q) then the 4 b(q - h(q)), at
// bx[(r * dp + c) * 2].
__global__ void __launch_bounds__(THREADS)
split_queries_kernel(const float* __restrict__ q, float* __restrict__ hi,
                     bf16* __restrict__ bx, int qn, int64_t d, int64_t dp) {
  const int64_t n = (int64_t)qn * dp;
  for (int64_t i = blockIdx.x * (int64_t)THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * THREADS) {
    const int64_t r = i / dp, c = i % dp;
    const float x = c < d ? q[r * d + c] : 0.f;
    const float h = __uint_as_float(to_tf32(x));
    hi[i] = h;
    bf16* grp = bx + (i - (c & 3)) * 2;
    grp[c & 3] = __float2bfloat16_rn(x);
    grp[4 + (c & 3)] = __float2bfloat16_rn(x - h);
  }
}

// Stage columns [c0, c0 + DK) of rows [row0, row0 + NROWS) of a (.., d)
// matrix into dst at a row stride of LD elements, zeros past row `end` or
// column d. VEC (d and the base pointer allow it): 16-byte cp.async, each
// thread a fixed 16-byte column unit of every (THREADS / units)-th row;
// otherwise plain loads and stores, visible after the next __syncthreads.
template <typename T, int NROWS, int LD, bool VEC>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           int64_t row0, int64_t end,
                                           int64_t d, int64_t c0, T* dst) {
  if (VEC) {
    constexpr int PER = 16 / sizeof(T);        // elements a copy
    constexpr int UNITS = DK / PER;            // copies a row
    constexpr int RSTEP = THREADS / UNITS;     // rows between a thread's
    const int r0 = threadIdx.x / UNITS, cl = (threadIdx.x % UNITS) * PER;
    const int64_t col = c0 + cl;
    const T* g = src + (row0 + r0) * d + col;
    const uint32_t s = smem_u32(dst + r0 * LD + cl);
#pragma unroll
    for (int m = 0; m < (NROWS + RSTEP - 1) / RSTEP; ++m) {
      if (NROWS % RSTEP != 0 && r0 + m * RSTEP >= NROWS) break;
      const bool ok = row0 + r0 + m * RSTEP < end && col < d;
      cp_async16(s + m * RSTEP * LD * (int)sizeof(T),
                 ok ? g + (int64_t)m * RSTEP * d : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < NROWS * DK; i += THREADS) {
      const int r = i / DK, cl = i % DK;
      const int64_t row = row0 + r, col = c0 + cl;
      dst[r * LD + cl] = (row < end && col < d) ? src[row * d + col] : T(0.f);
    }
  }
}

// The warp's B fragments of a chunk: rows 32 w + 8 j + g, columns
// 8 tig + 4 p .. + 3 for p = 0, 1 (TF32 k-step 2 p + hs takes elements
// 2 hs and 2 hs + 1 of the four; a bf16 k16 MMA takes a pair's two
// remainder products, or all four columns of a bf16 corpus). f32 corpus:
// h(c), and b(c) and b(c - h(c)) in pairs, loaded for one p at a time.
// bf16 corpus: exact in both types, all 8 columns at p = 0.
template <typename T>
struct CorpusFrag;

// The query side of one m-tile and p: h(q) of rows g, g + 8 (4 columns
// each), and their bf16 parts (words 0, 1: b(q) of columns 0-1, 2-3;
// words 2, 3: b(q - h(q)) of the same).
struct QueryFrag {
  uint4 h0, h1, x0, x1;
};

template <>
struct CorpusFrag<float> {
  uint32_t hi[4][4], b[4][2], bl[4][2];
  __device__ __forceinline__ void load(const float* cs, int p, int warp,
                                       int g, int tig) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 c = *reinterpret_cast<const float4*>(
          cs + (warp * 32 + j * 8 + g) * FLD + 8 * tig + 4 * p);
      hi[j][0] = to_tf32(c.x);
      hi[j][1] = to_tf32(c.y);
      hi[j][2] = to_tf32(c.z);
      hi[j][3] = to_tf32(c.w);
      b[j][0] = pack_bf16(c.x, c.y);
      b[j][1] = pack_bf16(c.z, c.w);
      bl[j][0] = pack_bf16(c.x - __uint_as_float(hi[j][0]),
                           c.y - __uint_as_float(hi[j][1]));
      bl[j][1] = pack_bf16(c.z - __uint_as_float(hi[j][2]),
                           c.w - __uint_as_float(hi[j][3]));
    }
  }
  // part += the 4 columns of p for one (m-tile, n-tile): per pair hs of
  // them, h(q) h(c) on TF32, then b(q - h(q)) b(c) + b(q) b(c - h(c)) on
  // one bf16 k16 MMA
  template <bool FIRST>
  __device__ __forceinline__ void step(float (&part)[4], int j, int p,
                                       const QueryFrag& a) const {
#pragma unroll
    for (int hs = 0; hs < 2; ++hs) {
      const uint32_t at[4] = {hs ? a.h0.z : a.h0.x, hs ? a.h1.z : a.h1.x,
                              hs ? a.h0.w : a.h0.y, hs ? a.h1.w : a.h1.y};
      const uint32_t ax[4] = {hs ? a.x0.w : a.x0.z, hs ? a.x1.w : a.x1.z,
                              hs ? a.x0.y : a.x0.x, hs ? a.x1.y : a.x1.x};
      if (FIRST && hs == 0)
        mma_tf32<true>(part, at, hi[j][2 * hs], hi[j][2 * hs + 1]);
      else
        mma_tf32<false>(part, at, hi[j][2 * hs], hi[j][2 * hs + 1]);
      mma_bf16(part, ax, b[j][hs], bl[j][hs]);
    }
  }
};

template <>
struct CorpusFrag<bf16> {
  uint32_t t[4][8], w[4][4];
  __device__ __forceinline__ void load(const bf16* cs, int p, int warp,
                                       int g, int tig) {
    if (p != 0) return;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          cs + (warp * 32 + j * 8 + g) * DK + 8 * tig);
      w[j][0] = raw.x;
      w[j][1] = raw.y;
      w[j][2] = raw.z;
      w[j][3] = raw.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) {            // bf16 -> f32 bits, exact
        t[j][2 * e] = w[j][e] << 16;
        t[j][2 * e + 1] = w[j][e] & 0xffff0000u;
      }
    }
  }
  // part += the 4 columns of p: h(q) c on TF32 (two k-steps), then
  // b(q - h(q)) c on one bf16 k16 MMA
  template <bool FIRST>
  __device__ __forceinline__ void step(float (&part)[4], int j, int p,
                                       const QueryFrag& a) const {
    const int e = 4 * p;
    const uint32_t a0[4] = {a.h0.x, a.h1.x, a.h0.y, a.h1.y};
    const uint32_t a1[4] = {a.h0.z, a.h1.z, a.h0.w, a.h1.w};
    const uint32_t ax[4] = {a.x0.z, a.x1.z, a.x0.w, a.x1.w};
    mma_tf32<FIRST>(part, a0, t[j][e], t[j][e + 1]);
    mma_tf32<false>(part, a1, t[j][e + 2], t[j][e + 3]);
    mma_bf16(part, ax, w[j][2 * p], w[j][2 * p + 1]);
  }
};

// acc[mi][j] += the chunk's scores of queries 16 mi .. 16 mi + 15 and the
// warp's rows 32 w + 8 j .. 32 w + 8 j + 7: summed from zero in the fixed
// order of the header, then added in f32. qh: the chunk's h(q) at a row
// stride of FLD floats; qx: the queries' bf16 parts, 16 bytes a group of
// 4 columns, at the same stride in bytes.
template <typename T, int BQ>
__device__ __forceinline__ void mma_chunk(const T* __restrict__ cs,
                                          const float* __restrict__ qh,
                                          const bf16* __restrict__ qx,
                                          float (&acc)[BQ / 16][4][4],
                                          int warp, int g, int tig) {
  float part[BQ / 16][4][4];
  CorpusFrag<T> c;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    c.load(cs, p, warp, g, tig);
#pragma unroll
    for (int mi = 0; mi < BQ / 16; ++mi) {
      const int r0 = (mi * 16 + g) * FLD + 8 * tig + 4 * p, r1 = r0 + 8 * FLD;
      QueryFrag a;
      a.h0 = *reinterpret_cast<const uint4*>(qh + r0);
      a.h1 = *reinterpret_cast<const uint4*>(qh + r1);
      a.x0 = *reinterpret_cast<const uint4*>(qx + 2 * r0);
      a.x1 = *reinterpret_cast<const uint4*>(qx + 2 * r1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (p == 0)
          c.template step<true>(part[mi][j], j, p, a);
        else
          c.template step<false>(part[mi][j], j, p, a);
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < BQ / 16; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] += part[mi][j][e];
}

// Merge one ballot round's rows into the sorted list (lv, li) of length
// k: lane l holds row (v, idx) and takes part where bit l of `hits` is
// set; the rows' indices ascend with the lane and exceed every index in
// the list. The list becomes the best k of the list and the rows by
// (score descending, index ascending), which is what inserting the rows
// one by one in lane order gives, each after every entry with a score >=
// its own: a row's new place is the entries with a score >= v plus the
// rows ahead of it in the round (higher score, or equal and a lower
// lane); an entry's, its place plus the rows with a higher score. CH:
// list entries a lane holds, 32 CH >= k. One warp, all lanes.
template <int CH>
__device__ __forceinline__ void warp_merge(float* lv, int* li, int k, float v,
                                           int idx, unsigned hits) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = k;                            // entries with score >= v
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lv[mid] >= v) lo = mid + 1;
    else hi = mid;
  }
  float tv[CH];
  int ti[CH], to[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int j = c * 32 + lane;
    tv[c] = NEG_INF;
    ti[c] = BIG_IDX;
    to[c] = k;
    if (j < k) {
      tv[c] = lv[j];
      ti[c] = li[j];
      to[c] = j;
    }
  }
  int ahead = 0;                                 // rows ahead of this one
  for (unsigned m = hits; m; m &= m - 1) {
    const int j = __ffs(m) - 1;
    const float vj = __shfl_sync(0xffffffffu, v, j);
    ahead += vj > v || (vj == v && j < lane);
#pragma unroll
    for (int c = 0; c < CH; ++c) to[c] += vj > tv[c];
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < CH; ++c)
    if (to[c] < k) {
      lv[to[c]] = tv[c];
      li[to[c]] = ti[c];
    }
  if ((hits >> lane & 1) && lo + ahead < k) {
    lv[lo + ahead] = v;
    li[lo + ahead] = idx;
  }
  __syncwarp();
}

// bytes of one ring slot: a corpus chunk and the queries' chunk of both
// parts, each at a row stride of FLD floats (144 bytes)
template <typename T, int BQ>
__host__ __device__ constexpr int slot_bytes() {
  return BN * corpus_ld<T>() * (int)sizeof(T) + 2 * BQ * FLD * 4;
}

// queries a score tile holds: 32, or 16 where 32 do not fit in a slot
template <typename T, int BQ>
__host__ __device__ constexpr int score_queries() {
  return BQ >= 32 && 32 * SLD * 4 <= slot_bytes<T, BQ>() ? 32 : 16;
}

template <typename T, int BQ>
size_t partial_smem(int k) {
  return STAGES * (size_t)slot_bytes<T, BQ>() +
         sizeof(float) * (size_t)BQ * WARPS +
         (sizeof(float) + sizeof(int)) * (size_t)BQ * k;
}

// qparts: the queries' parts from pass 0, hi (qn, dp) f32 then bx
template <typename T, int BQ, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
mips_partial_kernel(const float* __restrict__ qparts, int64_t dp,
                    const T* __restrict__ corpus, float* __restrict__ part_v,
                    int* __restrict__ part_i, int qn, int64_t n, int64_t d,
                    int k, int64_t offset, int64_t n_total,
                    int64_t rows_per_split) {
  constexpr int CLD = corpus_ld<T>();
  constexpr int SLOT = slot_bytes<T, BQ>();
  constexpr int QH = score_queries<T, BQ>();
  static_assert(QH * SLD * 4 <= SLOT, "a score tile fits in a ring slot");
  // STAGES slots of [corpus chunk (BN, CLD)][q hi (BQ, FLD)][q bx]; after
  // a row tile's last chunk, its slot holds the (QH, SLD) score tile
  extern __shared__ uint4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  float* wmax = reinterpret_cast<float*>(ring + STAGES * SLOT); // [BQ][WARPS]
  float* lv = wmax + BQ * WARPS;                                // [BQ][k]
  int* li = reinterpret_cast<int*>(lv + BQ * k);                // [BQ][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
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

  const int nchunks = (int)((d + DK - 1) / DK);
  const int64_t total = ((end - begin + BN - 1) / BN) * nchunks;
  const float* q_hi = qparts + (int64_t)q0 * dp;
  const float* q_bx = qparts + (int64_t)qn * dp + (int64_t)q0 * dp;
  const int64_t q_end = qn - q0;

  // the next (row tile, chunk) stage to load, and its ring slot
  int64_t ld_row0 = begin;
  int ld_chunk = 0, ld_slot = 0;
  auto issue = [&]() {
    const int64_t c0 = (int64_t)ld_chunk * DK;
    char* sl = ring + ld_slot * SLOT;
    float* sq = reinterpret_cast<float*>(sl + BN * CLD * sizeof(T));
    stage_rows<T, BN, CLD, VEC>(corpus, ld_row0, end, d, c0,
                                reinterpret_cast<T*>(sl));
    stage_rows<float, BQ, FLD, true>(q_hi, 0, q_end, dp, c0, sq);
    stage_rows<float, BQ, FLD, true>(q_bx, 0, q_end, dp, c0, sq + BQ * FLD);
    if (++ld_chunk == nchunks) {
      ld_chunk = 0;
      ld_row0 += BN;
    }
    ld_slot = ld_slot + 1 == STAGES ? 0 : ld_slot + 1;
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) issue();
    cp_async_commit();
  }

  float acc[BQ / 16][4][4];
#pragma unroll
  for (int mi = 0; mi < BQ / 16; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  int64_t row0 = begin;
  int chunk = 0, slot = 0;
  for (int64_t it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();   // stage `it` has landed
    __syncthreads();               // and every warp is done with it - 1
    if (it + STAGES - 1 < total) issue();
    cp_async_commit();
    char* sl = ring + slot * SLOT;
    const float* sq = reinterpret_cast<const float*>(sl + BN * CLD * sizeof(T));
    mma_chunk<T, BQ>(reinterpret_cast<const T*>(sl), sq,
                     reinterpret_cast<const bf16*>(sq + BQ * FLD), acc, warp,
                     g, tig);
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    if (++chunk < nchunks) continue;

    // the row tile is scored. Each warp's best score for each query goes
    // to wmax. The tile's slot is free until the next iteration's issue:
    // the scores go there, QH queries at a time, and warp w merges queries
    // w, w + WARPS, ... of each into their running top-k lists, skipping
    // a query whose best score in the tile cannot enter its list.
    float* s_s = reinterpret_cast<float*>(sl);               // [QH][SLD]
#pragma unroll
    for (int mi = 0; mi < BQ / 16; ++mi) {
      float m0 = NEG_INF, m1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        m0 = fmaxf(m0, fmaxf(acc[mi][j][0], acc[mi][j][1]));
        m1 = fmaxf(m1, fmaxf(acc[mi][j][2], acc[mi][j][3]));
      }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, w));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, w));
      }
      if (tig == 0) {
        wmax[(mi * 16 + g) * WARPS + warp] = m0;
        wmax[(mi * 16 + g + 8) * WARPS + warp] = m1;
      }
    }
#pragma unroll
    for (int h = 0; h < (BQ + QH - 1) / QH; ++h) {
      __syncthreads();             // the slot (or the last scores) is read
#pragma unroll
      for (int mi = h * (QH / 16); mi < BQ / 16 && mi < (h + 1) * (QH / 16);
           ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* at = s_s + ((mi % (QH / 16)) * 16 + g) * SLD + warp * 32 +
                      j * 8 + 2 * tig;
          *reinterpret_cast<float2*>(at) =
              make_float2(acc[mi][j][0], acc[mi][j][1]);
          *reinterpret_cast<float2*>(at + 8 * SLD) =
              make_float2(acc[mi][j][2], acc[mi][j][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
        }
      __syncthreads();
      for (int qs = warp; qs < QH && h * QH + qs < BQ; qs += WARPS) {
        const int qq = h * QH + qs;
        if (q0 + qq >= qn) break;
        float* qv = lv + qq * k;
        int* qi = li + qq * k;
        float best = wmax[qq * WARPS + (lane & (WARPS - 1))];
#pragma unroll
        for (int w = 1; w < WARPS; w <<= 1)
          best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, w));
        if (!(best > qv[k - 1])) continue;
        for (int base = 0; base < BN; base += 32) {
          const int64_t row = row0 + base + lane;
          const float v = s_s[qs * SLD + base + lane];
          const unsigned hits =
              __ballot_sync(0xffffffffu, row < valid_end && v > qv[k - 1]);
          if (!hits) continue;
          if (k <= 32)   // the lists of every path: one entry a lane
            warp_merge<1>(qv, qi, k, v, (int)(offset + row), hits);
          else
            warp_merge<KCH>(qv, qi, k, v, (int)(offset + row), hits);
        }
      }
    }
    chunk = 0;
    row0 += BN;
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

template <typename T, int BQ, bool VEC>
int launch_partial(const float* qparts, int64_t dp, const T* corpus,
                   float* pv, int* pi, int qn, int64_t n, int64_t d, int k,
                   int64_t offset, int64_t n_total, int splits, int64_t rps,
                   cudaStream_t st) {
  const size_t smem = partial_smem<T, BQ>(k);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = mips_partial_kernel<T, BQ, VEC>;
  static size_t allowed = 48 * 1024;   // dynamic shared memory opted into
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const dim3 grid((unsigned)splits, (unsigned)((qn + BQ - 1) / BQ));
  kern<<<grid, THREADS, smem, st>>>(qparts, dp, corpus, pv, pi, qn, n, d, k,
                                    offset, n_total, rps);
  return (int)cudaGetLastError();
}

// the corpus's chunks go by 16-byte copies where its rows are 16-byte
// aligned; the queries' parts always are (pass 0 pads them)
template <typename T, int BQ>
int dispatch_vec(const float* qparts, int64_t dp, const void* corpus,
                 float* pv, int* pi, int qn, int64_t n, int64_t d, int k,
                 int64_t offset, int64_t n_total, int splits, int64_t rps,
                 cudaStream_t st) {
  const T* c = reinterpret_cast<const T*>(corpus);
  const bool vec = (d * (int64_t)sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(corpus) & 15) == 0;
  if (vec)
    return launch_partial<T, BQ, true>(qparts, dp, c, pv, pi, qn, n, d, k,
                                       offset, n_total, splits, rps, st);
  return launch_partial<T, BQ, false>(qparts, dp, c, pv, pi, qn, n, d, k,
                                      offset, n_total, splits, rps, st);
}

template <typename T>
int dispatch_bq(const float* qparts, int64_t dp, const void* corpus,
                float* pv, int* pi, int qn, int64_t n, int64_t d, int k,
                int64_t offset, int64_t n_total, int splits, int64_t rps,
                int bq, cudaStream_t st) {
  switch (bq) {
    case 16:
      return dispatch_vec<T, 16>(qparts, dp, corpus, pv, pi, qn, n, d, k,
                                 offset, n_total, splits, rps, st);
    case 32:
      return dispatch_vec<T, 32>(qparts, dp, corpus, pv, pi, qn, n, d, k,
                                 offset, n_total, splits, rps, st);
    default:
      return dispatch_vec<T, 64>(qparts, dp, corpus, pv, pi, qn, n, d, k,
                                 offset, n_total, splits, rps, st);
  }
}

int search(const float* q, const void* corpus, int bf16_in, float* qparts,
           float* part_v, int* part_i, float* out_v, int* out_i, int qn,
           int64_t n, int64_t d, int k, int64_t offset, int64_t n_total,
           int splits, int64_t rps, int bq, void* stream) {
  // rps: rows a split, whole tiles; the splits cover [0, n) exactly
  if (qn <= 0 || n <= 0 || d <= 0 || k < 1 || k > MAX_K || k > n ||
      splits < 1 || splits > 1024 || rps < BN || rps % BN != 0 ||
      (n + rps - 1) / rps != splits || offset < 0 || n_total > BIG_IDX ||
      (bq != 16 && bq != 32 && bq != 64) || (bq == 64 && k > FULL_TILE_K) ||
      (qn + bq - 1) / bq > 65535 ||
      (reinterpret_cast<uintptr_t>(qparts) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t dp = (d + 3) / 4 * 4;
  const int64_t blocks = ((int64_t)qn * dp + THREADS - 1) / THREADS;
  split_queries_kernel<<<(unsigned)(blocks < 1024 ? blocks : 1024), THREADS,
                         0, st>>>(
      q, qparts, reinterpret_cast<bf16*>(qparts + (int64_t)qn * dp), qn, d,
      dp);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = bf16_in ? dispatch_bq<bf16>(qparts, dp, corpus, part_v, part_i, qn,
                                    n, d, k, offset, n_total, splits, rps,
                                    bq, st)
                : dispatch_bq<float>(qparts, dp, corpus, part_v, part_i, qn,
                                     n, d, k, offset, n_total, splits, rps,
                                     bq, st);
  if (err != 0) return err;
  const size_t smem = sizeof(int) * (size_t)WARPS * splits;
  mips_merge_kernel<<<(qn + WARPS - 1) / WARPS, THREADS, smem, st>>>(
      part_v, part_i, out_v, out_i, qn, k, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. q: device pointer to contiguous (qn, d)
// f32; corpus: contiguous (n, d), f32 or (bf16 != 0) bf16; qparts: scratch
// of 2 qn dp floats (dp = d rounded up to a multiple of 4), 16-byte
// aligned; part_v/part_i: (splits, qn, k) scratch;
// out_v/out_i: (qn, k). Split s holds local rows [s * rps, (s + 1) * rps):
// rps is a multiple of 256 and splits equals ceil(n / rps), at most 1024.
// bq is 16, 32 or 64 (64 only for k <= 64), 1 <= k <= 256, k <= n,
// n_total <= 2^30. Launches passes 0, 1 and 2 on `stream` and returns the
// first CUDA error (0 on success); it does not synchronise.
//
// mips_topk_search: the whole corpus, indices 0..n-1 (valid rows: those
// below min(n, n_total)); the counterpart of _mips_kernel.
extern "C" int mips_topk_search(const float* q, const void* corpus, int bf16,
                                float* qparts, float* part_v, int* part_i,
                                float* out_v, int* out_i, int qn, int64_t n,
                                int64_t d, int k, int64_t n_total, int splits,
                                int64_t rps, int bq, void* stream) {
  return search(q, corpus, bf16, qparts, part_v, part_i, out_v, out_i, qn, n,
                d, k, 0, n_total < n ? n_total : n, splits, rps, bq, stream);
}

// mips_topk_offset: the corpus is rows [offset, offset + n) of an
// n_total-row corpus; indices are global; the counterpart of
// _mips_kernel_offset.
extern "C" int mips_topk_offset(const float* q, const void* corpus, int bf16,
                                float* qparts, float* part_v, int* part_i,
                                float* out_v, int* out_i, int qn, int64_t n,
                                int64_t d, int k, int64_t offset,
                                int64_t n_total, int splits, int64_t rps,
                                int bq, void* stream) {
  return search(q, corpus, bf16, qparts, part_v, part_i, out_v, out_i, qn, n,
                d, k, offset, n_total, splits, rps, bq, stream);
}
