// The gradient of causal or sliding-window GQA attention, recomputed from
// the row log-sum-exp the forward saved, for Hopper (sm_90a): in bf16 on
// wgmma fed by a TMA ring, in f32 on the CUDA cores.
//
// Replaces no Pallas kernel: the Pallas flash kernel of
// src/repro/kernels/flash_attention.py has no backward. The reference
// trains through src/repro/models/attention.py:56-108, blockwise_attention,
// an online-softmax lax.scan over kv blocks whose step is under
// jax.checkpoint, so its gradient recomputes each block's scores and
// probabilities and never holds more than one (Sq x kv_block) block of
// them. This is that gradient, tile by tile. On q (B, H, Sq, Dqk), k (B,
// KVH, Skv, Dqk), v (B, KVH, Skv, Dv), the output o (B, H, Sq, Dv), its
// gradient do and the f32 row log-sum-exp lse (B, H, Sq), query head h
// reading kv head h / (H / KVH), the queries the last Sq of the Skv
// positions (q_offset = Skv - Sq), sums in f32:
//   delta = rowsum(do * o)                            (flash_bwd_delta)
//   p     = exp(q . k * scale - lse), 0 where masked  (recomputed)
//   dv    = p^T do,  dp = do v^T,  ds = p (dp - delta) scale
//   dk    = ds^T q, summed over the query heads of each kv head's group
//   dq    = ds k
// The mask is the forward's: kv_pos > q_pos when causal, and kv_pos <=
// q_pos - window when window > 0, masked. Deterministic in both routes:
// no atomics, every output element summed in a fixed order.
//
// What bounds it. The five products, 2 * 64 * 64 * (3 Dqk + 2 Dv)
// operations a visited (64, 64) tile pair and head, against q, k, v, o,
// do, lse read and dq, dk, dv written. At the token path's (B 8, H 32, KVH
// 4, S 128, Dh 64, bf16, causal) the bytes: 0.00567 ms at 3.35 TB/s
// against ~0.002 ms of operations at the bf16 tensor rate. Over 4096
// positions the operations: 0.17642 ms at the bf16 rate. At the path's
// shape the work is a few 64 x 64 tiles a head, so what decides the time
// is how soon all 132 SMs are busy and how little of a block's life is
// spent waiting; at 4096 positions, how busy the tensor cores are.
//
// The bf16 route: three launches a call (delta; one grid for both passes;
// the split fold, only where a group is split).
// - One grid holds both passes, each block one warpgroup (warps 0-3, the
//   consumers) and one producer warp (warp 4), kv-tile blocks first, each
//   pass heaviest first (causal: low kv tiles, then high query tiles).
//   The passes depend on delta only, not on each other, so the light
//   query-tile blocks fill the SMs that the kv-tile blocks leave.
// - The kv-tile pass (dK, dV): one block a (b, kv head, 64 kv rows, split
//   of the group). K and V of the tile land once by TMA; the producer
//   streams each (query head of the split, query tile) pair through a
//   ring of NS = 3 stages (mbarriers full and empty): Q and dO by TMA, the
//   pair's lse (times log2 e) and delta rows by the producer's 32 lanes.
//   The warpgroup forms S^T = K Q^T and dP^T = V dO^T as wgmma chains from
//   shared memory (M = 64 kv rows, K-major), then P^T and dS^T on their
//   accumulator registers (the mask, exp2 and lse of the f32 route; the
//   mask as each row's range of valid columns, two compares a score), and
//   adds dV += P^T dO and dK += dS^T Q with P^T and dS^T as bf16 A
//   operands from registers and dO and Q as B read MN-major through the
//   descriptor. P and dS rounded to bf16 as MMA operands follow the
//   reference's own precision: its scan casts p to v's type before p v
//   (models/attention.py:93-94).
// - The query-tile pass (dQ): one block a (b, head, 64 query rows); Q and
//   dO land once, K and V tile by tile through the ring; S = Q K^T, dP =
//   dO V^T, then dQ += dS K (K read MN-major). S and dP are formed in both
//   passes: seven products where the gradient needs five, the price of
//   owning every output in one block (no atomics, no dQ partials).
// - Filling the card. The kv-tile pass has B * KVH * ceil(Skv / 64)
//   tiles: 64 at the token path's shape, for 132 SMs. The wrapper splits a
//   GQA group's heads over nsplit blocks (a power of two dividing the
//   group, doubled while the kv-tile blocks number fewer than the SMs: 4
//   at the path, so 256 blocks of 2 heads; 1 over 4096 positions, whose
//   256 kv tiles already fill the card). Each split writes f32 partials to
//   a (B, KVH, nsplit, Skv, Dqk + Dv) scratch, and flash_bwd_fold sums
//   them in split order: 8 MiB at the path. The doubling stops once the
//   blocks reach 132, so the scratch stays under 2 x 132 x 64 rows of
//   Dqk + Dv f32 (20.6 MiB at (192, 128)), inside the 64 MiB the caller
//   allows.
// - Registers. The dK and dV accumulators live in registers across the
//   block's pairs: (Dqk + Dv) / 2 a thread, 160 at (192, 128). With S^T
//   and dP^T of 64 query columns (64 more) and their bf16 fragments, that
//   passes 255, so at Dqk 192 a kv-pass stage holds BQ = 32 query rows: S^T
//   and dP^T take 32 registers, the fragments 16, and the block runs alone
//   on its SM. Dqk 128 keeps 64 rows (128 + 64 + 32 fits in 255, one
//   block an SM). Up to Dqk 80 two blocks share an SM, which caps a thread
//   at 168 registers: Dqk 64 fits with 64 rows, Dqk 80 only with 32 (64
//   spilled and serialized its wgmma). ptxas -v (sm_90a, CUDA
//   12.8, the H100 machine's toolkit) for flash_bwd_wg, registers a thread
//   and spill bytes: (32, 32) 133, 0; (64, 64) 164, 0; (80, 80) 144, 0;
//   (128, 128) 228, 0; (192, 128) 223, 0.
// - Within a pair the warpgroup runs S^T/dP^T, then the softmax terms,
//   then dV/dK, each waiting on the last; the overlap comes from the TMA
//   ring (the next pairs' Q and dO land meanwhile) and from a second block
//   on the SM. Overlapping the chains inside the warpgroup (P^T formed
//   while dP^T runs, dS^T while dV runs) keeps P^T beside dP^T: at (64,
//   64) that passed 168 registers, spilled and ran slower. So did a mask
//   with a branch for interior tiles (PERF.md).
//
// The f32 route (unchanged since it was written): three kernels on the
// CUDA cores. flash_bwd_delta: one warp a row, a fixed shuffle tree.
// flash_bwd_dkdv: one block a (b, kv head, 64 kv rows), K and V in
// shared memory, walking the group's heads and the query tiles that see
// the tile, recomputing S and dP, summing dK and dV in registers.
// flash_bwd_dq: one block a (b, head, 64 query rows) over the kv tiles it
// sees. Every product in f32 FMAs from operands staged in shared memory,
// in 4 x 4 (or 4 x D/16) register tiles of a 16 x 16 thread grid. Moving
// it to the tensor cores needs the forward's split terms (TF32 + bf16
// remainders, csrc/flash_attention.cu) in five products: open (ROADMAP).
// Shared memory (f32, one layout for both tile kernels): 206 KB at (192,
// 128), 108 KB at (64, 64).
#include "hopper.cuh"   // TMA, mbarriers, wgmma, tensor maps (shared)

namespace {

constexpr int BM = 64;             // f32 route: query rows a tile
constexpr int BN = 64;             // f32 route: kv rows a tile
constexpr int THREADS = 256;       // f32 route: a 16 x 16 grid of threads
constexpr int LP = BN + 16;        // row stride of P and dS in shared memory
constexpr float LOG2E = 1.4426950408889634f;

template <int DQK, int DV>
struct Layout {
  static constexpr int LQ = DQK + 1;     // padded rows of Q and K
  static constexpr int LV = DV + 1;      // padded rows of V and dO
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = OFF_K + BN * LQ;
  static constexpr int OFF_Q = OFF_V + BN * LV;
  static constexpr int OFF_DO = OFF_Q + BM * LQ;
  static constexpr int OFF_P = OFF_DO + BM * LV;
  static constexpr int OFF_DS = OFF_P + BM * LP;
  static constexpr int OFF_LSE = OFF_DS + BM * LP;
  static constexpr int OFF_DELTA = OFF_LSE + BM;
  static constexpr int SMEM = 4 * (OFF_DELTA + BM);
  static constexpr int MIN_BLOCKS = SMEM <= 110 * 1024 ? 2 : 1;
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "dims of whole 16 columns");
};

// The kernels' arguments: operands, outputs and their element strides
// along (b, h, s), in the order q, k, v, o, do, dq, dk, dv; the bf16
// route's split of each group (nsplit), its f32 partials (scratch) and
// the kv-tile blocks that lead its grid (kv_blocks).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  float* scratch;
  int B, H, KVH, Sq, Skv, Dv, group, causal, window, nsplit, kv_blocks;
  float scale, scale_log2;
  long long st[24];
};

enum { Q = 0, K = 3, V = 6, O = 9, DO = 12, DQ = 15, DK = 18, DV_ = 21 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ int64_t base(const Args& a, int t, int b, int h) {
  return static_cast<int64_t>(b) * a.st[t] + static_cast<int64_t>(h) *
         a.st[t + 1];
}

// rows [r0, r0 + n) of a (b, h) slice into an R-row tile of D + 1 floats a
// row; rows past n are zeros
template <int D, int R, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int64_t off, long long s_stride,
                                          int r0, int n) {
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS) {
    const int r = idx / D, c = idx - r * D;
    float x = 0.f;
    if (r < n)
      x = to_f(src[off + static_cast<int64_t>(r0 + r) * s_stride + c]);
    dst[r * (D + 1) + c] = x;
  }
}

// acc[x][y] += sum_d A[ty + 16x][d] B[tx + 16y][d]  (A B^T, 64 x 64)
template <int D>
__device__ __forceinline__ void nt(float (&acc)[4][4], const float* A,
                                   const float* B, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) av[x] = A[(ty + 16 * x) * (D + 1) + d];
#pragma unroll
    for (int y = 0; y < 4; ++y) bv[y] = B[(tx + 16 * y) * (D + 1) + d];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
  }
}

// acc[x][y] += sum_i A[i][ty + 16x] B[i][tx + 16y]  (A^T B; A: 64 x LP,
// B: 64 x (D + 1))
template <int D>
__device__ __forceinline__ void tn(float (&acc)[4][D / 16], const float* A,
                                   const float* B, int ty, int tx) {
#pragma unroll 2
  for (int i = 0; i < BM; ++i) {
    float av[4], bv[D / 16];
#pragma unroll
    for (int x = 0; x < 4; ++x) av[x] = A[i * LP + ty + 16 * x];
#pragma unroll
    for (int y = 0; y < D / 16; ++y) bv[y] = B[i * (D + 1) + tx + 16 * y];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < D / 16; ++y)
        acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
  }
}

// acc[x][y] += sum_j A[ty + 16x][j] B[j][tx + 16y]  (A B; A: 64 x LP, B:
// 64 x (D + 1))
template <int D>
__device__ __forceinline__ void nn(float (&acc)[4][D / 16], const float* A,
                                   const float* B, int ty, int tx) {
#pragma unroll 2
  for (int j = 0; j < BN; ++j) {
    float av[4], bv[D / 16];
#pragma unroll
    for (int x = 0; x < 4; ++x) av[x] = A[(ty + 16 * x) * LP + j];
#pragma unroll
    for (int y = 0; y < D / 16; ++y) bv[y] = B[j * (D + 1) + tx + 16 * y];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < D / 16; ++y)
        acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
  }
}

// S = Q K^T and dP = dO V^T of one tile pair, then P and dS into shared
// memory: rows i0 + (ty + 16x), columns j0 + (tx + 16y)
template <int DQK, int DV>
__device__ __forceinline__ void probs(const Args& a, float* sm, int i0,
                                      int j0, int ty, int tx) {
  using L = Layout<DQK, DV>;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) s[x][y] = dp[x][y] = 0.f;
  nt<DQK>(s, sm + L::OFF_Q, sm + L::OFF_K, ty, tx);
  nt<DV>(dp, sm + L::OFF_DO, sm + L::OFF_V, ty, tx);
  const int q_offset = a.Skv - a.Sq;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int r = ty + 16 * x, i = i0 + r, qp = q_offset + i;
    const float lse = sm[L::OFF_LSE + r], delta = sm[L::OFF_DELTA + r];
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int c = tx + 16 * y, j = j0 + c;
      const bool valid = i < a.Sq && j < a.Skv && (!a.causal || j <= qp) &&
                         (a.window <= 0 || j > qp - a.window);
      const float p =
          valid ? exp2f(fmaf(s[x][y], a.scale_log2, -lse)) : 0.f;
      sm[L::OFF_P + r * LP + c] = p;
      sm[L::OFF_DS + r * LP + c] = p * (dp[x][y] - delta) * a.scale;
    }
  }
}

// the query rows [i0, i0 + n) of head h: Q, dO, lse (times log2 e) and
// delta; rows past n are zeros
template <int DQK, int DV, typename T>
__device__ __forceinline__ void load_queries(const Args& a, float* sm, int b,
                                             int h, int i0, int n) {
  using L = Layout<DQK, DV>;
  load_rows<DQK, BM>(sm + L::OFF_Q, static_cast<const T*>(a.q),
                     base(a, Q, b, h), a.st[Q + 2], i0, n);
  load_rows<DV, BM>(sm + L::OFF_DO, static_cast<const T*>(a.dout),
                    base(a, DO, b, h), a.st[DO + 2], i0, n);
  if (threadIdx.x < BM) {
    const int r = threadIdx.x;
    const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.Sq + i0 + r;
    sm[L::OFF_LSE + r] = r < n ? a.lse[row] * LOG2E : 0.f;
    sm[L::OFF_DELTA + r] = r < n ? a.delta[row] : 0.f;
  }
}

// acc's rows r0 + (ty + 16x) < n, columns tx + 16y, to the (b, h) slice of
// an output
template <int D, typename T>
__device__ __forceinline__ void write_rows(const float (&acc)[4][D / 16],
                                           T* out, int64_t off,
                                           long long s_stride, int r0, int n,
                                           int ty, int tx) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int r = ty + 16 * x;
    if (r >= n) continue;
    T* row = out + off + static_cast<int64_t>(r0 + r) * s_stride;
#pragma unroll
    for (int y = 0; y < D / 16; ++y) store(row + tx + 16 * y, acc[x][y]);
  }
}

// -------------------------------------------------------- both routes --

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_delta(const Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (THREADS / 32) +
                      warp;
  if (row >= static_cast<int64_t>(a.B) * a.H * a.Sq) return;
  const int i = static_cast<int>(row % a.Sq);
  const int h = static_cast<int>(row / a.Sq % a.H);
  const int b = static_cast<int>(row / a.Sq / a.H);
  const T* o = static_cast<const T*>(a.o) + base(a, O, b, h) +
               static_cast<int64_t>(i) * a.st[O + 2];
  const T* g = static_cast<const T*>(a.dout) + base(a, DO, b, h) +
               static_cast<int64_t>(i) * a.st[DO + 2];
  float acc = 0.f;
  for (int c = lane; c < a.Dv; c += 32)
    acc = fmaf(to_f(o[c]), to_f(g[c]), acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) a.delta[row] = acc;
}

// ------------------------------------------- the f32 route: CUDA cores --

template <int DQK, int DV, typename T>
__global__ void __launch_bounds__(THREADS, (Layout<DQK, DV>::MIN_BLOCKS))
    flash_bwd_dkdv(const Args a) {
  using L = Layout<DQK, DV>;
  extern __shared__ float sm[];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int per = a.B * a.KVH;
  const int kt = static_cast<int>(blockIdx.x) / per;     // heaviest first
  const int b = static_cast<int>(blockIdx.x) % per / a.KVH;
  const int kh = static_cast<int>(blockIdx.x) % a.KVH;
  const int j0 = kt * BN, nj = min(BN, a.Skv - j0);
  const int q_offset = a.Skv - a.Sq;
  load_rows<DQK, BN>(sm + L::OFF_K, static_cast<const T*>(a.k),
                     base(a, K, b, kh), a.st[K + 2], j0, nj);
  load_rows<DV, BN>(sm + L::OFF_V, static_cast<const T*>(a.v),
                    base(a, V, b, kh), a.st[V + 2], j0, nj);
  // the query tiles that see a row of this kv tile: from the tile holding
  // the first causal row, to the last row whose window reaches the tile
  const int i_lo = (a.causal ? max(0, j0 - q_offset) : 0) / BM * BM;
  const int i_hi = a.window > 0
                       ? min(a.Sq, j0 + nj - 1 + a.window - q_offset)
                       : a.Sq;
  float dk[4][DQK / 16], dv[4][DV / 16];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int y = 0; y < DQK / 16; ++y) dk[x][y] = 0.f;
#pragma unroll
    for (int y = 0; y < DV / 16; ++y) dv[x][y] = 0.f;
  }
  for (int g = 0; g < a.group; ++g) {
    const int h = kh * a.group + g;
    for (int i0 = i_lo; i0 < i_hi; i0 += BM) {
      __syncthreads();       // the last pair's readers are done
      load_queries<DQK, DV, T>(a, sm, b, h, i0, min(BM, a.Sq - i0));
      __syncthreads();
      probs<DQK, DV>(a, sm, i0, j0, ty, tx);
      __syncthreads();
      tn<DV>(dv, sm + L::OFF_P, sm + L::OFF_DO, ty, tx);
      tn<DQK>(dk, sm + L::OFF_DS, sm + L::OFF_Q, ty, tx);
    }
  }
  write_rows<DQK>(dk, static_cast<T*>(a.dk), base(a, DK, b, kh),
                  a.st[DK + 2], j0, nj, ty, tx);
  write_rows<DV>(dv, static_cast<T*>(a.dv), base(a, DV_, b, kh),
                 a.st[DV_ + 2], j0, nj, ty, tx);
}

template <int DQK, int DV, typename T>
__global__ void __launch_bounds__(THREADS, (Layout<DQK, DV>::MIN_BLOCKS))
    flash_bwd_dq(const Args a) {
  using L = Layout<DQK, DV>;
  extern __shared__ float sm[];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int per = a.B * a.H;
  const int nqt = (a.Sq + BM - 1) / BM;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x) / per;  // heaviest
  const int b = static_cast<int>(blockIdx.x) % per / a.H;
  const int h = static_cast<int>(blockIdx.x) % a.H;
  const int kh = h / a.group;
  const int i0 = qt * BM, ni = min(BM, a.Sq - i0);
  const int q_offset = a.Skv - a.Sq;
  load_queries<DQK, DV, T>(a, sm, b, h, i0, ni);
  // the kv tiles the query tile sees: from the tile holding its first
  // row's window start to its last row's causal end
  const int kv_lo =
      (a.window > 0 ? max(0, q_offset + i0 - a.window + 1) : 0) / BN * BN;
  const int kv_hi = a.causal ? q_offset + i0 + ni : a.Skv;
  float dq[4][DQK / 16];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < DQK / 16; ++y) dq[x][y] = 0.f;
  for (int j0 = kv_lo; j0 < kv_hi; j0 += BN) {
    const int nj = min(BN, a.Skv - j0);
    __syncthreads();         // the last tile's readers are done
    load_rows<DQK, BN>(sm + L::OFF_K, static_cast<const T*>(a.k),
                       base(a, K, b, kh), a.st[K + 2], j0, nj);
    load_rows<DV, BN>(sm + L::OFF_V, static_cast<const T*>(a.v),
                      base(a, V, b, kh), a.st[V + 2], j0, nj);
    __syncthreads();
    probs<DQK, DV>(a, sm, i0, j0, ty, tx);
    __syncthreads();
    nn<DQK>(dq, sm + L::OFF_DS, sm + L::OFF_K, ty, tx);
  }
  write_rows<DQK>(dq, static_cast<T*>(a.dq), base(a, DQ, b, h),
                  a.st[DQ + 2], i0, ni, ty, tx);
}

// ----------------------------------------------- the bf16 route: wgmma --

constexpr int WG_THREADS = 160;  // one consumer warpgroup, one producer warp
constexpr int KR = 64;           // kv rows a tile; query rows a dq-pass tile
constexpr int NS = 3;            // stages of the ring

template <int DQK, int DV>
struct Wg {
  using QK = Rows<DQK, 2>;       // rows of Q and K
  using VO = Rows<DV, 2>;        // rows of V and dO
  // query rows a kv-pass stage (see the registers, above)
  static constexpr int BQ = DQK == 80 || DQK > 128 ? 32 : 64;
  static constexpr int A_BYTES = KR * QK::BYTES;   // a 64-row tile of Dqk
  static constexpr int B_BYTES = KR * VO::BYTES;   // a 64-row tile of Dv
  // the fixed pair (kv pass: K, V; dq pass: Q, dO), then NS ring slots of
  // the same two sizes (kv pass: BQ rows of Q and dO; dq pass: K, V), then
  // NS x (lse, delta) rows of BQ floats (kv pass), then the barriers:
  // fixed full, NS full, NS empty; 1024 bytes of slack to align the base
  // for the 128-byte swizzle
  static constexpr int SLOT = A_BYTES + B_BYTES;
  static constexpr int OFF_RING = SLOT;
  static constexpr int OFF_ROWS = OFF_RING + NS * SLOT;
  static constexpr int OFF_BAR = OFF_ROWS + NS * 2 * BQ * 4;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * NS) + 1024;
  static constexpr int MIN_BLOCKS = DQK <= 80 ? 2 : 1;
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(KR % BQ == 0 && A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0,
                "whole stages in a tile, tiles on 1024-byte boundaries");
};

// The f32 route's probs on accumulator registers, in two steps: s becomes
// p = exp2(s scale_log2 - lse2) where its column c lies in its row's
// [lo, hi), else 0; then dp becomes ds = p (dp - delta) scale.
__device__ __forceinline__ void prob(const Args& a, float& s, int c, int lo,
                                     int hi, float lse2) {
  s = c >= lo && c < hi ? exp2f(fmaf(s, a.scale_log2, -lse2)) : 0.f;
}

__device__ __forceinline__ void dprob(const Args& a, float p, float& dp,
                                      float delta) {
  dp = p * (dp - delta) * a.scale;
}

// The forward's mask as a range of columns a row sees, so that an
// element costs two compares. kv-pass row (kv position j), columns query
// rows i0 + c: the queries that see j, causal from j's own position, a
// window up to j's position + window, and not past Sq.
__device__ __forceinline__ void kv_row_range(const Args& a, int j, int i0,
                                             int& lo, int& hi) {
  const int d = j - (a.Skv - a.Sq) - i0;        // j's own query column
  lo = a.causal ? d : 0;
  hi = min(a.Sq - i0, a.window > 0 ? d + a.window : a.Sq);
  if (j >= a.Skv) hi = lo;
}

// query-pass row (query row i), columns kv positions kv0 + c: from its
// window's start to its causal end, not past Skv
__device__ __forceinline__ void q_row_range(const Args& a, int i, int kv0,
                                            int& lo, int& hi) {
  const int d = (a.Skv - a.Sq) + i - kv0;       // i's own kv column
  lo = a.window > 0 ? d - a.window + 1 : 0;
  hi = min(a.Skv - kv0, a.causal ? d + 1 : a.Skv);
  if (i >= a.Sq) hi = lo;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(WG_THREADS, (Wg<DQK, DV>::MIN_BLOCKS))
flash_bwd_wg(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_do, const Args a) {
  using C = Wg<DQK, DV>;
  using QK = typename C::QK;
  using VO = typename C::VO;
  constexpr int BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_fa = smem_u32(smem), s_fb = s_fa + C::A_BYTES,
                 s_ring = s_fa + C::OFF_RING;
  float* rows = reinterpret_cast<float*>(smem + C::OFF_ROWS);
  const uint32_t full_f = s_fa + C::OFF_BAR, full = full_f + 8,
                 empty = full + 8 * NS;
  if (threadIdx.x == 0) {
    mbar_init(full_f, 1);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 32);         // the producer's lanes
      mbar_init(empty + 8 * s, 128);       // the consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16 + g;            // a consumer's rows r0, r0 + 8
  const int q_offset = a.Skv - a.Sq;

  if (static_cast<int>(blockIdx.x) < a.kv_blocks) {
    // ---- the kv-tile pass: dK and dV of 64 kv rows over a split's heads
    const int per = a.B * a.KVH * a.nsplit;
    const int kt = static_cast<int>(blockIdx.x) / per;   // heaviest first
    const int rem = static_cast<int>(blockIdx.x) % per;
    const int b = rem / (a.KVH * a.nsplit);
    const int kvh = rem / a.nsplit % a.KVH;
    const int sp = rem % a.nsplit;
    const int heads = a.group / a.nsplit;
    const int h0 = kvh * a.group + sp * heads;
    const int j0 = kt * KR, nj = min(KR, a.Skv - j0);
    // the query tiles that see a row of this kv tile: from the tile
    // holding the first causal row, to the last row whose window reaches
    // the tile; the pairs run head by head, query tiles ascending
    const int i_lo = (a.causal ? max(0, j0 - q_offset) : 0) / BQ * BQ;
    const int i_hi = a.window > 0
                         ? min(a.Sq, j0 + nj - 1 + a.window - q_offset)
                         : a.Sq;
    const int nqt = i_hi > i_lo ? (i_hi - i_lo + BQ - 1) / BQ : 0;
    const int n = heads * nqt;

    if (warp == 4) {               // the producer
      if (lane == 0) {
        mbar_expect_tx(full_f, C::A_BYTES + C::B_BYTES);
#pragma unroll
        for (int jb = 0; jb < QK::NB; ++jb)
          tma_load_4d(s_fa + jb * KR * QK::SW, &tm_k, full_f, jb * QK::BOXW,
                      kvh, j0, b);
#pragma unroll
        for (int jb = 0; jb < VO::NB; ++jb)
          tma_load_4d(s_fb + jb * KR * VO::SW, &tm_v, full_f, jb * VO::BOXW,
                      kvh, j0, b);
      }
      for (int t = 0; t < n; ++t) {
        const int s = t % NS;
        const int h = h0 + t / nqt, i0 = i_lo + t % nqt * BQ;
        mbar_wait(empty + 8 * s, ((t / NS) & 1) ^ 1);
        float* lr = rows + s * 2 * BQ;   // lse (times log2 e), delta
        for (int r = lane; r < BQ; r += 32) {
          const int i = i0 + r;
          const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.Sq + i;
          lr[r] = i < a.Sq ? a.lse[row] * LOG2E : 0.f;
          lr[BQ + r] = i < a.Sq ? a.delta[row] : 0.f;
        }
        if (lane == 0) {           // Q and dO; its arrival carries the bytes
          const uint32_t sq = s_ring + s * C::SLOT, sdo = sq + C::A_BYTES;
          mbar_expect_tx(full + 8 * s, BQ * (QK::BYTES + VO::BYTES));
#pragma unroll
          for (int jb = 0; jb < QK::NB; ++jb)
            tma_load_4d(sq + jb * BQ * QK::SW, &tm_q, full + 8 * s,
                        jb * QK::BOXW, h, i0, b);
#pragma unroll
          for (int jb = 0; jb < VO::NB; ++jb)
            tma_load_4d(sdo + jb * BQ * VO::SW, &tm_do, full + 8 * s,
                        jb * VO::BOXW, h, i0, b);
        } else {
          mbar_arrive(full + 8 * s);
        }
      }
      return;
    }

    float dk[DQK / 2], dv[DV / 2];
#pragma unroll
    for (int i = 0; i < DQK / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;
    float st[BQ / 2], dpt[BQ / 2];               // S^T, dP^T: kv x query
    uint32_t pf[BQ / 4], df[BQ / 4];             // P^T, dS^T as bf16 A
    mbar_wait(full_f, 0);
    for (int t = 0; t < n; ++t) {
      const int s = t % NS, i0 = i_lo + t % nqt * BQ;
      const uint32_t sq = s_ring + s * C::SLOT, sdo = sq + C::A_BYTES;
      int lo[2], hi[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        kv_row_range(a, j0 + r0 + 8 * e, i0, lo[e], hi[e]);
      mbar_wait(full + 8 * s, (t / NS) & 1);
      // S^T and dP^T, then P^T and dS^T, then dV and dK, each waiting on
      // the last (the header note says why)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        wgmma_ss<BQ, false>(st, kmajor<QK, KR>(s_fa, kk),
                            kmajor<QK, BQ>(sq, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss<BQ, false>(dpt, kmajor<VO, KR>(s_fb, kk),
                            kmajor<VO, BQ>(sdo, kk), kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      // thread (g, tig) of warp w holds kv rows r0 (e = 0, 1) and r0 + 8
      // (e = 2, 3), query columns 8 jj + 2 tig and + 1
      const float* lr = rows + s * 2 * BQ;
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * jj + 2 * tig + (e & 1);
          prob(a, st[4 * jj + e], c, lo[e >> 1], hi[e >> 1], lr[c]);
          dprob(a, st[4 * jj + e], dpt[4 * jj + e], lr[BQ + c]);
        }
#pragma unroll
      for (int i = 0; i < BQ / 4; ++i) {
        pf[i] = pack_bf16(st[2 * i], st[2 * i + 1]);
        df[i] = pack_bf16(dpt[2 * i], dpt[2 * i + 1]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<DV>(dv, pf + 4 * kk, mnmajor<VO, BQ>(sdo, kk));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<DQK>(dk, df + 4 * kk, mnmajor<QK, BQ>(sq, kk));
      wg_commit();
      wg_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pf);
      fence_regs(df);
      mbar_arrive(empty + 8 * s);
    }
    // rows r0 and r0 + 8 of the tile: to dk and dv, or to the split's
    // f32 partials
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = j0 + r0 + 8 * i;
      if (j >= a.Skv) continue;
      if (a.nsplit == 1) {
        bf16* rk = static_cast<bf16*>(a.dk) + base(a, DK, b, kvh) +
                   static_cast<int64_t>(j) * a.st[DK + 2];
        bf16* rv = static_cast<bf16*>(a.dv) + base(a, DV_, b, kvh) +
                   static_cast<int64_t>(j) * a.st[DV_ + 2];
#pragma unroll
        for (int jj = 0; jj < DQK / 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(rk + 8 * jj + 2 * tig) =
              __floats2bfloat162_rn(dk[4 * jj + 2 * i], dk[4 * jj + 2 * i + 1]);
#pragma unroll
        for (int jj = 0; jj < DV / 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(rv + 8 * jj + 2 * tig) =
              __floats2bfloat162_rn(dv[4 * jj + 2 * i], dv[4 * jj + 2 * i + 1]);
      } else {
        float* rp = a.scratch +
                    (((static_cast<int64_t>(b) * a.KVH + kvh) * a.nsplit + sp) *
                         a.Skv + j) * (DQK + DV);
#pragma unroll
        for (int jj = 0; jj < DQK / 8; ++jj)
          *reinterpret_cast<float2*>(rp + 8 * jj + 2 * tig) =
              make_float2(dk[4 * jj + 2 * i], dk[4 * jj + 2 * i + 1]);
#pragma unroll
        for (int jj = 0; jj < DV / 8; ++jj)
          *reinterpret_cast<float2*>(rp + DQK + 8 * jj + 2 * tig) =
              make_float2(dv[4 * jj + 2 * i], dv[4 * jj + 2 * i + 1]);
      }
    }
    return;
  }

  // ---- the query-tile pass: dQ of 64 query rows of one head
  const int idx = static_cast<int>(blockIdx.x) - a.kv_blocks;
  const int per = a.B * a.H;
  const int nqt = (a.Sq + KR - 1) / KR;
  const int qt = nqt - 1 - idx / per;                  // heaviest first
  const int b = idx % per / a.H, h = idx % a.H, kvh = h / a.group;
  const int i0 = qt * KR, ni = min(KR, a.Sq - i0);
  // the kv tiles the query tile sees: from the tile holding its first
  // row's window start to its last row's causal end
  const int kv_lo =
      (a.window > 0 ? max(0, q_offset + i0 - a.window + 1) : 0) / KR * KR;
  const int kv_hi = a.causal ? q_offset + i0 + ni : a.Skv;
  const int n = (kv_hi - kv_lo + KR - 1) / KR;

  if (warp == 4) {                 // the producer
    if (lane == 0) {
      mbar_expect_tx(full_f, C::A_BYTES + C::B_BYTES);
#pragma unroll
      for (int rc = 0; rc < KR / BQ; ++rc) {     // Q and dO in boxes of BQ
#pragma unroll
        for (int jb = 0; jb < QK::NB; ++jb)
          tma_load_4d(s_fa + (jb * KR + rc * BQ) * QK::SW, &tm_q, full_f,
                      jb * QK::BOXW, h, i0 + rc * BQ, b);
#pragma unroll
        for (int jb = 0; jb < VO::NB; ++jb)
          tma_load_4d(s_fb + (jb * KR + rc * BQ) * VO::SW, &tm_do, full_f,
                      jb * VO::BOXW, h, i0 + rc * BQ, b);
      }
    }
    for (int t = 0; t < n; ++t) {
      const int s = t % NS, kv0 = kv_lo + t * KR;
      mbar_wait(empty + 8 * s, ((t / NS) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t sk = s_ring + s * C::SLOT, sv = sk + C::A_BYTES;
        mbar_expect_tx(full + 8 * s, C::SLOT);
#pragma unroll
        for (int jb = 0; jb < QK::NB; ++jb)
          tma_load_4d(sk + jb * KR * QK::SW, &tm_k, full + 8 * s,
                      jb * QK::BOXW, kvh, kv0, b);
#pragma unroll
        for (int jb = 0; jb < VO::NB; ++jb)
          tma_load_4d(sv + jb * KR * VO::SW, &tm_v, full + 8 * s,
                      jb * VO::BOXW, kvh, kv0, b);
      } else {
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // rows r0 and r0 + 8: lse (times log2 e) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = i0 + r0 + 8 * e;
    const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.Sq + i;
    lse2[e] = i < a.Sq ? a.lse[row] * LOG2E : 0.f;
    dl[e] = i < a.Sq ? a.delta[row] : 0.f;
  }
  float dq[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) dq[i] = 0.f;
  float sc[KR / 2], dp[KR / 2];                  // S, dP: query x kv
  uint32_t df[KR / 4];                           // dS as bf16 A
  mbar_wait(full_f, 0);
  for (int t = 0; t < n; ++t) {
    const int s = t % NS, kv0 = kv_lo + t * KR;
    const uint32_t sk = s_ring + s * C::SLOT, sv = sk + C::A_BYTES;
    int lo[2], hi[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      q_row_range(a, i0 + r0 + 8 * e, kv0, lo[e], hi[e]);
    mbar_wait(full + 8 * s, (t / NS) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      wgmma_ss<KR, false>(sc, kmajor<QK, KR>(s_fa, kk),
                          kmajor<QK, KR>(sk, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      wgmma_ss<KR, false>(dp, kmajor<VO, KR>(s_fb, kk),
                          kmajor<VO, KR>(sv, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int jj = 0; jj < KR / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        prob(a, sc[4 * jj + e], 8 * jj + 2 * tig + (e & 1), lo[e >> 1],
             hi[e >> 1], lse2[e >> 1]);
        dprob(a, sc[4 * jj + e], dp[4 * jj + e], dl[e >> 1]);
      }
#pragma unroll
    for (int i = 0; i < KR / 4; ++i)
      df[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KR / 16; ++kk)
      wgmma_rs<DQK>(dq, df + 4 * kk, mnmajor<QK, KR>(sk, kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(dq);
    fence_regs(df);
    mbar_arrive(empty + 8 * s);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = i0 + r0 + 8 * e;
    if (i >= a.Sq) continue;
    bf16* rq = static_cast<bf16*>(a.dq) + base(a, DQ, b, h) +
               static_cast<int64_t>(i) * a.st[DQ + 2];
#pragma unroll
    for (int jj = 0; jj < DQK / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(rq + 8 * jj + 2 * tig) =
          __floats2bfloat162_rn(dq[4 * jj + 2 * e], dq[4 * jj + 2 * e + 1]);
  }
}

// The split partials of dK and dV summed in split order and written in
// bf16: one thread a column pair of one (b, kv head, kv row).
__global__ void __launch_bounds__(THREADS) flash_bwd_fold(const Args a,
                                                          int dqk) {
  const int w = dqk + a.Dv, pairs = w / 2;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(a.B) * a.KVH * a.Skv * pairs) return;
  const int c = static_cast<int>(idx % pairs) * 2;
  const int64_t row = idx / pairs;
  const int j = static_cast<int>(row % a.Skv);
  const int kvh = static_cast<int>(row / a.Skv % a.KVH);
  const int b = static_cast<int>(row / a.Skv / a.KVH);
  const float* p = a.scratch +
                   ((static_cast<int64_t>(b) * a.KVH + kvh) * a.nsplit *
                        a.Skv + j) * w + c;
  float2 acc = *reinterpret_cast<const float2*>(p);
  for (int sp = 1; sp < a.nsplit; ++sp) {
    const float2 x = *reinterpret_cast<const float2*>(
        p + static_cast<int64_t>(sp) * a.Skv * w);
    acc.x += x.x;
    acc.y += x.y;
  }
  bf16* out = c < dqk
                  ? static_cast<bf16*>(a.dk) + base(a, DK, b, kvh) +
                        static_cast<int64_t>(j) * a.st[DK + 2] + c
                  : static_cast<bf16*>(a.dv) + base(a, DV_, b, kvh) +
                        static_cast<int64_t>(j) * a.st[DV_ + 2] + (c - dqk);
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(acc.x, acc.y);
}

// ------------------------------------------------------------- launches --

template <class F>
cudaError_t opt_in(F* kernel, int bytes, unsigned* opted) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && (*opted & (1u << dev))) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 32) *opted |= 1u << dev;
  return e;
}

// the f32 route: delta, then dk/dv, then dq
template <int DQK, int DV>
int launch_cores(const Args& a, cudaStream_t stream) {
  using L = Layout<DQK, DV>;
  const long long rows = static_cast<long long>(a.B) * a.H * a.Sq;
  const long long rows_blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  const long long kv_blocks =
      static_cast<long long>((a.Skv + BN - 1) / BN) * a.B * a.KVH;
  const long long q_blocks =
      static_cast<long long>((a.Sq + BM - 1) / BM) * a.B * a.H;
  if (rows_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL ||
      q_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static unsigned opted_dkdv = 0, opted_dq = 0;
  cudaError_t e =
      opt_in(flash_bwd_dkdv<DQK, DV, float>, L::SMEM, &opted_dkdv);
  if (e != cudaSuccess) return (int)e;
  e = opt_in(flash_bwd_dq<DQK, DV, float>, L::SMEM, &opted_dq);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_delta<float><<<(unsigned)rows_blocks, THREADS, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv<DQK, DV, float>
      <<<(unsigned)kv_blocks, THREADS, L::SMEM, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq<DQK, DV, float>
      <<<(unsigned)q_blocks, THREADS, L::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// the bf16 route: delta, then both passes in one grid, then the fold
template <int DQK, int DV>
int launch_wg(Args a, cudaStream_t stream) {
  using C = Wg<DQK, DV>;
  constexpr cuuint64_t ES = 2;
  const long long rows = static_cast<long long>(a.B) * a.H * a.Sq;
  const long long rows_blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  const long long kv_blocks = static_cast<long long>((a.Skv + KR - 1) / KR) *
                              a.B * a.KVH * a.nsplit;
  const long long q_blocks =
      static_cast<long long>((a.Sq + KR - 1) / KR) * a.B * a.H;
  const long long fold_blocks =
      a.nsplit > 1 ? (static_cast<long long>(a.B) * a.KVH * a.Skv *
                          ((DQK + DV) / 2) + THREADS - 1) / THREADS
                   : 0;
  if (rows_blocks > 0x7fffffffLL || kv_blocks + q_blocks > 0x7fffffffLL ||
      fold_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  a.kv_blocks = static_cast<int>(kv_blocks);

  // tensor maps (innermost first: head dim, heads, positions, batch) with
  // the operands' real strides; boxes of one head and BQ query or 64 kv
  // rows
  const long long* st = a.st;
  CUtensorMap mq, mk, mv, mdo;
  const cuuint64_t qd[4] = {DQK, (cuuint64_t)a.H, (cuuint64_t)a.Sq,
                            (cuuint64_t)a.B};
  const cuuint64_t qs[3] = {st[Q + 1] * ES, st[Q + 2] * ES, st[Q] * ES};
  const cuuint32_t qb[4] = {C::QK::BOXW, 1, C::BQ, 1};
  const cuuint64_t kd[4] = {DQK, (cuuint64_t)a.KVH, (cuuint64_t)a.Skv,
                            (cuuint64_t)a.B};
  const cuuint64_t ks[3] = {st[K + 1] * ES, st[K + 2] * ES, st[K] * ES};
  const cuuint32_t kb[4] = {C::QK::BOXW, 1, KR, 1};
  const cuuint64_t vd[4] = {DV, (cuuint64_t)a.KVH, (cuuint64_t)a.Skv,
                            (cuuint64_t)a.B};
  const cuuint64_t vs[3] = {st[V + 1] * ES, st[V + 2] * ES, st[V] * ES};
  const cuuint32_t vb[4] = {C::VO::BOXW, 1, KR, 1};
  const cuuint64_t dd[4] = {DV, (cuuint64_t)a.H, (cuuint64_t)a.Sq,
                            (cuuint64_t)a.B};
  const cuuint64_t ds[3] = {st[DO + 1] * ES, st[DO + 2] * ES, st[DO] * ES};
  const cuuint32_t db[4] = {C::VO::BOXW, 1, C::BQ, 1};
  if (!encode(&mq, a.q, false, 4, qd, qs, qb, C::QK::SW) ||
      !encode(&mk, a.k, false, 4, kd, ks, kb, C::QK::SW) ||
      !encode(&mv, a.v, false, 4, vd, vs, vb, C::VO::SW) ||
      !encode(&mdo, a.dout, false, 4, dd, ds, db, C::VO::SW))
    return (int)cudaErrorInvalidValue;

  static unsigned opted = 0;
  cudaError_t e = opt_in(flash_bwd_wg<DQK, DV>, C::SMEM, &opted);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_delta<bf16><<<(unsigned)rows_blocks, THREADS, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_wg<DQK, DV><<<(unsigned)(kv_blocks + q_blocks), WG_THREADS,
                          C::SMEM, stream>>>(mq, mk, mv, mdo, a);
  e = cudaGetLastError();
  if (e != cudaSuccess || fold_blocks == 0) return (int)e;
  flash_bwd_fold<<<(unsigned)fold_blocks, THREADS, 0, stream>>>(a, DQK);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_type(int bf16_in, const Args& a, cudaStream_t s) {
  return bf16_in ? launch_wg<DQK, DV>(a, s) : launch_cores<DQK, DV>(a, s);
}

}  // namespace

// q (B, H, Sq, Dqk), k (B, KVH, Skv, Dqk), v (B, KVH, Skv, Dv), o and do
// (B, H, Sq, Dv) of one type (bf16 != 0: __nv_bfloat16, else float), lse
// a contiguous (B, H, Sq) f32 tensor; delta a contiguous (B, H, Sq) f32
// buffer the kernel fills (scratch); dq, dk and dv outputs of the inputs'
// type and shapes. strides: 24 element strides, (b, h, s) of q, k, v, o,
// do, dq, dk, dv in that order; each head dim must be unit-stride. In
// bf16 the strides of q, k, v and do must be positive multiples of 16
// bytes and their data 16-byte aligned (the TMA reads them), those of dq,
// dk and dv even; nsplit (a power of two dividing H / KVH) splits each
// group's heads over that many kv-tile blocks, whose f32 partials go to
// `scratch` (B * KVH * nsplit * Skv * (Dqk + Dv) floats; unused at
// nsplit 1). f32 ignores nsplit and scratch. (Dqk, Dv) is (32, 32), (64,
// 64), (80, 80), (128, 128) or (192, 128); Sq <= Skv; H a multiple of
// KVH. Launches on `stream` (bf16: delta, both tile passes in one grid,
// then the fold where nsplit > 1; f32: delta, dk/dv, dq) and returns
// cudaGetLastError() after them (0 on success), cudaErrorInvalidValue /
// cudaErrorMisalignedAddress for arguments it does not take, or
// cudaErrorNotSupported if the driver has no cuTensorMapEncodeTiled; it
// does not synchronise.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int bf16, int B, int H, int KVH, int Sq,
                                   int Skv, int Dqk, int Dv, int causal,
                                   int window, float scale, void* stream,
                                   const long long* strides, float* scratch,
                                   int nsplit) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Skv < Sq ||
      strides == nullptr)
    return (int)cudaErrorInvalidValue;
  if (bf16) {
    const int group = H / KVH;
    if (nsplit < 1 || group % nsplit != 0 || (nsplit & (nsplit - 1)) != 0 ||
        (nsplit > 1 && scratch == nullptr))
      return (int)cudaErrorInvalidValue;
    for (int i = 0; i < 24; ++i) {
      const int t = i / 3 * 3;                   // the tensor of stride i
      const bool tma = t == Q || t == K || t == V || t == DO;
      if (tma ? strides[i] <= 0 || strides[i] * 2 % 16
              : t != O && strides[i] % 2)
        return (int)cudaErrorInvalidValue;
    }
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
            15 ||
        (reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
         reinterpret_cast<uintptr_t>(dv) |
         reinterpret_cast<uintptr_t>(scratch)) & 3)
      return (int)cudaErrorMisalignedAddress;
    if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  } else {
    nsplit = 1;
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.scratch = scratch;
  a.B = B;
  a.H = H;
  a.KVH = KVH;
  a.Sq = Sq;
  a.Skv = Skv;
  a.Dv = Dv;
  a.group = H / KVH;
  a.causal = causal;
  a.window = window;
  a.nsplit = nsplit;
  a.kv_blocks = 0;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  for (int i = 0; i < 24; ++i) a.st[i] = strides[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dqk == 32 && Dv == 32) return launch_type<32, 32>(bf16, a, s);
  if (Dqk == 64 && Dv == 64) return launch_type<64, 64>(bf16, a, s);
  if (Dqk == 80 && Dv == 80) return launch_type<80, 80>(bf16, a, s);
  if (Dqk == 128 && Dv == 128) return launch_type<128, 128>(bf16, a, s);
  if (Dqk == 192 && Dv == 128) return launch_type<192, 128>(bf16, a, s);
  return (int)cudaErrorInvalidValue;
}
