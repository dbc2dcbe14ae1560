// The gradient of causal or sliding-window GQA attention, recomputed from
// the row log-sum-exp the forward saved: three kernels for Hopper
// (sm_90a), in bf16 and in f32, on the CUDA cores.
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
// positions (q_offset = Skv - Sq), all in f32:
//   delta = rowsum(do * o)                            (flash_bwd_delta)
//   p     = exp(q . k * scale - lse), 0 where masked  (recomputed)
//   dv    = p^T do,  dp = do v^T,  ds = p (dp - delta) scale
//   dk    = ds^T q, summed over the query heads of each kv head's group
//   dq    = ds k
// The mask is the forward's: kv_pos > q_pos when causal, and kv_pos <=
// q_pos - window when window > 0, masked.
//
// The design. Deterministic, no atomics: each output element is summed
// by one thread in a fixed order.
// - flash_bwd_delta: one warp a row, a fixed shuffle tree.
// - flash_bwd_dkdv: one block a (b, kv head, tile of BN = 64 kv rows).
//   K and V of the tile stay in shared memory; the block walks the query
//   heads of the group and, for each, the 64-row query tiles that see the
//   tile (masked tiles skipped as the forward skips them), recomputing
//   S and dP for the tile pair, and sums dK and dV in registers.
// - flash_bwd_dq: one block a (b, head, tile of BM = 64 query rows),
//   walking the kv tiles the query tile sees, recomputing S and dP, and
//   summing dQ in registers.
// So S and dP are computed twice (seven products where the gradient
// needs five); nothing larger than a 64 x 64 tile is ever held. Every
// product runs on the CUDA cores in f32 from operands staged in shared
// memory as f32 (bf16 widened when loaded), in 4 x 4 (or 4 x D/16)
// register tiles of a 16 x 16 thread grid; rows are padded so that no
// warp's reads conflict on a bank. The grid is launched heaviest tiles
// first (causal: low kv tiles for dK/dV, high query tiles for dQ).
//
// What bounds it. The five products, 2 * 64 * 64 * (3 Dqk + 2 Dv)
// operations a visited tile pair and head, against q, k, v, o, do, lse
// read and dq, dk, dv written: at the token path's (B 8, H 32, KVH 4, S
// 128, Dh 64, bf16, causal) the bytes (~5.7 us at 3.35 TB/s) outweigh the
// operations at the bf16 tensor rate (~2 us); this kernel runs them on
// the CUDA cores instead, a simple first version (PERF.md has its times).
//
// Shared memory (f32, one layout for both tile kernels): K and V (64 rows
// each), Q and dO (64 rows each), P and dS (64 x 80), lse and delta: 206
// KB at (192, 128), 108 KB at (64, 64).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;             // query rows a tile
constexpr int BN = 64;             // kv rows a tile
constexpr int THREADS = 256;       // a 16 x 16 grid of threads
constexpr int LP = BN + 16;        // row stride of P and dS in shared memory
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

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
// along (b, h, s), in the order q, k, v, o, do, dq, dk, dv.
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
  int B, H, KVH, Sq, Skv, Dv, group, causal, window;
  float scale, scale_log2;
  long long st[24];
};

enum { Q = 0, K = 3, V = 6, O = 9, DO = 12, DQ = 15, DK = 18, DV_ = 21 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

// ------------------------------------------------------------- kernels --

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

template <int DQK, int DV, typename T>
int launch(const Args& a, cudaStream_t stream) {
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
  cudaError_t e = opt_in(flash_bwd_dkdv<DQK, DV, T>, L::SMEM, &opted_dkdv);
  if (e != cudaSuccess) return (int)e;
  e = opt_in(flash_bwd_dq<DQK, DV, T>, L::SMEM, &opted_dq);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_delta<T><<<(unsigned)rows_blocks, THREADS, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv<DQK, DV, T>
      <<<(unsigned)kv_blocks, THREADS, L::SMEM, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq<DQK, DV, T>
      <<<(unsigned)q_blocks, THREADS, L::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_type(int bf16_in, const Args& a, cudaStream_t s) {
  return bf16_in ? launch<DQK, DV, bf16>(a, s) : launch<DQK, DV, float>(a, s);
}

}  // namespace

// q (B, H, Sq, Dqk), k (B, KVH, Skv, Dqk), v (B, KVH, Skv, Dv), o and do
// (B, H, Sq, Dv) of one type (bf16 != 0: __nv_bfloat16, else float), lse
// a contiguous (B, H, Sq) f32 tensor; delta a contiguous (B, H, Sq) f32
// buffer the kernel fills (scratch); dq, dk and dv outputs of the inputs'
// type and shapes. strides: 24 element strides, (b, h, s) of q, k, v, o,
// do, dq, dk, dv in that order; each head dim must be unit-stride. (Dqk,
// Dv) is (32, 32), (64, 64), (80, 80), (128, 128) or (192, 128); Sq <=
// Skv; H a multiple of KVH. Launches three kernels on `stream` (delta,
// then dk/dv, then dq) and returns cudaGetLastError() after them (0 on
// success), or cudaErrorInvalidValue for arguments it does not take; it
// does not synchronise.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int bf16, int B, int H, int KVH, int Sq,
                                   int Skv, int Dqk, int Dv, int causal,
                                   int window, float scale, void* stream,
                                   const long long* strides) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Skv < Sq ||
      strides == nullptr)
    return (int)cudaErrorInvalidValue;
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
  a.B = B;
  a.H = H;
  a.KVH = KVH;
  a.Sq = Sq;
  a.Skv = Skv;
  a.Dv = Dv;
  a.group = H / KVH;
  a.causal = causal;
  a.window = window;
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
