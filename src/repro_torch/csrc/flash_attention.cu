// Causal or sliding-window GQA attention with an online softmax, for
// Hopper (sm_90a): bf16 on the tensor cores, f32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
// _flash_kernel, launched by flash_attention_pallas. On q (B, H, Sq, Dqk),
// k (B, KVH, Skv, Dqk) and v (B, KVH, Skv, Dv), query head h reading kv
// head h / (H / KVH), with the queries the last Sq of the Skv positions
// (q_offset = Skv - Sq), the output (B, H, Sq, Dv):
//   s    = (q . k) * scale, in f32 (scale 1 / sqrt(Dqk) by default)
//   s    = NEG_INF = -1e30 where masked: kv_pos > q_pos when causal, and
//          kv_pos <= q_pos - window when window > 0
//   o    = softmax(s) v, accumulated over kv tiles as the Pallas body does:
//          running (m, l, acc) in f32, acc / max(l, 1e-30), cast to q's type
//   lse  = m + log(max(l, 1e-30)), f32 (B, H, Sq): the row log-sum-exp the
//          plain-PyTorch backward recomputes the probabilities from.
// P . V is computed to f32 accuracy, as in the Pallas body (the reference
// model's jnp scan rounds p to v's type first). Departure: the Pallas
// kernel asserts that the blocks divide Sq and Skv; here a ragged tail is
// masked (rows past Sq are not written, kv rows past Skv get probability
// 0). (Dqk, Dv) instances: (32, 32), (64, 64), (80, 80) (zamba2-2.7b's
// attention blocks), (128, 128) and MLA's (192, 128)
// (deepseek-v2-lite-16b's prefill: nope 128 + rope 64 for q and k, 128
// for v), one template over both dims; the Pallas kernel takes one Dh,
// and the reference's MLA prefill runs its jnp scan.
//
// Both routes: the TPU kernel runs its grid in order on one core and
// carries (m, l, acc) in VMEM scratch from one kv block to the next. Here
// a thread block of 4 warps owns one (b, h, tile of BQ = 64 query rows)
// and loops over the kv tiles of BKV = 64 rows itself, so nothing carries
// between blocks and no atomics are needed. Causal kv tiles wholly after
// a query tile's last row, and window tiles wholly before its first row's
// window, are skipped: the first add p = exp(-1e30 - m) = 0, the second
// are wiped by the next valid tile's alpha = exp(-1e30 - m) = 0, so
// skipping them changes nothing.
//
// Bound on an H100 SXM: 2 * B * H * (unmasked scores) * (Dqk + Dv) FLOPs
// on B * (H + KVH) * S * (Dqk + Dv) elements read or written. At the
// TinyLlama path's shape (B 8, H 32, KVH 4, S 128, Dh 64, bf16, causal)
// that is 0.54 GFLOP and 9.6 MB: 0.55 us at the bf16 tensor rate, 2.9 us
// at 3.35 TB/s, so the bytes bound it; a block lives for 1-2 kv tiles at
// S = 128.
//
// bf16 route (flash_fwd_bf16). The first design ran both products as f32
// FMAs on the CUDA cores (~15 TFLOP/s reached), converted each element to
// f32 with a scalar load as it staged it, wrote transposed tiles at a
// 4-way bank conflict and overlapped nothing; its f32 tiles took 120 KB
// of shared memory at Dh 128, one block an SM. Now:
// - Q, K and V stay bf16 in shared memory, rows padded by 16 bytes so that
//   ldmatrix reads them without bank conflicts, loaded with 16-byte
//   cp.async (rows past Sq or Skv zero-filled). K/V tiles are double
//   buffered: tile t + 2 loads while tile t + 1 waits and tile t computes.
//   Shared memory: 46 KB at Dh 64, 55 KB at Dh 80 (rows of 88 elements,
//   176 bytes: 16-byte aligned, and 8 rows start on 8 distinct 4-bank
//   groups, so ldmatrix is conflict-free), 87 KB at Dh 128, 112 KB at
//   (Dqk 192, Dv 128) (Q and K rows of 400 bytes, V rows of 272), so two
//   blocks an SM at most there.
// - Warp w owns query rows 16w .. 16w + 15. Its Q fragments are loaded
//   once (ldmatrix) and held in registers for the whole kv loop. Dqk is a
//   whole number of MMA k-steps of 16 and Dv of pairs of n-tiles of 8
//   (Dh 80: 5 k-steps, 10 n-tiles), so every loop that pairs tiles stays
//   whole.
// - S = Q K^T on mma.sync.m16n8k16 bf16 -> f32: products of bf16 values
//   are exact in f32, so this is the Pallas body's f32 product up to
//   summation order. Scale and mask act on the accumulator fragments, and
//   only tiles that straddle the diagonal, the window edge or Skv mask.
// - The online softmax runs on the fragments (exp2 of log2-scaled scores);
//   a row's max is two xor shuffles within its quad, and (m, l, acc) stay
//   in f32 registers, l summed per thread and reduced once at the end.
// - P never goes to shared memory: the m16n8 C fragments of S are laid out
//   as the A operand of the next m16n8k16. To keep P . V at f32 accuracy,
//   P = P_hi + P_lo, both bf16, and two MMAs run against V (exact in
//   bf16); the dropped term is below 2^-16 |P|.
// - The output is normalised in registers, staged through the warp's own
//   rows of the Q tile (Dv <= Dqk, so its rows hold them) and written with
//   16-byte stores.
// wgmma is not used: at S = 128 a block sees 1-2 kv tiles of 64 rows,
// too little work a block to fill a warpgroup pipeline; mma.sync on the
// register-resident fragments keeps P out of shared memory.
//
// f32 route (flash_fwd_f32, the smoke configs' Dh 32; no PyTorch f32
// flash backend exists to beat): the Q tile is staged once, transposed, in
// shared memory; each kv tile is staged as K transposed and V as is
// (shared memory (2 Dqk + 64) x 68 + 64 Dv floats: 80 KB at Dh 80, 155 KB
// at (192, 128)). 128 threads hold the 64 x 64 score tile as 16 row
// groups x 8 column groups: a thread owns 4 rows and 8 columns, so each
// step over Dh reads three float4s from shared memory for 32 FMAs. P goes
// through shared memory to the P . V product, with acc in registers: a
// thread owns columns 32 jj + 4 tx .. + 3 of each run jj of 32 output
// columns, and where Dv is not a multiple of 32 (Dh 80: runs at 0, 32 and
// a last run of 16) the threads past the last run's width hold nothing
// there.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows a block holds
constexpr int BKV = 64;          // kv rows a tile stages
constexpr int THREADS = 128;     // 4 warps
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int MAX_GRID_Z = 65535;

// ------------------------------------------------------------ f32 route --

constexpr int LDT = 68;          // row stride (floats) of qT, kT and P

template <int DQK, int DV>
constexpr int smem_floats_f32() {
  return 2 * DQK * LDT + BKV * DV + BQ * LDT;
}

// Rows [row0, row0 + 64) of a (rows, DH) matrix into shared memory,
// transposed (t[d * LDT + r]) or as is (t[r * DH + d]); rows at or past
// `rows` read 0. Neighbouring threads read neighbouring elements.
template <bool TRANSPOSE, int DH>
__device__ __forceinline__ void stage(const float* __restrict__ src, int row0,
                                      int rows, float* __restrict__ t) {
  for (int idx = threadIdx.x; idx < 64 * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH;
    const int row = row0 + r;
    const float x = row < rows ? src[(int64_t)row * DH + d] : 0.f;
    t[TRANSPOSE ? d * LDT + r : r * DH + d] = x;
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int H, int KVH, int Sq, int Skv,
              int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // [DQK][LDT]
  float* kT = qT + DQK * LDT;                     // [DQK][LDT]
  float* vs = kT + DQK * LDT;                     // [BKV][DV]
  float* ps = vs + BKV * DV;                      // [BQ][LDT]
  constexpr int DJ = (DV + 31) / 32;              // output runs of 4 a thread holds

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int64_t bh = (int64_t)b * H + h;
  const float* qb = q + bh * Sq * DQK;
  const float* kb = k + ((int64_t)b * KVH + kvh) * Skv * DQK;
  const float* vb = v + ((int64_t)b * KVH + kvh) * Skv * DV;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int q_offset = Skv - Sq;
  // whether run jj's four columns exist (only a last, partial run of a
  // Dv that is not a multiple of 32 leaves some threads out)
  auto run_ok = [tx](int jj) { return 32 * jj + tx * 4 < DV; };

  stage<true, DQK>(qb, q0, Sq, qT);

  float m[4], l[4], acc[4][DJ][4];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    qpos[i] = q_offset + q0 + ty * 4 + i;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;
  }

  // the kv range any real row of this tile can see, in whole tiles
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? q_offset + last_row + 1 : Skv;
  int kv_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  kv_begin = (kv_begin / BKV) * BKV;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();               // the last tile's kT, vs and ps are read
    stage<true, DQK>(kb, kv0, Skv, kT);
    stage<false, DV>(vb, kv0, Skv, vs);
    __syncthreads();

    // scores: rows ty*4 + i, columns 32*(j/4) + tx*4 + j%4 of the tile
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DQK; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qT + d * LDT + ty * 4);
      const float4 k0 = *reinterpret_cast<const float4*>(kT + d * LDT + tx * 4);
      const float4 k1 =
          *reinterpret_cast<const float4*>(kT + d * LDT + 32 + tx * 4);
      const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kc[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

    // mask, then the online softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = kv0 + 32 * (j >> 2) + tx * 4 + (j & 3);
        bool ok = true;
        if (causal) ok = ok && c <= qpos[i];
        if (window > 0) ok = ok && c > qpos[i] - window;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = kv0 + 32 * (j >> 2) + tx * 4 + (j & 3);
        s[i][j] = c < Skv ? expf(s[i][j] - m_new) : 0.f;   // ragged tail
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] *= alpha;
      float* prow = ps + (ty * 4 + i) * LDT + tx * 4;
      *reinterpret_cast<float4*>(prow) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(prow + 32) =
          make_float4(s[i][4], s[i][5], s[i][6], s[i][7]);
    }
    __syncthreads();

    // acc += P . V over the tile's kv rows, four at a time
#pragma unroll 2
    for (int c = 0; c < BKV; c += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * LDT + c);
        pr[i][0] = p4.x; pr[i][1] = p4.y; pr[i][2] = p4.z; pr[i][3] = p4.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          if (!run_ok(jj)) continue;
          const float4 v4 = *reinterpret_cast<const float4*>(
              vs + (c + cc) * DV + 32 * jj + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][jj][0] = fmaf(pr[i][cc], v4.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(pr[i][cc], v4.y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(pr[i][cc], v4.z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(pr[i][cc], v4.w, acc[i][jj][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + (bh * Sq + row) * DV;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      if (!run_ok(jj)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[32 * jj + tx * 4 + e] = acc[i][jj][e] / den;
    }
    if (tx == 0) lse[bh * Sq + row] = m[i] + logf(den);
  }
}

// ----------------------------------------------------------- bf16 route --

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as two bf16 in one register, x0 in the low half; `lo` gets the
// rounding residual, also as bf16: x = hi + lo to within 2^-16 |x|
__device__ __forceinline__ uint32_t split_bf16x2(float x0, float x1,
                                                 uint32_t* lo) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 re = __floats2bfloat162_rn(x0 - __low2float(hi),
                                                  x1 - __high2float(hi));
  *lo = *reinterpret_cast<const uint32_t*>(&re);
  return *reinterpret_cast<const uint32_t*>(&hi);
}

// padded row stride, in elements, of a staged bf16 tile
template <int DH>
__host__ __device__ constexpr int bf16_ld() { return DH + 8; }

template <int DQK, int DV>
constexpr int smem_bytes_bf16() {   // Q, 2 x K, 2 x V
  return (3 * bf16_ld<DQK>() + 2 * bf16_ld<DV>()) * 64 * (int)sizeof(bf16);
}

// Rows [row0, row0 + 64) of a (rows, DH) bf16 matrix into shared memory
// at a row stride of bf16_ld<DH>(), 16 bytes a copy; rows past `rows`
// are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src,
                                          int row0, int rows, bf16* dst) {
  constexpr int CPR = DH / 8;                  // 16-byte copies a row
  constexpr int LD = bf16_ld<DH>();
#pragma unroll
  for (int c = threadIdx.x; c < 64 * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const int row = row0 + r;
    const bool ok = row < rows;
    cp_async16(smem_u32(dst + r * LD + col),
               src + (int64_t)(ok ? row : 0) * DH + col, ok);
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int H, int KVH, int Sq, int Skv,
               int causal, int window, float scale_log2) {
  static_assert(DV <= DQK, "the output is staged in the Q tile's rows");
  static_assert(DQK % 16 == 0 && DV % 16 == 0,
                "whole MMA k-steps of Q K^T and pairs of P V n-tiles");
  constexpr int LD = bf16_ld<DQK>();           // Q and K rows
  constexpr int LDV = bf16_ld<DV>();           // V rows
  constexpr int TILE = 64 * LD;
  constexpr int TILEV = 64 * LDV;
  constexpr int NT = DV / 8;                   // output n-tiles of 8 columns
  extern __shared__ uint4 smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* ks = qs + TILE;                          // [2][64][LD]
  bf16* vs = ks + 2 * TILE;                      // [2][64][LDV]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int64_t bh = (int64_t)b * H + h;
  const bf16* qb = q + bh * Sq * DQK;
  const bf16* kb = k + ((int64_t)b * KVH + kvh) * Skv * DQK;
  const bf16* vb = v + ((int64_t)b * KVH + kvh) * Skv * DV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;     // fragment row, column pair
  const int q_offset = Skv - Sq;

  // the kv range any real row of this tile can see, in whole tiles
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? q_offset + last_row + 1 : Skv;
  int kv_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  kv_begin = (kv_begin / BKV) * BKV;
  const int n_tiles = (kv_end - kv_begin + BKV - 1) / BKV;

  // group 0: Q and kv tile 0; group 1: kv tile 1 (empty if none)
  load_tile<DQK>(qb, q0, Sq, qs);
  load_tile<DQK>(kb, kv_begin, Skv, ks);
  load_tile<DV>(vb, kv_begin, Skv, vs);
  cp_async_commit();
  if (n_tiles > 1) {
    load_tile<DQK>(kb, kv_begin + BKV, Skv, ks + TILE);
    load_tile<DV>(vb, kv_begin + BKV, Skv, vs + TILEV);
  }
  cp_async_commit();

  // rows g and g + 8 of the warp's 16; m in log2 units
  const int qpos0 = q_offset + q0 + warp * 16 + g, qpos1 = qpos0 + 8;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[DQK / 16][4];

  // ldmatrix.x4 lane addressing: the A operand (16 rows x 16) and, for K,
  // two n-tiles of the B operand (8 rows x 16 each)
  const int a_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int a_col = (lane >> 4) << 3;
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_col = ((lane >> 3) & 1) << 3;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = kv_begin + t * BKV;
    const bf16* kt = ks + (t & 1) * TILE;
    const bf16* vt = vs + (t & 1) * TILEV;
    cp_async_wait<1>();            // tile t has landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        ldmatrix_x4(qf[kk], smem_u32(qs + (warp * 16 + a_row) * LD +
                                     kk * 16 + a_col));
    }

    // S = Q K^T: 8 n-tiles of 8 kv columns
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_u32(kt + (j * 8 + k_row) * LD + kk * 16 + k_col));
        mma_bf16(s[j], qf[kk], kf[0], kf[1]);
        mma_bf16(s[j + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale (to log2 units) and mask; only tiles across the diagonal, the
    // window's edge or Skv need the mask
    const bool need_mask =
        (causal && kv0 + BKV - 1 > q_offset + q0) ||
        (window > 0 && kv0 <= q_offset + q0 + BQ - 1 - window) ||
        kv0 + BKV > Skv;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (need_mask) {
          const int c = kv0 + j * 8 + tig * 2 + (e & 1);
          const int qp = e < 2 ? qpos0 : qpos1;
          bool ok = c < Skv;
          if (causal) ok = ok && c <= qp;
          if (window > 0) ok = ok && c > qp - window;
          x = ok ? x : NEG_INF;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[j][e] - m_r[e >> 1]);
        if (need_mask && kv0 + j * 8 + tig * 2 + (e & 1) >= Skv)
          p = 0.f;                                       // ragged tail
        s[j][e] = p;
        l_r[e >> 1] += p;
      }

    // acc += P . V, P from the S fragments as P_hi + P_lo
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t ph[4], pl[4];
      ph[0] = split_bf16x2(s[2 * kk][0], s[2 * kk][1], &pl[0]);
      ph[1] = split_bf16x2(s[2 * kk][2], s[2 * kk][3], &pl[1]);
      ph[2] = split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], &pl[2]);
      ph[3] = split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], &pl[3]);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_u32(vt + (kk * 16 + a_row) * LDV + j * 8 +
                                       a_col));
        mma_bf16(acc[j], ph, vf[0], vf[1]);
        mma_bf16(acc[j + 1], ph, vf[2], vf[3]);
        mma_bf16(acc[j], pl, vf[0], vf[1]);
        mma_bf16(acc[j + 1], pl, vf[2], vf[3]);
      }
    }

    __syncthreads();               // every warp is done with buffer t & 1
    if (t + 2 < n_tiles) {
      load_tile<DQK>(kb, kv0 + 2 * BKV, Skv, ks + (t & 1) * TILE);
      load_tile<DV>(vb, kv0 + 2 * BKV, Skv, vs + (t & 1) * TILEV);
    }
    cp_async_commit();
  }

  // normalise; stage the warp's 16 rows in its own rows of the Q tile (only
  // this warp read them) and write them with 16-byte stores
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    den[r] = fmaxf(l_r[r], 1e-30f);
  }
  bf16* os = qs + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(os + g * LD + j * 8 + tig * 2) =
        __floats2bfloat162_rn(acc[j][0] / den[0], acc[j][1] / den[0]);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * LD + j * 8 + tig * 2) =
        __floats2bfloat162_rn(acc[j][2] / den[1], acc[j][3] / den[1]);
  }
  __syncwarp();
  bf16* ob = o + bh * Sq * DV;
#pragma unroll
  for (int c = lane; c < 16 * (DV / 8); c += 32) {
    const int r = c / (DV / 8), col = (c % (DV / 8)) * 8;
    const int row = q0 + warp * 16 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(ob + (int64_t)row * DV + col) =
          *reinterpret_cast<const uint4*>(os + r * LD + col);
  }
  if (tig == 0) {
    const int row = q0 + warp * 16 + g;
    if (row < Sq) lse[bh * Sq + row] = m_r[0] * LN2 + logf(den[0]);
    if (row + 8 < Sq) lse[bh * Sq + row + 8] = m_r[1] * LN2 + logf(den[1]);
  }
}

// ------------------------------------------------------------- launches --

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bf16_in, int B, int H, int KVH, int Sq, int Skv, int causal,
           int window, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  if (bf16_in) {
    const int bytes = smem_bytes_bf16<DQK, DV>();
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    flash_fwd_bf16<DQK, DV><<<grid, THREADS, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, KVH, Sq,
        Skv, causal, window, scale * LOG2E);
  } else {
    const int bytes = smem_floats_f32<DQK, DV>() * (int)sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    flash_fwd_f32<DQK, DV><<<grid, THREADS, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, H, KVH, Sq,
        Skv, causal, window, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, Dh), k (B, KVH, Skv, Dh), v (B, KVH, Skv, Dv), o (B, H, Sq,
// Dv), all contiguous and of one type (bf16 != 0: __nv_bfloat16, 16-byte
// aligned; else float); lse (B, H, Sq) f32. (Dh, Dv) is (32, 32), (64,
// 64), (80, 80), (128, 128) or (192, 128); Sq <= Skv; H a multiple of
// KVH; B <= 65535. Launches on `stream` and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a shape it does not take;
// it does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int bf16, int B, int H, int KVH, int Sq,
                                   int Skv, int Dh, int Dv, int causal,
                                   int window, float scale, void* stream) {
  if (B <= 0 || B > MAX_GRID_Z || H <= 0 || KVH <= 0 || H % KVH != 0 ||
      Sq <= 0 || Skv < Sq)
    return (int)cudaErrorInvalidValue;
  if (bf16 && ((reinterpret_cast<uintptr_t>(q) |
                reinterpret_cast<uintptr_t>(k) |
                reinterpret_cast<uintptr_t>(v) |
                reinterpret_cast<uintptr_t>(o)) & 15))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 32 && Dv == 32)
    return launch<32, 32>(q, k, v, o, lse, bf16, B, H, KVH, Sq, Skv, causal,
                          window, scale, s);
  if (Dh == 64 && Dv == 64)
    return launch<64, 64>(q, k, v, o, lse, bf16, B, H, KVH, Sq, Skv, causal,
                          window, scale, s);
  if (Dh == 80 && Dv == 80)
    return launch<80, 80>(q, k, v, o, lse, bf16, B, H, KVH, Sq, Skv, causal,
                          window, scale, s);
  if (Dh == 128 && Dv == 128)
    return launch<128, 128>(q, k, v, o, lse, bf16, B, H, KVH, Sq, Skv,
                            causal, window, scale, s);
  if (Dh == 192 && Dv == 128)
    return launch<192, 128>(q, k, v, o, lse, bf16, B, H, KVH, Sq, Skv,
                            causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
