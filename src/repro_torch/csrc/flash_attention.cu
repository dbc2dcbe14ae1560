// Causal or sliding-window GQA attention with an online softmax, f32 or
// bf16 in, f32 arithmetic, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
// _flash_kernel, launched by flash_attention_pallas. On q (B, H, Sq, Dh)
// and k, v (B, KVH, Skv, Dh), query head h reading kv head h / (H / KVH),
// with the queries the last Sq of the Skv positions (q_offset = Skv - Sq):
//   s    = (q . k) * scale, in f32 (scale 1 / sqrt(Dh) by default)
//   s    = NEG_INF = -1e30 where masked: kv_pos > q_pos when causal, and
//          kv_pos <= q_pos - window when window > 0
//   o    = softmax(s) v, accumulated over kv tiles as the Pallas body does:
//          running (m, l, acc) in f32, acc / max(l, 1e-30), cast to q's type
//   lse  = m + log(max(l, 1e-30)), f32 (B, H, Sq): the row log-sum-exp the
//          plain-PyTorch backward recomputes the probabilities from.
// P . V is computed in f32, as in the Pallas body (the reference model's
// jnp scan rounds p to v's type first). Departure: the Pallas kernel
// asserts that the blocks divide Sq and Skv; here a ragged tail is masked
// (rows past Sq are not written, kv rows past Skv get probability 0).
//
// Design. The TPU kernel runs its grid in order on one core and carries
// (m, l, acc) in VMEM scratch from one kv block to the next. Here a
// thread block owns one (b, h, tile of BQ = 64 query rows) and loops over
// the kv tiles itself, so nothing carries between blocks and no atomics
// are needed. The Q tile is staged once, transposed, in shared memory;
// each kv tile of BKV = 64 rows is staged as K transposed and V as is, all
// converted to f32. 128 threads hold the 64 x 64 score tile as 16 row
// groups x 8 column groups: a thread owns 4 rows and 8 columns (two runs
// of 4), so each step over Dh reads three float4s from shared memory for
// 32 FMAs. The 8 threads of a row group are 8 neighbouring lanes, so the
// row max and the row sum are three xor shuffles. P goes through shared
// memory to the P . V product, where a thread owns the same 4 rows and
// Dh / 8 output columns (runs of 4, 32 apart), with acc in registers.
// Causal kv tiles wholly after a query tile's last row, and window tiles
// wholly before its first row's window, are skipped: the first add
// p = exp(-1e30 - m) = 0, the second are wiped by the next valid tile's
// alpha = exp(-1e30 - m) = 0, so skipping them changes nothing.
//
// Bound on an H100 SXM: the work is 4 * B * H * (unmasked scores) * Dh
// FLOPs on 2 * B * (H + KVH) * S * Dh elements read or written. At the
// TinyLlama path's shape (B 16, H 32, KVH 4, S 128, Dh 64, bf16, causal)
// that is 1.08 GFLOP and 18.9 MB: 1.1 us at the bf16 tensor rate, 5.6 us
// at 3.35 TB/s, so the bytes bound it. This first kernel uses no tensor
// cores (f32 FMAs on the CUDA cores, 67 TFLOP/s at most), so it sits far
// from that bound; mma/wgmma, a register-resident P and TMA staging are
// the later speed work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows a block holds
constexpr int BKV = 64;          // kv rows a tile stages
constexpr int THREADS = 128;     // 16 row groups x 8 column groups
constexpr int LDT = 68;          // row stride (floats) of qT, kT and P
constexpr float NEG_INF = -1e30f;
constexpr int MAX_GRID_Z = 65535;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DH>
constexpr int smem_floats() { return 2 * DH * LDT + BKV * DH + BQ * LDT; }

// Rows [row0, row0 + 64) of a (rows, DH) matrix into f32 shared memory,
// transposed (t[d * LDT + r]) or as is (t[r * DH + d]); rows at or past
// `rows` read 0. Neighbouring threads read neighbouring elements.
template <bool TRANSPOSE, typename T, int DH>
__device__ __forceinline__ void stage(const T* __restrict__ src, int row0,
                                      int rows, float* __restrict__ t) {
  for (int idx = threadIdx.x; idx < 64 * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH;
    const int row = row0 + r;
    const float x = row < rows ? to_f32(src[(int64_t)row * DH + d]) : 0.f;
    t[TRANSPOSE ? d * LDT + r : r * DH + d] = x;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int H, int KVH, int Sq, int Skv,
          int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // [DH][LDT]
  float* kT = qT + DH * LDT;                      // [DH][LDT]
  float* vs = kT + DH * LDT;                      // [BKV][DH]
  float* ps = vs + BKV * DH;                      // [BQ][LDT]
  constexpr int DJ = DH / 32;                     // output runs of 4 a thread holds

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int64_t bh = (int64_t)b * H + h;
  const T* qb = q + bh * Sq * DH;
  const T* kb = k + ((int64_t)b * KVH + kvh) * Skv * DH;
  const T* vb = v + ((int64_t)b * KVH + kvh) * Skv * DH;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int q_offset = Skv - Sq;

  stage<true, T, DH>(qb, q0, Sq, qT);

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
    stage<true, T, DH>(kb, kv0, Skv, kT);
    stage<false, T, DH>(vb, kv0, Skv, vs);
    __syncthreads();

    // scores: rows ty*4 + i, columns 32*(j/4) + tx*4 + j%4 of the tile
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
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
          const float4 v4 = *reinterpret_cast<const float4*>(
              vs + (c + cc) * DH + 32 * jj + tx * 4);
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
    T* orow = o + (bh * Sq + row) * DH;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(orow + 32 * jj + tx * 4 + e, acc[i][jj][e] / den);
    if (tx == 0) lse[bh * Sq + row] = m[i] + logf(den);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KVH, int Sq, int Skv, int causal, int window,
           float scale, cudaStream_t stream) {
  const int bytes = smem_floats<DH>() * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, DH><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, KVH, Sq, Skv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int H, int KVH, int Sq, int Skv, int Dh,
             int causal, int window, float scale, cudaStream_t stream) {
  switch (Dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal,
                           window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal,
                           window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, KVH, Sq, Skv, causal,
                            window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, Dh), k and v (B, KVH, Skv, Dh), o like q, all contiguous
// and of one type (bf16 != 0: __nv_bfloat16, else float); lse (B, H, Sq)
// f32. Dh is 32, 64 or 128; Sq <= Skv; H a multiple of KVH; B <= 65535.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape it does not take; it does not
// synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int bf16, int B, int H, int KVH, int Sq,
                                   int Skv, int Dh, int causal, int window,
                                   float scale, void* stream) {
  if (B <= 0 || B > MAX_GRID_Z || H <= 0 || KVH <= 0 || H % KVH != 0 ||
      Sq <= 0 || Skv < Sq)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, B, H, KVH, Sq, Skv,
                                        Dh, causal, window, scale, s)
              : dispatch<float>(q, k, v, o, lse, B, H, KVH, Sq, Skv, Dh,
                                causal, window, scale, s);
}
