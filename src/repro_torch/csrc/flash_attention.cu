// Causal or sliding-window GQA attention with an online softmax, for
// Hopper (sm_90a), on wgmma fed by a TMA ring, in bf16 and in f32.
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
// Both products are computed to f32 accuracy, as in the Pallas body. The
// Pallas kernel asserts that its blocks divide Sq and Skv; here a ragged
// tail is masked. (Dqk, Dv) instances: (32, 32), (64, 64), (80, 80)
// (zamba2-2.7b), (128, 128) and MLA's (192, 128) (deepseek-v2-lite-16b's
// prefill), one template over both dims and both types.
//
// What bounds it. 2 * B * H * (unmasked scores) * (Dqk + Dv) FLOPs on
// B * (H + KVH) * S * (Dqk + Dv) elements read or written: at the token
// path's (B 8, H 32, KVH 4, S 128, Dh 64, bf16, causal) 0.55 us at the
// bf16 tensor rate against 2.9 us at 3.35 TB/s, so the bytes; past a few
// hundred positions the operations (at 32768 positions, 99% of the time
// at the data sheet's rates). The work a block does is small at the short
// shapes of the training paths (1-6 kv tiles), so what decides the time
// there is how soon every SM is busy and how little of a block's life is
// spent waiting: on loads, on its own softmax, on the slowest block.
//
// The design.
// - One block is a tile of BM = 64 query rows: one consumer warpgroup
//   (warps 0-3) and one producer warp (warp 4). The rows are (position,
//   head) pairs of the P = gcd(H / KVH, 64) query heads that read one kv
//   head, position-major: 64 / P positions x P heads. So one staged K/V
//   tile serves the whole group, and a few queries over a long cache still
//   fill a tile. Each row's causal and window mask comes from its own
//   position; the block's kv range is the union of its rows' ranges, from
//   its first row's window start to its last row's causal end, and no kv
//   tile outside it is visited.
// - The producer's one thread loads Q once and K and V tile by tile with
//   cp.async.bulk.tensor into a ring of NS = 2 stages, K and V with full
//   and empty mbarriers each, so S of the next tile waits only on K.
//   Tensor maps (built on the host per call, through the driver entry
//   point, so the library does not link libcuda) carry the operands' real
//   strides: a (B, S, H, Dh) tensor viewed as (B, H, S, Dh) loads in place.
//   Each map swizzles its rows at the widest of 128, 64 or 32 bytes that
//   divides them; a row wider than that is loaded as several boxes (Dh 80
//   in bf16: five of 32 bytes). Rows past Sq or Skv land as zeros.
// - S = Q K^T is one wgmma chain (m64 x BKV, k16 steps) from shared
//   memory; the online softmax runs on its accumulator registers (a row's
//   max over its quad of threads, one FFMA and one ex2 a score); P never
//   leaves the registers: as P_hi + P_lo, two bf16 terms, it is the A
//   operand of the P V chain against V in shared memory (MN-major, so
//   transposed by the descriptor). One P term alone would miss f32
//   accuracy by 2^-9 |P|; the dropped residual is below 2^-18 |P|. Each
//   chain adds its smaller term first: an MMA truncates its sum, so a
//   small term added to a large running sum loses more.
// - Inside the warpgroup, tile t + 1's S chain is issued with tile t's
//   P V chain, and tile t + 1's softmax runs on the CUDA cores while the
//   P V chain runs on the tensor cores. Keeping tile t + 2's S chain in
//   flight during that softmax takes a second S accumulator; with P_hi
//   and P_lo already held, every bf16 instance then spills 192-412 bytes
//   and ran 1.25-2.0x slower (PERF.md).
// - Blocks are launched heaviest first: the query tiles in reverse, so
//   causal tiles with the most kv tiles start in the first wave and the
//   light ones fill the ragged end.
// - The output is written from the registers into a (B, Sq, H, Dv) buffer,
//   the layout the model reads next; the wrapper returns its (B, H, Sq, Dv)
//   view.
//
// The f32 route runs on the same pipeline, on the tensor cores. With h()
// TF32 rounding (cvt.rna) and b() bf16 rounding:
//   q . k = b(q - h(q)) . b(k) + b(q) . b(k - h(k))    [bf16 wgmma]
//           + h(q) . h(k)                              [TF32 wgmma]
//           (r(q) . r(k), ~2^-22 |q||k|, dropped)
//   P V   = P_lo V2 + P_lo V1 + P_hi V3 + P_hi V2 + P_hi V1   [bf16 wgmma]
//           with v = V1 + V2 + V3, three bf16 terms (2^-27 |v|): two terms
//           of V would leave 2^-18 |v|, ~1.5e-5 at |v| = 4, in a row that
//           attends to one key. TF32 wgmma takes B K-major only, and V is
//           MN-major here, so P V stays on bf16 terms.
// The consumer warpgroup rounds each landed Q and K tile to TF32 in place
// and writes its two bf16 terms beside it, and writes V's three terms.
// Shared memory a row element: Q and K 8 bytes (TF32 + two bf16), V 4
// bytes landed + 6 of terms. At (192, 128), the tight case, that is 224 KB
// with BKV = 32 kv rows a tile: Q 96 KB, rings of 2 x 24 (K) and 2 x 16
// (V) KB, and 24 + 24 KB of K and V terms; BKV = 64 below Dqk 128.
#include "hopper.cuh"   // TMA, mbarriers, wgmma, tensor maps (shared)

namespace {

constexpr int BM = 64;           // query rows a block: one warpgroup's M
constexpr int THREADS = 160;     // the consumer warpgroup and the producer warp
constexpr int NS = 2;            // stages of the K and V rings
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DQK, int DV, bool F32>
struct Cfg {
  using QK = Rows<DQK, F32 ? 4 : 2>;           // Q and K as they land
  using V = Rows<DV, F32 ? 4 : 2>;             // V as it lands
  using QK2 = Rows<DQK, 2>;                    // bf16 terms of Q and K (f32)
  using V2 = Rows<DV, 2>;                      // bf16 V terms (f32)
  static constexpr int BKV = F32 && DQK >= 128 ? 32 : 64;
  static constexpr int Q_BYTES = BM * QK::BYTES;
  static constexpr int K_BYTES = BKV * QK::BYTES;
  static constexpr int V_BYTES = BKV * V::BYTES;
  static constexpr int Q2_BYTES = F32 ? BM * QK2::BYTES : 0;
  static constexpr int K2_BYTES = F32 ? BKV * QK2::BYTES : 0;
  static constexpr int V2_BYTES = F32 ? BKV * V2::BYTES : 0;
  static constexpr int OFF_K = Q_BYTES;                       // NS slots
  static constexpr int OFF_V = OFF_K + NS * K_BYTES;          // NS slots
  static constexpr int OFF_Q2 = OFF_V + NS * V_BYTES;         // qr, qb
  static constexpr int OFF_K2 = OFF_Q2 + 2 * Q2_BYTES;        // kr, kb
  static constexpr int OFF_V2 = OFF_K2 + 2 * K2_BYTES;        // v1, v2, v3
  static constexpr int OFF_BAR = OFF_V2 + 3 * V2_BYTES;
  // barriers: full Q, then full K, empty K, full V, empty V (NS each);
  // 1024 bytes of slack to align the base for the 128-byte swizzle
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 4 * NS) + 1024;
  static constexpr int MIN_BLOCKS = F32 ? 1 : (DQK <= 64 ? 3 : 2);
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// ------------------------------------------------------ the f32 splits --

// An f32 V tile of R rows as three bf16 terms (layout Rows<D, 2>): v1 =
// b(v), v2 = b(v - v1), v3 = b(v - v1 - v2), their sum v to 2^-27 |v|.
template <int D, int R>
__device__ __forceinline__ void split_v(const uint8_t* f, uint8_t* v1,
                                        uint8_t* v2, uint8_t* v3) {
  using F = Rows<D, 4>;
  using T = Rows<D, 2>;
  for (int c = threadIdx.x; c < R * D / 4; c += 128) {
    const int r = c / (D / 4), col = c % (D / 4) * 4;
    const float4 x = *reinterpret_cast<const float4*>(f + at<F, R>(r, col));
    const uint32_t o = at<T, R>(r, col);
    float e[4] = {x.x, x.y, x.z, x.w};
    uint8_t* dst[3] = {v1, v2, v3};
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(e[0], e[1]);
      const __nv_bfloat162 b = __floats2bfloat162_rn(e[2], e[3]);
      *reinterpret_cast<uint2*>(dst[t] + o) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                     *reinterpret_cast<const uint32_t*>(&b));
      e[0] -= __low2float(a);
      e[1] -= __high2float(a);
      e[2] -= __low2float(b);
      e[3] -= __high2float(b);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {   // 2^x, 2^-22 relative
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one kv tile on the S accumulator: thread (g, tig)
// of warp w holds rows 16 w + g (s[4 j], s[4 j + 1]) and 16 w + g + 8
// (s[4 j + 2], s[4 j + 3]), columns 8 j + 2 tig and + 1. Masks (each row
// its own [lo, hi) of kv positions), takes each row's max of the raw
// scores, and leaves the numerators 2^(s scale_log2 - m) in s (one FFMA
// and one ex2 a score), the running max m (log2 units), the running sum l
// (this thread's columns) and the rescale alpha of the rows' earlier
// terms.
template <int BKV>
__device__ __forceinline__ void online_softmax(
    float (&s)[BKV / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int kv0, bool need_mask, const int (&lo)[2], const int (&hi)[2], int tig,
    float scale_log2) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (need_mask) {
        const int c = kv0 + 8 * j + 2 * tig + (e & 1);
        const int i = e >> 1;
        if (!(c >= lo[i] && c < hi[i])) s[4 * j + e] = NEG_INF;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * scale_log2);
    alpha[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * j + e], scale_log2, -m[e >> 1]));
      s[4 * j + e] = p;
      l[e >> 1] += p;
    }
}

// ------------------------------------------------------------- kernel --

template <int DQK, int DV, bool F32>
__global__ void __launch_bounds__(THREADS, (Cfg<DQK, DV, F32>::MIN_BLOCKS))
flash_fwd(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, void* __restrict__ o,
          float* __restrict__ lse, int B, int H, int KVH, int Sq, int Skv,
          int log2p, int causal, int window, float scale_log2) {
  using C = Cfg<DQK, DV, F32>;
  using QK = typename C::QK;
  using QK2 = typename C::QK2;
  using VL = typename C::V;
  using V2 = typename C::V2;
  constexpr int BKV = C::BKV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_q = smem_u32(smem), s_k = s_q + C::OFF_K,
                 s_v = s_q + C::OFF_V;
  const uint32_t full_q = s_q + C::OFF_BAR, full_k = full_q + 8,
                 empty_k = full_k + 8 * NS, full_v = empty_k + 8 * NS,
                 empty_v = full_v + 8 * NS;

  // the tile: blocks in reverse query-tile order (heaviest first), then
  // batch, then the group of P packed heads
  const int P = 1 << log2p;
  const int HP = H >> log2p, npos = BM >> log2p;
  const int nqt = (Sq + npos - 1) / npos;
  const int per = B * HP;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x) / per;
  const int b = static_cast<int>(blockIdx.x) % per / HP;
  const int hp = static_cast<int>(blockIdx.x) % HP;
  const int kvh = (hp << log2p) / (H / KVH);
  const int p0 = qt * npos, p_last = min(p0 + npos, Sq) - 1;
  const int q_offset = Skv - Sq;
  // the union of the real rows' kv ranges, in tiles of BKV from its start
  const int kv_lo = window > 0 ? max(0, q_offset + p0 - window + 1) : 0;
  const int kv_hi = causal ? q_offset + p_last + 1 : Skv;
  const int n_tiles = (kv_hi - kv_lo + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 128);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 4) {                 // the producer: one thread issues the TMA
    if (lane == 0) {
      mbar_expect_tx(full_q, C::Q_BYTES);
#pragma unroll
      for (int j = 0; j < QK::NB; ++j)
        tma_load_5d(s_q + j * BM * QK::SW, &tm_q, full_q, j * QK::BOXW, 0, hp,
                    p0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % NS, par = ((t / NS) & 1) ^ 1;
        const int kv0 = kv_lo + t * BKV;
        mbar_wait(empty_k + 8 * s, par);
        mbar_expect_tx(full_k + 8 * s, C::K_BYTES);
#pragma unroll
        for (int j = 0; j < QK::NB; ++j)
          tma_load_4d(s_k + s * C::K_BYTES + j * BKV * QK::SW, &tm_k,
                      full_k + 8 * s, j * QK::BOXW, kvh, kv0, b);
        mbar_wait(empty_v + 8 * s, par);
        mbar_expect_tx(full_v + 8 * s, C::V_BYTES);
#pragma unroll
        for (int j = 0; j < VL::NB; ++j)
          tma_load_4d(s_v + s * C::V_BYTES + j * BKV * VL::SW, &tm_v,
                      full_v + 8 * s, j * VL::BOXW, kvh, kv0, b);
      }
    }
    return;
  }

  // ---- the consumer warpgroup
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16 + g;                  // rows r0 and r0 + 8
  const int pos[2] = {p0 + (r0 >> log2p), p0 + ((r0 + 8) >> log2p)};
  int lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q_offset + pos[i];
    lo[i] = window > 0 ? qp - window + 1 : 0;
    hi[i] = causal ? min(qp + 1, Skv) : Skv;
  }
  // kv columns every real row of the tile sees
  const int all_lo = window > 0 ? q_offset + p_last - window + 1 : 0;
  const int all_hi = causal ? q_offset + p0 + 1 : Skv;

  uint8_t* q2 = smem + C::OFF_Q2;                // f32 route: qr, qb
  uint8_t* k2 = smem + C::OFF_K2;                // kr, kb
  uint8_t* v2 = smem + C::OFF_V2;                // v1, v2, v3
  const uint32_t s_q2 = s_q + C::OFF_Q2, s_k2 = s_q + C::OFF_K2,
                 s_v2 = s_q + C::OFF_V2;

  // S = Q K^T of the K tile in slot `slot`
  auto issue_s = [&](float (&sc)[BKV / 2], int slot) {
    const uint32_t kt = s_k + slot * C::K_BYTES;
    if constexpr (!F32) {
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        wgmma_ss<BKV, false>(sc, kmajor<QK, BM>(s_q, kk),
                             kmajor<QK, BKV>(kt, kk), kk > 0);
    } else {                       // the small terms first (see above)
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        wgmma_ss<BKV, false>(sc, kmajor<QK2, BM>(s_q2, kk),
                             kmajor<QK2, BKV>(s_k2 + C::K2_BYTES, kk),
                             kk > 0);
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        wgmma_ss<BKV, false>(sc, kmajor<QK2, BM>(s_q2 + C::Q2_BYTES, kk),
                             kmajor<QK2, BKV>(s_k2, kk), 1);
#pragma unroll
      for (int kk = 0; kk < DQK / 8; ++kk)
        wgmma_ss<BKV, true>(sc, kmajor<QK, BM>(s_q, kk),
                            kmajor<QK, BKV>(kt, kk), 1);
    }
  };
  // O += P V of the V tile in slot `slot` (f32: of its three terms), one
  // term at a time, the smallest first
  auto issue_pv = [&](float (&acc)[DV / 2], uint32_t (&ph)[BKV / 4],
                      uint32_t (&pl)[BKV / 4], int slot) {
    auto chain = [&](const uint32_t* p, uint32_t v) {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs<DV>(acc, p + 4 * kk, mnmajor<V2, BKV>(v, kk));
    };
    if constexpr (!F32) {
      const uint32_t vt = s_v + slot * C::V_BYTES;
      chain(pl, vt);
      chain(ph, vt);
    } else {
      chain(pl, s_v2 + C::V2_BYTES);
      chain(pl, s_v2);
      chain(ph, s_v2 + 2 * C::V2_BYTES);
      chain(ph, s_v2 + C::V2_BYTES);
      chain(ph, s_v2);
    }
  };
  // f32 route: round the K tile in `slot` and write its bf16 terms
  auto split_k = [&](int slot) {
    if constexpr (F32) {
      consumer_sync();             // the last S chain has read kr, kb
      split_qk<DQK, BKV>(smem + C::OFF_K + slot * C::K_BYTES, k2,
                         k2 + C::K2_BYTES);
      fence_proxy_async();
      consumer_sync();
    }
  };
  // f32 route: the V tile in `slot` into its three terms; the slot is
  // free then
  auto split_v_slot = [&](int slot) {
    if constexpr (F32) {
      split_v<DV, BKV>(smem + C::OFF_V + slot * C::V_BYTES, v2,
                       v2 + C::V2_BYTES, v2 + 2 * C::V2_BYTES);
      fence_proxy_async();
      consumer_sync();
      mbar_arrive(empty_v + 8 * slot);
    }
  };

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float sc[BKV / 2];
  uint32_t ph[BKV / 4], pl[BKV / 4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
  auto need_mask = [&](int kv0) {
    return kv0 < all_lo || kv0 + BKV > all_hi;
  };

  mbar_wait(full_q, 0);
  if constexpr (F32) split_qk<DQK, BM>(smem, q2, q2 + C::Q2_BYTES);
  mbar_wait(full_k, 0);
  split_k(0);
  wg_fence();
  issue_s(sc, 0);
  wg_commit();
  wg_wait<0>();
  fence_regs(sc);
  mbar_arrive(empty_k);
  online_softmax<BKV>(sc, m, l, alpha, kv_lo, need_mask(kv_lo), lo, hi, tig,
                      scale_log2);
  split_p<BKV>(sc, ph, pl);

  for (int t = 1; t < n_tiles; ++t) {
    const int s = t % NS, sp = (t - 1) % NS;
    mbar_wait(full_k + 8 * s, (t / NS) & 1);
    split_k(s);
    wg_fence();
    issue_s(sc, s);                // tile t's scores ...
    wg_commit();
    mbar_wait(full_v + 8 * sp, ((t - 1) / NS) & 1);
    if constexpr (F32) {
      split_v_slot(sp);
      wg_fence();
    }
    issue_pv(acc, ph, pl, sp);     // ... while tile t - 1's P V runs
    wg_commit();
    wg_wait<1>();
    fence_regs(sc);
    mbar_arrive(empty_k + 8 * s);
    const int kv0 = kv_lo + t * BKV;
    online_softmax<BKV>(sc, m, l, alpha, kv0, need_mask(kv0), lo, hi, tig,
                        scale_log2);
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(ph);
    fence_regs(pl);
    if constexpr (!F32) mbar_arrive(empty_v + 8 * sp);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    split_p<BKV>(sc, ph, pl);
  }
  {
    const int sp = (n_tiles - 1) % NS;
    mbar_wait(full_v + 8 * sp, ((n_tiles - 1) / NS) & 1);
    if constexpr (F32) {
      consumer_sync();             // the last P V chain has read v1-v3
      split_v_slot(sp);
    }
    wg_fence();
    issue_pv(acc, ph, pl, sp);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(ph);
    fence_regs(pl);
    if constexpr (!F32) mbar_arrive(empty_v + 8 * sp);
  }

  // normalise (one IEEE reciprocal a row, then products: 1.5 ulp) and
  // write: row r is (position p0 + r / P, head hp P + r % P) of the (B, Sq,
  // H, DV) output
  float den[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    den[i] = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / den[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (pos[i] >= Sq) continue;
    const int head = (hp << log2p) + ((r0 + 8 * i) & (P - 1));
    const int64_t row = ((static_cast<int64_t>(b) * Sq + pos[i]) * H + head) *
                        DV;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      const float x0 = acc[4 * j + 2 * i] * inv[i];
      const float x1 = acc[4 * j + 2 * i + 1] * inv[i];
      if constexpr (F32)
        *reinterpret_cast<float2*>(static_cast<float*>(o) + row + c) =
            make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(o) + row + c) =
            __floats2bfloat162_rn(x0, x1);
    }
    if (tig == 0)
      lse[(static_cast<int64_t>(b) * H + head) * Sq + pos[i]] =
          m[i] * LN2 + logf(den[i]);
  }
}

// ------------------------------------------------------------- launches --

// st: the element strides (b, h, s) of q, then k, then v
template <int DQK, int DV, bool F32>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KVH, int Sq, int Skv, int causal, int window,
           float scale, const long long* st, cudaStream_t stream) {
  using C = Cfg<DQK, DV, F32>;
  constexpr cuuint64_t ES = F32 ? 4 : 2;
  // P = gcd(H / KVH, 64) heads packed a tile
  const int group = H / KVH;
  int log2p = 0;
  while (log2p < 6 && group % (2 << log2p) == 0) ++log2p;
  const int P = 1 << log2p, npos = BM / P;
  const long long tiles =
      static_cast<long long>(B) * (H / P) * ((Sq + npos - 1) / npos);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  CUtensorMap mq, mk, mv;
  const cuuint64_t qd[5] = {DQK, (cuuint64_t)P, (cuuint64_t)(H / P),
                            (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t qs[4] = {st[1] * ES, st[1] * P * ES, st[2] * ES,
                            st[0] * ES};
  const cuuint32_t qb[5] = {C::QK::BOXW, (cuuint32_t)P, 1, (cuuint32_t)npos,
                            1};
  const cuuint64_t kd[4] = {DQK, (cuuint64_t)KVH, (cuuint64_t)Skv,
                            (cuuint64_t)B};
  const cuuint64_t ks[3] = {st[4] * ES, st[5] * ES, st[3] * ES};
  const cuuint32_t kb[4] = {C::QK::BOXW, 1, C::BKV, 1};
  const cuuint64_t vd[4] = {DV, (cuuint64_t)KVH, (cuuint64_t)Skv,
                            (cuuint64_t)B};
  const cuuint64_t vs[3] = {st[7] * ES, st[8] * ES, st[6] * ES};
  const cuuint32_t vb[4] = {C::V::BOXW, 1, C::BKV, 1};
  if (!encode(&mq, q, F32, 5, qd, qs, qb, C::QK::SW) ||
      !encode(&mk, k, F32, 4, kd, ks, kb, C::QK::SW) ||
      !encode(&mv, v, F32, 4, vd, vs, vb, C::V::SW))
    return (int)cudaErrorInvalidValue;

  // the shared-memory opt-in, once a device
  static unsigned opted = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 32 || !(opted & (1u << dev))) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<DQK, DV, F32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) opted |= 1u << dev;
  }
  flash_fwd<DQK, DV, F32><<<(unsigned)tiles, THREADS, C::SMEM, stream>>>(
      mq, mk, mv, o, lse, B, H, KVH, Sq, Skv, log2p, causal, window,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_type(int bf16_in, const void* q, const void* k, const void* v,
                void* o, float* lse, int B, int H, int KVH, int Sq, int Skv,
                int causal, int window, float scale, const long long* st,
                cudaStream_t s) {
  return bf16_in ? launch<DQK, DV, false>(q, k, v, o, lse, B, H, KVH, Sq, Skv,
                                          causal, window, scale, st, s)
                 : launch<DQK, DV, true>(q, k, v, o, lse, B, H, KVH, Sq, Skv,
                                         causal, window, scale, st, s);
}

}  // namespace

// q (B, H, Sq, Dh), k (B, KVH, Skv, Dh) and v (B, KVH, Skv, Dv) of one
// type (bf16 != 0: __nv_bfloat16, else float), with the element strides
// (q_sb, q_sh, q_ss) of q's b, h and s dims, and so for k and v: each a
// positive multiple of 16 bytes. The head dim must be unit-stride (its
// stride is not passed), and the data 16-byte aligned. The strides are
// scalars, not an array, as ctypes passes scalars cheaper: this runs on
// every call of host-bound rounds. o is a contiguous (B, Sq, H, Dv)
// buffer of the same type, lse a contiguous (B, H, Sq) f32 one. (Dh, Dv)
// is (32, 32), (64, 64), (80, 80), (128, 128) or (192, 128); Sq <= Skv; H
// a multiple of KVH. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue /
// cudaErrorMisalignedAddress for operands it does not take, or
// cudaErrorNotSupported if the driver has no cuTensorMapEncodeTiled; it
// does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int bf16, int B, int H, int KVH, int Sq,
                                   int Skv, int Dh, int Dv, int causal,
                                   int window, float scale, void* stream,
                                   long long q_sb, long long q_sh,
                                   long long q_ss, long long k_sb,
                                   long long k_sh, long long k_ss,
                                   long long v_sb, long long v_sh,
                                   long long v_ss) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Skv < Sq)
    return (int)cudaErrorInvalidValue;
  const long long es = bf16 ? 2 : 4;
  const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh,
                                k_ss, v_sb, v_sh, v_ss};
  for (long long st : strides)
    if (st <= 0 || st * es % 16) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 32 && Dv == 32)
    return launch_type<32, 32>(bf16, q, k, v, o, lse, B, H, KVH, Sq, Skv,
                               causal, window, scale, strides, s);
  if (Dh == 64 && Dv == 64)
    return launch_type<64, 64>(bf16, q, k, v, o, lse, B, H, KVH, Sq, Skv,
                               causal, window, scale, strides, s);
  if (Dh == 80 && Dv == 80)
    return launch_type<80, 80>(bf16, q, k, v, o, lse, B, H, KVH, Sq, Skv,
                               causal, window, scale, strides, s);
  if (Dh == 128 && Dv == 128)
    return launch_type<128, 128>(bf16, q, k, v, o, lse, B, H, KVH, Sq, Skv,
                                 causal, window, scale, strides, s);
  if (Dh == 192 && Dv == 128)
    return launch_type<192, 128>(bf16, q, k, v, o, lse, B, H, KVH, Sq, Skv,
                                 causal, window, scale, strides, s);
  return (int)cudaErrorInvalidValue;
}
