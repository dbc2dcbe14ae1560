// The gradient of causal or sliding-window GQA attention, recomputed from
// the row log-sum-exp the forward saved, for Hopper (sm_90a): in bf16 and
// in f32 on wgmma fed by a TMA ring, both passes in one grid.
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
// q_pos - window when window > 0, masked. Deterministic in both types: no
// atomics, every output element summed in a fixed order.
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
// Three launches a call in either type (delta; one grid for both passes;
// the split fold, only where a group is split). One template,
// flash_bwd_wg<Dqk, Dv, F32>, holds both types.
// - One grid holds both passes, each block one warpgroup (warps 0-3, the
//   consumers) and one producer warp (warp 4), kv-tile blocks first, each
//   pass heaviest first (causal: low kv tiles, then high query tiles).
//   The passes depend on delta only, not on each other, so the light
//   query-tile blocks fill the SMs that the kv-tile blocks leave.
// - The kv-tile pass (dK, dV): one block a (b, kv head, 64 kv rows, split
//   of the group). K and V of the tile land once by TMA; the producer
//   streams each (query head of the split, stage of BQ query rows) pair
//   through a ring of NS stages (mbarriers full and empty): Q and dO by
//   TMA, the pair's lse (times log2 e) and delta rows by the producer's 32
//   lanes. The warpgroup forms S^T = K Q^T and dP^T = V dO^T as wgmma
//   chains from shared memory (M = 64 kv rows, K-major), then P^T and dS^T
//   on their accumulator registers (exp2 of the scores against lse; the
//   mask as each row's range of valid columns, two compares a score), and
//   adds dV += P^T dO and dK += dS^T Q with P^T and dS^T as bf16 A
//   operands from registers and dO and Q as B read MN-major through the
//   descriptor. In bf16, P and dS rounded to bf16 as MMA operands follow
//   the reference's own precision: its scan casts p to v's type before p v
//   (models/attention.py:93-94).
// - The query-tile pass (dQ): one block a (b, head, 64 query rows); Q and
//   dO land once, K and V stage by stage (BK kv rows) through the ring; S =
//   Q K^T, dP = dO V^T, then dQ += dS K (K read MN-major). S and dP are
//   formed in both passes: seven products where the gradient needs five,
//   the price of owning every output in one block (no atomics, no dQ
//   partials).
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
// - bf16 registers. The dK and dV accumulators live in registers across
//   the block's pairs: (Dqk + Dv) / 2 a thread, 160 at (192, 128). With
//   S^T and dP^T of 64 query columns (64 more) and their bf16 fragments,
//   that passes 255, so at Dqk 192 a kv-pass stage holds BQ = 32 query
//   rows: S^T and dP^T take 32 registers, the fragments 16, and the block
//   runs alone on its SM. Dqk 128 keeps 64 rows (128 + 64 + 32 fits in
//   255, one block an SM). Up to Dqk 80 two blocks share an SM, which caps
//   a thread at 168 registers: Dqk 64 fits with 64 rows, Dqk 80 only with
//   32 (64 spilled and serialized its wgmma). ptxas -v (sm_90a, CUDA 12.8,
//   the H100 machine's toolkit) for flash_bwd_wg<.., false>, registers a
//   thread and spill bytes: (32, 32) 133, 0; (64, 64) 164, 0; (80, 80)
//   144, 0; (128, 128) 228, 0; (192, 128) 223, 0.
// - Within a pair the warpgroup runs S^T/dP^T, then the softmax terms,
//   then dV/dK, each waiting on the last; the overlap comes from the TMA
//   ring (the next pairs' Q and dO land meanwhile) and from a second block
//   on the SM. Overlapping the chains inside the warpgroup (P^T formed
//   while dP^T runs, dS^T while dV runs) keeps P^T beside dP^T: at (64,
//   64) that passed 168 registers, spilled and ran slower. So did a mask
//   with a branch for interior tiles (PERF.md).
//
// The f32 route: the same grid and ring on the tensor cores, in the
// forward's split (csrc/flash_attention.cu, hopper.cuh). With h() TF32
// rounding (cvt.rna) and b() bf16 rounding:
// - The K-major products S (S^T) over Dqk and dP (dP^T) over Dv take
//   b(a - h(a)) . b(c) + b(a) . b(c - h(c)) on bf16 wgmma and h(a) . h(c)
//   on TF32 wgmma, in that order (each chain adds its smaller terms first:
//   an MMA truncates its sum). Both passes pair the Q (dO) residual first,
//   so both sum the same terms of a score in the same order.
// - The accumulating products dV += P^T dO, dK += dS^T Q and dQ += dS K
//   read dO, Q and K MN-major, which TF32 wgmma does not take: P^T, dS^T
//   and dS go in as two bf16 terms (x_hi = b(x), x_lo = b(x - x_hi)), the
//   shared operand as two (y1 = b(y), y2 = b(y - y1)), in three bf16
//   chains x_lo y1, x_hi y2, x_hi y1. Two terms each leave ~2^-18 of a
//   product. The CPU emulation of this route
//   (tests/test_torch_kernel_numerics.py) puts the gradients within 8.6e-6
//   of the largest, under the tenth of the card's 1e-4 that it holds;
//   one term of the shared operand (2.0-2.6e-3), or the K-major split
//   without its TF32 term (3.6-4.5e-3), misses it. The forward takes a
//   third term of V (five chains) for 2e-5 of a softmax row; here third
//   terms of both operands bought 6.1e-6, not worth two chains a product.
// - Flushes. An MMA truncates its f32 sum, and an accumulator that takes
//   thousands of steps drifts toward zero: over 4096 positions the kv-tile
//   blocks' dK and dV would take 8 heads x 4096 rows, 6144 truncating k16
//   steps. On the CPU emulation a causal 800 x 800 at Dqk 32 already
//   drifts to 1.06e-5 of the largest gradient, past the tenth of 1e-4
//   that its test holds. So every 512 rows of its sum (FLUSH pairs or
//   stages) an f32 accumulator is added into the block's own rows of the
//   output (or of its split's partials) in f32, round to nearest, and its
//   next chain restarts it (scale-d 0): 96 truncating steps at most, 7.4e-6
//   there, and 7.2e-6 over 4096 positions on the card (chip_smoke.py).
//   The same thread reads back what it wrote, so the sums keep a fixed
//   order. Zeroing the registers in the loop instead made ptxas copy them
//   and spill.
// - Each f32 tile lands as TMA wrote it (layout Rows<D, 4>); the consumer
//   warpgroup rounds it to TF32 in place and writes its bf16 terms beside
//   it (hopper.cuh split_qk): lo = b(x - h(x)) and hi = b(x) for every
//   operand, hi2 = b(x - hi) for those also read MN-major (the streamed Q
//   and dO of the kv pass, the streamed K of the query pass). A kv-pass
//   stage is split once and serves the head's S^T, dP^T, dV and dK.
// - Shared memory a row element: 8 bytes for the fixed tiles (K and V, or
//   Q and dO: 64 rows), 10 bytes for a ring stage. At (192, 128) the fixed
//   tiles take 160 KB, so the ring holds one stage of 16 rows (210 KB in
//   all); (128, 128) two of 16 (208 KB); (80, 80) two of 32 (181 KB);
//   (64, 64) three of 32 (186 KB); (32, 32) three of 32 (94 KB, two blocks
//   an SM). The query pass streams kv stages of the same rows (BK = BQ).
// - f32 registers: dK and dV as in bf16, with S^T and dP^T of 16 or 32
//   query columns and four fragment sets (P^T and dS^T, hi and lo). ptxas
//   -v for flash_bwd_wg<.., true>, registers a thread and spill bytes:
//   (32, 32) 114, 0; (64, 64) 169, 0; (80, 80) 166, 0; (128, 128) 220, 0;
//   (192, 128) 254, 0.
// - The group split (nsplit) applies to f32 as to bf16: zamba2's f32
//   shape (groups of 2) takes 0.0229 ms split against 0.0321 unsplit, the
//   text example's (groups of 4) 0.0106 against 0.0127
//   (tools/time_flash.py --backward, PERF.md).
#include <type_traits>

#include "hopper.cuh"   // TMA, mbarriers, wgmma, f32 splits, tensor maps

namespace {

constexpr int THREADS = 256;     // the row pass and the fold
constexpr int WG_THREADS = 160;  // one consumer warpgroup, one producer warp
constexpr int KR = 64;           // kv rows a kv-pass tile, query rows a dq one
constexpr float LOG2E = 1.4426950408889634f;

// The kernels' arguments: operands, outputs and their element strides
// along (b, h, s), in the order q, k, v, o, do, dq, dk, dv; the split of
// each group (nsplit), its f32 partials (scratch) and the kv-tile blocks
// that lead the grid (kv_blocks).
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

// two f32 sums written to an output in its type or, with `add`, added
// in f32 to what the same thread wrote there before (f32 only)
__device__ __forceinline__ void store2(float* p, float x, float y,
                                       bool add = false) {
  float2* d = reinterpret_cast<float2*>(p);
  if (add) {
    const float2 was = *d;
    x += was.x;
    y += was.y;
  }
  *d = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y,
                                       bool = false) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

__device__ __forceinline__ int64_t base(const Args& a, int t, int b, int h) {
  return static_cast<int64_t>(b) * a.st[t] + static_cast<int64_t>(h) *
         a.st[t + 1];
}

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

// ------------------------------------------------- the tile passes: wgmma --

template <int DQK, int DV, bool F32>
struct Wg {
  using QK = Rows<DQK, F32 ? 4 : 2>;   // rows of Q and K as they land
  using VO = Rows<DV, F32 ? 4 : 2>;    // rows of V and dO as they land
  // query rows a kv-pass stage, kv rows a dq-pass stage, stages of the
  // ring (see the registers and the shared memory, above)
  static constexpr int BQ =
      F32 ? (DQK >= 128 ? 16 : 32) : (DQK == 80 || DQK > 128 ? 32 : 64);
  static constexpr int BK = F32 ? BQ : KR;
  static constexpr int NS = !F32 ? 3 : DQK == 192 ? 1 : DQK == 80 ||
                                   DQK == 128 ? 2 : 3;
  static constexpr int SR = F32 ? BQ : KR;       // rows a ring slot holds
  // f32: pairs (kv pass) or stages (dq pass) between flushes of the
  // accumulators, 512 rows of the sum: 96 truncating k16 steps at most
  static constexpr int FLUSH = F32 ? 512 / BQ : 1 << 30;
  // a tile of R rows of D takes R D (F32 ? 4 + 2 terms : 2) bytes: as it
  // lands, then (f32) its bf16 terms lo, hi and, in a ring slot, hi2
  static constexpr int E2 = F32 ? 4 + 2 * 2 : 2, E3 = F32 ? 4 + 2 * 3 : 2;
  // the fixed pair (kv pass: K, V; dq pass: Q, dO), then NS ring slots (kv
  // pass: BQ rows of Q and dO; dq pass: BK rows of K and V), then NS x
  // (lse, delta) rows of BQ floats (kv pass), then the barriers: fixed
  // full, NS full, NS empty; 1024 bytes of slack to align the base for the
  // 128-byte swizzle
  static constexpr int FA = KR * DQK * E2, FB = KR * DV * E2;
  static constexpr int SA = SR * DQK * E3, SB = SR * DV * E3;
  static constexpr int SLOT = SA + SB;
  static constexpr int OFF_RING = FA + FB;
  static constexpr int OFF_ROWS = OFF_RING + NS * SLOT;
  static constexpr int OFF_BAR = OFF_ROWS + NS * 2 * BQ * 4;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 2 * NS) + 1024;
  static constexpr int MIN_BLOCKS = DQK <= (F32 ? 32 : 80) ? 2 : 1;
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(KR % BQ == 0 && KR % BK == 0 && BQ % 16 == 0,
                "whole stages in a tile, whole k16 steps in a stage");
  static_assert(SR * DQK * 2 % 1024 == 0 && SR * DV * 2 % 1024 == 0,
                "every tile and term on a 1024-byte boundary");
};

// The f32 route's split of an R-row tile of D that landed at `t`: TF32 in
// place, then its bf16 terms lo, hi and, with MN (read MN-major too), hi2
template <int D, int R, bool MN>
__device__ __forceinline__ void split_tile(uint8_t* t) {
  constexpr int F = R * D * 4, B = R * D * 2;
  split_qk<D, R, MN>(t, t + F, t + F + B, t + F + 2 * B);
}

// acc = A C^T over D, A (RA rows) and C (RB rows) K-major at shared
// addresses a and c: in bf16 one chain; in f32 the tiles of split_tile,
// b(a - h(a)) . b(c) and b(a) . b(c - h(c)) on bf16 wgmma (A's residual
// first with A_LO_FIRST, else C's), then h(a) . h(c) on TF32 wgmma
template <int N, int D, bool F32, int RA, int RB, bool A_LO_FIRST>
__device__ __forceinline__ void kmajor_product(float (&acc)[N / 2],
                                               uint32_t a, uint32_t c) {
  using L2 = Rows<D, 2>;
  if constexpr (!F32) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<N, false>(acc, kmajor<L2, RA>(a, kk), kmajor<L2, RB>(c, kk),
                         kk > 0);
  } else {
    const uint32_t a_lo = a + RA * D * 4, a_hi = a_lo + RA * D * 2;
    const uint32_t c_lo = c + RB * D * 4, c_hi = c_lo + RB * D * 2;
    const uint32_t a1 = A_LO_FIRST ? a_lo : a_hi, c1 = A_LO_FIRST ? c_hi : c_lo;
    const uint32_t a2 = A_LO_FIRST ? a_hi : a_lo, c2 = A_LO_FIRST ? c_lo : c_hi;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<N, false>(acc, kmajor<L2, RA>(a1, kk), kmajor<L2, RB>(c1, kk),
                         kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<N, false>(acc, kmajor<L2, RA>(a2, kk), kmajor<L2, RB>(c2, kk),
                         1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      wgmma_ss<N, true>(acc, kmajor<Rows<D, 4>, RA>(a, kk),
                        kmajor<Rows<D, 4>, RB>(c, kk), 1);
  }
}

// acc (+)= X Y over R rows of Y: X from registers as bf16 A fragments
// (f32: x_hi, x_lo), Y read MN-major at shared address y (f32: the tile of
// split_tile<D, R, true>, its terms hi and hi2): in bf16 one chain, in f32
// x_lo y1, x_hi y2, x_hi y1; keep 0 overwrites acc
template <int D, bool F32, int R>
__device__ __forceinline__ void mnmajor_product(float (&acc)[D / 2],
                                                const uint32_t* xh,
                                                const uint32_t* xl,
                                                uint32_t y, int keep) {
  using L2 = Rows<D, 2>;
  auto chain = [&](const uint32_t* x, uint32_t t, int first) {
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk)
      wgmma_rs<D>(acc, x + 4 * kk, mnmajor<L2, R>(t, kk),
                  kk > 0 ? 1 : first);
  };
  if constexpr (!F32) {
    chain(xh, y, keep);
  } else {
    const uint32_t y1 = y + R * D * 6, y2 = y1 + R * D * 2;
    chain(xl, y1, keep);
    chain(xh, y2, 1);
    chain(xh, y1, 1);
  }
}

// The probabilities on accumulator registers, in two steps: s becomes p =
// exp2(s scale_log2 - lse2) where its column c lies in its row's [lo, hi),
// else 0; then dp becomes ds = p (dp - delta) scale.
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

template <int DQK, int DV, bool F32>
__global__ void __launch_bounds__(WG_THREADS, (Wg<DQK, DV, F32>::MIN_BLOCKS))
flash_bwd_wg(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_do, const Args a) {
  using C = Wg<DQK, DV, F32>;
  using QK = typename C::QK;
  using VO = typename C::VO;
  using T = typename std::conditional<F32, float, bf16>::type;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_fa = smem_u32(smem), s_fb = s_fa + C::FA,
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
  // f32: the fixed tiles into their terms, once (K-major only)
  auto split_fixed = [&]() {
    if constexpr (F32) {
      split_tile<DQK, KR, false>(smem);
      split_tile<DV, KR, false>(smem + C::FA);
      fence_proxy_async();
      consumer_sync();
    }
  };

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
    // the query stages that see a row of this kv tile: from the stage
    // holding the first causal row, to the last row whose window reaches
    // the tile; the pairs run head by head, stages ascending
    const int i_lo = (a.causal ? max(0, j0 - q_offset) : 0) / BQ * BQ;
    const int i_hi = a.window > 0
                         ? min(a.Sq, j0 + nj - 1 + a.window - q_offset)
                         : a.Sq;
    const int nqt = i_hi > i_lo ? (i_hi - i_lo + BQ - 1) / BQ : 0;
    const int n = heads * nqt;

    if (warp == 4) {               // the producer
      if (lane == 0) {
        mbar_expect_tx(full_f, KR * (QK::BYTES + VO::BYTES));
#pragma unroll
        for (int rc = 0; rc < KR / BK; ++rc) {   // K and V in boxes of BK
#pragma unroll
          for (int jb = 0; jb < QK::NB; ++jb)
            tma_load_4d(s_fa + (jb * KR + rc * BK) * QK::SW, &tm_k, full_f,
                        jb * QK::BOXW, kvh, j0 + rc * BK, b);
#pragma unroll
          for (int jb = 0; jb < VO::NB; ++jb)
            tma_load_4d(s_fb + (jb * KR + rc * BK) * VO::SW, &tm_v, full_f,
                        jb * VO::BOXW, kvh, j0 + rc * BK, b);
        }
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
          const uint32_t sq = s_ring + s * C::SLOT, sdo = sq + C::SA;
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
    zero(dk);
    zero(dv);
    // rows r0 and r0 + 8 of the tile to dk and dv, or to the split's f32
    // partials; with `add` (f32) added to the last flush's
    auto emit = [&](bool add) {
      int row = j0 + r0;           // opaque: addresses made here, not kept
      asm volatile("" : "+r"(row));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = row + 8 * i;
        if (j >= a.Skv) continue;
        if (a.nsplit == 1) {
          T* rk = static_cast<T*>(a.dk) + base(a, DK, b, kvh) +
                  static_cast<int64_t>(j) * a.st[DK + 2];
          T* rv = static_cast<T*>(a.dv) + base(a, DV_, b, kvh) +
                  static_cast<int64_t>(j) * a.st[DV_ + 2];
#pragma unroll
          for (int jj = 0; jj < DQK / 8; ++jj)
            store2(rk + 8 * jj + 2 * tig, dk[4 * jj + 2 * i],
                   dk[4 * jj + 2 * i + 1], add);
#pragma unroll
          for (int jj = 0; jj < DV / 8; ++jj)
            store2(rv + 8 * jj + 2 * tig, dv[4 * jj + 2 * i],
                   dv[4 * jj + 2 * i + 1], add);
        } else {
          float* rp =
              a.scratch +
              (((static_cast<int64_t>(b) * a.KVH + kvh) * a.nsplit + sp) *
                   a.Skv + j) * (DQK + DV);
#pragma unroll
          for (int jj = 0; jj < DQK / 8; ++jj)
            store2(rp + 8 * jj + 2 * tig, dk[4 * jj + 2 * i],
                   dk[4 * jj + 2 * i + 1], add);
#pragma unroll
          for (int jj = 0; jj < DV / 8; ++jj)
            store2(rp + DQK + 8 * jj + 2 * tig, dv[4 * jj + 2 * i],
                   dv[4 * jj + 2 * i + 1], add);
        }
      }
    };
    int keep = 1;                  // f32: 0 restarts dK, dV after a flush
    float st[BQ / 2], dpt[BQ / 2];               // S^T, dP^T: kv x query
    uint32_t pf[BQ / 4], df[BQ / 4];             // P^T, dS^T as bf16 A
    uint32_t pl[BQ / 4], dl[BQ / 4];             // f32: their residuals
    mbar_wait(full_f, 0);
    split_fixed();
    for (int t = 0; t < n; ++t) {
      const int s = t % NS, i0 = i_lo + t % nqt * BQ;
      const uint32_t sq = s_ring + s * C::SLOT, sdo = sq + C::SA;
      int lo[2], hi[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        kv_row_range(a, j0 + r0 + 8 * e, i0, lo[e], hi[e]);
      mbar_wait(full + 8 * s, (t / NS) & 1);
      if constexpr (F32) {         // Q and dO into their terms
        uint8_t* slot = smem + C::OFF_RING + s * C::SLOT;
        split_tile<DQK, BQ, true>(slot);
        split_tile<DV, BQ, true>(slot + C::SA);
        fence_proxy_async();
        consumer_sync();
      }
      // S^T and dP^T, then P^T and dS^T, then dV and dK, each waiting on
      // the last (the header note says why)
      wg_fence();
      kmajor_product<BQ, DQK, F32, KR, BQ, false>(st, s_fa, sq);
      kmajor_product<BQ, DV, F32, KR, BQ, false>(dpt, s_fb, sdo);
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
      if constexpr (F32) {
        split_p<BQ>(st, pf, pl);
        split_p<BQ>(dpt, df, dl);
      } else {
#pragma unroll
        for (int i = 0; i < BQ / 4; ++i) {
          pf[i] = pack_bf16(st[2 * i], st[2 * i + 1]);
          df[i] = pack_bf16(dpt[2 * i], dpt[2 * i + 1]);
        }
      }
      wg_fence();
      mnmajor_product<DV, F32, BQ>(dv, pf, pl, sdo, keep);
      mnmajor_product<DQK, F32, BQ>(dk, df, dl, sq, keep);
      keep = 1;
      wg_commit();
      wg_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pf);
      fence_regs(df);
      if constexpr (F32) {
        fence_regs(pl);
        fence_regs(dl);
      }
      mbar_arrive(empty + 8 * s);
      if (F32 && (t + 1) % C::FLUSH == 0 && t + 1 < n) {
        emit(t + 1 > C::FLUSH);
        keep = 0;
      }
    }
    emit(F32 && n > C::FLUSH);
    return;
  }

  // ---- the query-tile pass: dQ of 64 query rows of one head
  const int idx = static_cast<int>(blockIdx.x) - a.kv_blocks;
  const int per = a.B * a.H;
  const int nqt = (a.Sq + KR - 1) / KR;
  const int qt = nqt - 1 - idx / per;                  // heaviest first
  const int b = idx % per / a.H, h = idx % a.H, kvh = h / a.group;
  const int i0 = qt * KR, ni = min(KR, a.Sq - i0);
  // the kv stages the query tile sees: from the stage holding its first
  // row's window start to its last row's causal end
  const int kv_lo =
      (a.window > 0 ? max(0, q_offset + i0 - a.window + 1) : 0) / BK * BK;
  const int kv_hi = a.causal ? q_offset + i0 + ni : a.Skv;
  const int n = (kv_hi - kv_lo + BK - 1) / BK;

  if (warp == 4) {                 // the producer
    if (lane == 0) {
      mbar_expect_tx(full_f, KR * (QK::BYTES + VO::BYTES));
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
      const int s = t % NS, kv0 = kv_lo + t * BK;
      mbar_wait(empty + 8 * s, ((t / NS) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t sk = s_ring + s * C::SLOT, sv = sk + C::SA;
        mbar_expect_tx(full + 8 * s, BK * (QK::BYTES + VO::BYTES));
#pragma unroll
        for (int jb = 0; jb < QK::NB; ++jb)
          tma_load_4d(sk + jb * BK * QK::SW, &tm_k, full + 8 * s,
                      jb * QK::BOXW, kvh, kv0, b);
#pragma unroll
        for (int jb = 0; jb < VO::NB; ++jb)
          tma_load_4d(sv + jb * BK * VO::SW, &tm_v, full + 8 * s,
                      jb * VO::BOXW, kvh, kv0, b);
      } else {
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // rows r0 and r0 + 8: lse (times log2 e) and delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = i0 + r0 + 8 * e;
    const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.Sq + i;
    lse2[e] = i < a.Sq ? a.lse[row] * LOG2E : 0.f;
    dlt[e] = i < a.Sq ? a.delta[row] : 0.f;
  }
  float dq[DQK / 2];
  zero(dq);
  // rows r0 and r0 + 8 to dq; with `add` (f32) added to the last flush's
  auto emit = [&](bool add) {
    int row = i0 + r0;             // opaque: addresses made here, not kept
    asm volatile("" : "+r"(row));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = row + 8 * e;
      if (i >= a.Sq) continue;
      T* rq = static_cast<T*>(a.dq) + base(a, DQ, b, h) +
              static_cast<int64_t>(i) * a.st[DQ + 2];
#pragma unroll
      for (int jj = 0; jj < DQK / 8; ++jj)
        store2(rq + 8 * jj + 2 * tig, dq[4 * jj + 2 * e],
               dq[4 * jj + 2 * e + 1], add);
    }
  };
  int keep = 1;                    // f32: 0 restarts dQ after a flush
  float sc[BK / 2], dp[BK / 2];                  // S, dP: query x kv
  uint32_t df[BK / 4], dl[BK / 4];               // dS as bf16 A (f32: + lo)
  mbar_wait(full_f, 0);
  split_fixed();
  for (int t = 0; t < n; ++t) {
    const int s = t % NS, kv0 = kv_lo + t * BK;
    const uint32_t sk = s_ring + s * C::SLOT, sv = sk + C::SA;
    int lo[2], hi[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      q_row_range(a, i0 + r0 + 8 * e, kv0, lo[e], hi[e]);
    mbar_wait(full + 8 * s, (t / NS) & 1);
    if constexpr (F32) {           // K (read MN-major too) and V
      uint8_t* slot = smem + C::OFF_RING + s * C::SLOT;
      split_tile<DQK, BK, true>(slot);
      split_tile<DV, BK, false>(slot + C::SA);
      fence_proxy_async();
      consumer_sync();
    }
    wg_fence();
    kmajor_product<BK, DQK, F32, KR, BK, true>(sc, s_fa, sk);
    kmajor_product<BK, DV, F32, KR, BK, true>(dp, s_fb, sv);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        prob(a, sc[4 * jj + e], 8 * jj + 2 * tig + (e & 1), lo[e >> 1],
             hi[e >> 1], lse2[e >> 1]);
        dprob(a, sc[4 * jj + e], dp[4 * jj + e], dlt[e >> 1]);
      }
    if constexpr (F32) {
      split_p<BK>(dp, df, dl);
    } else {
#pragma unroll
      for (int i = 0; i < BK / 4; ++i)
        df[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
    }
    wg_fence();
    mnmajor_product<DQK, F32, BK>(dq, df, dl, sk, keep);
    keep = 1;
    wg_commit();
    wg_wait<0>();
    fence_regs(dq);
    fence_regs(df);
    if constexpr (F32) fence_regs(dl);
    mbar_arrive(empty + 8 * s);
    if (F32 && (t + 1) % C::FLUSH == 0 && t + 1 < n) {
      emit(t + 1 > C::FLUSH);
      keep = 0;
    }
  }
  emit(F32 && n > C::FLUSH);
}

// The split partials of dK and dV summed in split order and written in
// the outputs' type: one thread a column pair of one (b, kv head, kv row).
template <typename T>
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
  T* out = c < dqk
               ? static_cast<T*>(a.dk) + base(a, DK, b, kvh) +
                     static_cast<int64_t>(j) * a.st[DK + 2] + c
               : static_cast<T*>(a.dv) + base(a, DV_, b, kvh) +
                     static_cast<int64_t>(j) * a.st[DV_ + 2] + (c - dqk);
  store2(out, acc.x, acc.y);
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

// delta, then both passes in one grid, then the fold
template <int DQK, int DV, bool F32>
int launch(Args a, cudaStream_t stream) {
  using C = Wg<DQK, DV, F32>;
  using T = typename std::conditional<F32, float, bf16>::type;
  constexpr cuuint64_t ES = sizeof(T);
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
  // the operands' real strides; boxes of one head and BQ query or BK kv
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
  const cuuint32_t kb[4] = {C::QK::BOXW, 1, C::BK, 1};
  const cuuint64_t vd[4] = {DV, (cuuint64_t)a.KVH, (cuuint64_t)a.Skv,
                            (cuuint64_t)a.B};
  const cuuint64_t vs[3] = {st[V + 1] * ES, st[V + 2] * ES, st[V] * ES};
  const cuuint32_t vb[4] = {C::VO::BOXW, 1, C::BK, 1};
  const cuuint64_t dd[4] = {DV, (cuuint64_t)a.H, (cuuint64_t)a.Sq,
                            (cuuint64_t)a.B};
  const cuuint64_t ds[3] = {st[DO + 1] * ES, st[DO + 2] * ES, st[DO] * ES};
  const cuuint32_t db[4] = {C::VO::BOXW, 1, C::BQ, 1};
  if (!encode(&mq, a.q, F32, 4, qd, qs, qb, C::QK::SW) ||
      !encode(&mk, a.k, F32, 4, kd, ks, kb, C::QK::SW) ||
      !encode(&mv, a.v, F32, 4, vd, vs, vb, C::VO::SW) ||
      !encode(&mdo, a.dout, F32, 4, dd, ds, db, C::VO::SW))
    return (int)cudaErrorInvalidValue;

  static unsigned opted = 0;
  cudaError_t e = opt_in(flash_bwd_wg<DQK, DV, F32>, C::SMEM, &opted);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_delta<T><<<(unsigned)rows_blocks, THREADS, 0, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_wg<DQK, DV, F32><<<(unsigned)(kv_blocks + q_blocks), WG_THREADS,
                               C::SMEM, stream>>>(mq, mk, mv, mdo, a);
  e = cudaGetLastError();
  if (e != cudaSuccess || fold_blocks == 0) return (int)e;
  flash_bwd_fold<T><<<(unsigned)fold_blocks, THREADS, 0, stream>>>(a, DQK);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_type(int bf16_in, const Args& a, cudaStream_t s) {
  return bf16_in ? launch<DQK, DV, false>(a, s) : launch<DQK, DV, true>(a, s);
}

}  // namespace

// q (B, H, Sq, Dqk), k (B, KVH, Skv, Dqk), v (B, KVH, Skv, Dv), o and do
// (B, H, Sq, Dv) of one type (bf16 != 0: __nv_bfloat16, else float), lse
// a contiguous (B, H, Sq) f32 tensor; delta a contiguous (B, H, Sq) f32
// buffer the kernel fills (scratch); dq, dk and dv outputs of the inputs'
// type and shapes. strides: 24 element strides, (b, h, s) of q, k, v, o,
// do, dq, dk, dv in that order; each head dim must be unit-stride. The
// strides of q, k, v and do must be positive multiples of 16 bytes and
// their data 16-byte aligned (the TMA reads them), those of dq, dk and dv
// even and their data (and scratch) aligned to two elements; nsplit (a
// power of two dividing H / KVH) splits each group's heads over that many
// kv-tile blocks, whose f32 partials go to `scratch` (B * KVH * nsplit *
// Skv * (Dqk + Dv) floats; unused at nsplit 1). (Dqk, Dv) is (32, 32),
// (64, 64), (80, 80), (128, 128) or (192, 128); Sq <= Skv; H a multiple
// of KVH. Launches on `stream` (delta, both tile passes in one grid, then
// the fold where nsplit > 1) and returns cudaGetLastError() after them (0
// on success), cudaErrorInvalidValue / cudaErrorMisalignedAddress for
// arguments it does not take, or cudaErrorNotSupported if the driver has
// no cuTensorMapEncodeTiled; it does not synchronise.
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
  const int group = H / KVH;
  if (nsplit < 1 || group % nsplit != 0 || (nsplit & (nsplit - 1)) != 0 ||
      (nsplit > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long es = bf16 ? 2 : 4;
  for (int i = 0; i < 24; ++i) {
    const int t = i / 3 * 3;                   // the tensor of stride i
    const bool tma = t == Q || t == K || t == V || t == DO;
    if (tma ? strides[i] <= 0 || strides[i] * es % 16
            : t != O && strides[i] % 2)
      return (int)cudaErrorInvalidValue;
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
          15 ||
      (reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
       reinterpret_cast<uintptr_t>(dv) |
       reinterpret_cast<uintptr_t>(scratch)) & (2 * es - 1))
    return (int)cudaErrorMisalignedAddress;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
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
  a.group = group;
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
