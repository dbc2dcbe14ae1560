// Fused encoding statistics, f32, for Hopper (sm_90a), in two moment sets,
// on the tensor cores.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cco_stats.py:
// _stats_kernel (cco_stats_pallas with moments="cross") and
// _stats_kernel_full (moments="full"). From zf, zg (N, d), row-major, it
// computes in one launch:
//   mean_f = sum_n zf * inv_n,  sq_f = sum_n zf^2 * inv_n    (d,)
//   mean_g = sum_n zg * inv_n,  sq_g = sum_n zg^2 * inv_n    (d,)
//   cross  = zf^T zg * inv_n                                 (d, d)
// and, in the "full" set, the within-view second moments
//   cov_f  = zf^T zf * inv_n,   cov_g = zg^T zg * inv_n      (d, d)
// with inv_n = 1 / max(*num_valid, 1) when num_valid is given (pre-masked
// rows; read on the device, so the caller never syncs), else 1 / N.
//
// Products at f32 accuracy on the tensor cores. Write h(x) for x rounded
// to TF32 and b(x) for x rounded to bf16. A product a b = h(a) h(b)
// + (a - h(a)) b + a (b - h(b)) up to the product of the two remainders
// (below 2^-22 of a b). The first term runs on mma.sync.m16n8k8 tf32; the
// two remainder terms, 2^-11 of the first, run together as
// b(a - h(a)) b(b) + b(a) b(b - h(b)) on one mma.sync.m16n8k16 bf16 (its
// 16-deep k takes 8 rows of N, two terms each), at the cost of a TF32
// MMA: two MMA issues per 8 rows where 3xTF32 takes three. The per-product
// error is ~2^-20; a single TF32 product keeps ~2^-11 and misses the
// 1e-5 tolerance (tests/test_torch_kernel_numerics.py emulates both). An
// MMA rounds its sum toward zero, so the MMAs of each KROWS = 32 rows of
// N sum into a fresh fragment, which is then added to the f32 accumulator
// with round-to-nearest: the drift stays one chunk's, however large N is
// (the engine's N is K x n; nothing caps it).
//
// Design. The outputs are cut into 64 x 64 tiles, and a block computes one
// tile of one product ("a job") over all of N: a = a 64-column slice of
// one input (rows of the tile), b = a slice of the other (columns). The
// cross set runs T^2 jobs (T = ceil(d / 64)); the full set runs the same
// T^2 cross jobs, then the T (T + 1) / 2 upper tiles (j >= i) of cov_f and
// of cov_g: 528 equal jobs at d = 1024, where a block per tile pair would
// mix 3- and 4-product blocks. A cross tile is formed by the same code
// from the same operands in the same MMA order in both kernels, so the
// full set's five statistics equal the cross set's bit for bit.
// - Warps: KG k-groups of 4 warps. A chunk holds 32 rows of N for each;
//   k-group kg multiplies rows 32 kg .. 32 kg + 31 of it (four 8-row
//   steps, summed from zero, then added to its f32 sums), and at the end
//   k-group 1 hands its sums to k-group 0 through shared memory, which
//   adds them and stores the tile. KG = 2 from N = 65: two 8-warp blocks
//   an SM, four warps a scheduler to hide the latency of the loads, splits
//   and MMAs, which a 4-warp block left exposed (on an H100 SXM, an
//   ablation build of that block without its MMAs was no faster at
//   N = 4096, one without its global loads 17% faster); below N = 65,
//   KG = 1: four 4-warp blocks an SM, so the full set's 528 jobs run in
//   one wave.
// - Staging: chunks of both slices go through a 3-stage cp.async ring
//   (16-byte copies where d % 4 == 0 and the inputs are 16-byte aligned,
//   each thread's addresses set up once; plain loads otherwise), so chunk
//   c + 2 loads while chunk c is multiplied. Rows past N and columns past
//   d are zero-filled and contribute exactly zero; a k-group skips the
//   steps of a chunk that hold no rows. Rows are staged at LD = 72 floats,
//   at which the fragment loads below are free of bank conflicts.
// - Operands: both are MN-major (the reduction runs over N, the slow
//   axis), so a fragment takes rows t and t + 4 of a step (t = lane % 4)
//   and fixed columns of them, read from f32 staged as it came in. The
//   columns are permuted so that one load gives a lane all it needs: warp
//   (wm, wn) of a k-group owns tile rows 32 wm .. + 31 and columns
//   32 wn .. + 31; lane group g = lane / 4 reads columns 4 g .. 4 g + 3 of
//   the a slice (one 16-byte load a row: m-tile mi takes 4 g + 2 mi as its
//   row g and 4 g + 2 mi + 1 as its row g + 8) and columns 2 g, 2 g + 1,
//   16 + 2 g, 17 + 2 g of the b slice (two 8-byte loads; n-tile nj takes
//   16 (nj / 2) + 2 g + nj % 2).
// - Splits: each lane splits the values it loaded, h(x) for the TF32 MMA
//   (two integer operations) and one word of two bf16 for the k16 MMA,
//   (b(x - h(x)), b(x)) on the a side and (b(x), b(x - h(x))) on the b
//   side. An element is split in registers by the 2 warps of a k-group
//   that read it, issued under the MMAs; a split pass through shared
//   memory would store 8 bytes an element and read them back in each
//   warp, three times the shared-memory traffic of reading the f32 once.
//   A step issues its 8 TF32 MMAs, then its 8 bf16 ones, so no MMA waits
//   on the one just issued.
// - Accumulators: each lane ends with rows 4 g .. 4 g + 3 of its warp's
//   32 x 32 and columns 4 t .. 4 t + 3 and 16 + 4 t .. 16 + 4 t + 3, so the
//   epilogue stores 16-byte float4s straight from registers, 4 lanes
//   covering 64 contiguous bytes of a row; an upper cov tile is stored
//   transposed at (j, i) as well, where 8 lanes cover 128 contiguous bytes
//   of a row. A diagonal cov tile writes its upper triangle and, from it,
//   the strict lower one (scalar stores): the split terms reach (a, b) and
//   (b, a) in other MMA slots, so only the mirror makes cov_f and cov_g
//   exactly symmetric. Where d % 4 != 0 every store is scalar and masked.
// - Vector statistics: the cross jobs of the first tile column sum the f
//   columns of their rows, those of the first tile row the g columns, in
//   f32 over the staged chunks in row order, on the last k-group's threads
//   0-63 and 64-127. Those 2T - 1 jobs finish last (an ablation build
//   without the vector statistics was 17% faster at N = 4096, 9% at
//   N = 128); a build that spread them over every cross job, a few columns
//   each, was 5-10% faster at N = 4096 but up to 19% slower at N <= 128,
//   the shapes the training paths run, and it is not taken.
// Every output element has one writer and no atomics are used; the result
// is the same from run to run.
//
// Bound on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32 on the tensor cores,
// the fastest rate at which any route multiplies f32 inputs): each input
// read once and each output written once, against 2 N d^2 operations for
// cross (plus N d (d + 1) for each within-view upper triangle). At the
// main path's N = 128, d = 1024 the bytes bound both sets: cross 5.26 MB,
// 1.57 us (0.54 us of operations); full 13.65 MB, 4.07 us. At the token
// path's N = 8: 4.27 MB, 1.27 us. At N = 4096 the operations bound them:
// 17.4 us cross, 34.7 us full; the kernel issues two MMAs for every TF32
// product's worth, so twice that is its own floor. What holds it there is
// instruction issue and latency, not bytes: a warp issues ~500
// instructions for each 32-row share of a chunk, 64 of them MMAs (the
// rest loads, splits, staging and the chunk's barrier; cuobjdump -sass).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;                  // job tile edge
constexpr int KROWS = 32;                 // rows of a chunk a k-group sums
constexpr int LD = TILE + 8;              // staged row stride, floats
constexpr int STAGES = 3;                 // the cp.async ring
constexpr int KG_MIN_N = 65;              // N from which 2 k-groups run

// a chunk of KG k-groups: KROWS KG rows of N; a ring slot holds its rows of
// both slices; the ring takes 55,296 bytes for one k-group, 110,592 for 2
template <int KG>
__host__ __device__ constexpr int chunk_rows() {
  return KROWS * KG;
}
template <int KG>
__host__ __device__ constexpr int slot_floats() {
  return 2 * chunk_rows<KG>() * LD;
}
template <int KG>
__host__ __device__ constexpr int ring_bytes() {
  return STAGES * slot_floats<KG>() * 4;
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

// x rounded to TF32 (to nearest, ties away, as cvt.rna.tf32.f32 rounds a
// finite x), as the bits of an f32, in two integer operations
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// (lo, hi) rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x split for the a side: h(x), and (b(x - h(x)), b(x))
__device__ __forceinline__ void split_a(float x, uint32_t& h, uint32_t& w) {
  h = to_tf32(x);
  w = pack_bf16(x - __uint_as_float(h), x);
}

// x split for the b side: h(x), and (b(x), b(x - h(x)))
__device__ __forceinline__ void split_b(float x, uint32_t& h, uint32_t& w) {
  h = to_tf32(x);
  w = pack_bf16(x, x - __uint_as_float(h));
}

// d = a (16 x 8, row) . b (8 x 8, col) + (FIRST ? 0 : d), tf32 in, f32 out
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

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One thread's share of staging chunks of the a slice (columns i0 ..) and
// the b slice (columns j0 ..) of a (n, d) matrix pair into ring slots (a
// at slot, b at slot + BK LD), zeros past row n or column d. VEC (d % 4
// == 0, 16-byte aligned inputs): 16-byte cp.async, the thread's fixed
// column unit cl of rows rt + m ROWSTEP, addresses set up once and
// advanced a chunk at a time; else plain loads and stores, visible after
// the next __syncthreads.
template <int KG, bool VEC>
struct Stager {
  static constexpr int T = 128 * KG;          // threads of the block
  static constexpr int BK = chunk_rows<KG>();
  static constexpr int ROWSTEP = T / (TILE / 4);
  static constexpr int COPIES = BK / ROWSTEP; // 16-byte copies a slice
  static_assert(BK % ROWSTEP == 0, "whole copies a thread");
  const float *za, *zb, *pa, *pb;   // pa, pb: row rt of the next chunk
  int n, d, i0, j0, row0, rt, cl;
  bool oka, okb;

  __device__ __forceinline__ Stager(const float* za_, const float* zb_,
                                    int n_, int d_, int i0_, int j0_)
      : za(za_), zb(zb_), n(n_), d(d_), i0(i0_), j0(j0_), row0(0) {
    rt = threadIdx.x / (TILE / 4);
    cl = (threadIdx.x % (TILE / 4)) * 4;
    oka = i0 + cl < d;
    okb = j0 + cl < d;
    pa = za + (size_t)rt * d + i0 + cl;
    pb = zb + (size_t)rt * d + j0 + cl;
  }

  __device__ __forceinline__ void issue(float* slot) {
    if (VEC) {
      const uint32_t s = smem_u32(slot + rt * LD + cl);
#pragma unroll
      for (int m = 0; m < COPIES; ++m) {
        const bool row_ok = row0 + rt + m * ROWSTEP < n;
        const int off = m * ROWSTEP * d;
        cp_async16(s + m * ROWSTEP * LD * 4, row_ok && oka ? pa + off : za,
                   row_ok && oka);
        cp_async16(s + (BK + m * ROWSTEP) * LD * 4,
                   row_ok && okb ? pb + off : zb, row_ok && okb);
      }
      pa += (size_t)BK * d;
      pb += (size_t)BK * d;
    } else {
      for (int e = threadIdx.x; e < BK * TILE; e += T) {
        const int r = e / TILE, c = e % TILE;
        const int row = row0 + r;
        const size_t at = (size_t)row * d;
        slot[r * LD + c] =
            row < n && i0 + c < d ? za[at + i0 + c] : 0.f;
        slot[(BK + r) * LD + c] =
            row < n && j0 + c < d ? zb[at + j0 + c] : 0.f;
      }
    }
    row0 += BK;
  }
};

// part (+)= one 8-row step (rows r .. r + 7 of the staged chunk) of the
// warp's 32 x 32: the lane's loads and splits, the 8 TF32 MMAs, then the
// 8 bf16 MMAs (so no MMA waits on the one just issued).
template <bool FIRST>
__device__ __forceinline__ void mma_step(const float* __restrict__ sa,
                                         const float* __restrict__ sb, int r,
                                         float (&part)[2][4][4]) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = r + t, r1 = r0 + 4;
  // a side: columns 4 g .. 4 g + 3 of the warp's 32, rows r0 and r1
  const float* pa = sa + (wq >> 1) * 32 + 4 * g;
  const float4 x0 = *reinterpret_cast<const float4*>(pa + r0 * LD);
  const float4 x1 = *reinterpret_cast<const float4*>(pa + r1 * LD);
  const float xa[2][4] = {{x0.x, x0.y, x1.x, x1.y},   // mi 0: rows g,
                          {x0.z, x0.w, x1.z, x1.w}};  // g + 8 at r0, r1
  uint32_t ah[2][4], aw[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int k = 0; k < 4; ++k) split_a(xa[mi][k], ah[mi][k], aw[mi][k]);
  // b side: columns 2 g, 2 g + 1, 16 + 2 g, 17 + 2 g, rows r0 and r1
  const float* pb = sb + (wq & 1) * 32 + 2 * g;
  const float2 y00 = *reinterpret_cast<const float2*>(pb + r0 * LD);
  const float2 y01 = *reinterpret_cast<const float2*>(pb + r0 * LD + 16);
  const float2 y10 = *reinterpret_cast<const float2*>(pb + r1 * LD);
  const float2 y11 = *reinterpret_cast<const float2*>(pb + r1 * LD + 16);
  const float yb[2][4] = {{y00.x, y00.y, y01.x, y01.y},
                          {y10.x, y10.y, y11.x, y11.y}};
  uint32_t bh[4][2], bw[4][2];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    split_b(yb[0][nj], bh[nj][0], bw[nj][0]);
    split_b(yb[1][nj], bh[nj][1], bw[nj][1]);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
      mma_tf32<FIRST>(part[mi][nj], ah[mi], bh[nj][0], bh[nj][1]);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
      mma_bf16(part[mi][nj], aw[mi], bw[nj][0], bw[nj][1]);
}

// acc = this k-group's share of the tile (i0, j0) of za^T zb over all n
// rows, in this lane's fragment slots (see the header): k-group kg takes
// rows 32 kg .. 32 kg + 31 of every chunk, summed from zero and then
// added to acc. The a slice's column sums and sums of
// squares go to (vsum, vsq) of the last k-group's threads 0-63 when
// a_stats, the b slice's to its threads 64-127 when b_stats.
template <int KG, bool VEC>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ za, const float* __restrict__ zb, int n, int d,
    int i0, int j0, bool a_stats, bool b_stats, float* ring,
    float (&acc)[2][4][4], float& vsum, float& vsq) {
  constexpr int BK = chunk_rows<KG>(), SLOT = slot_floats<KG>();
  constexpr int STEPS = KROWS / 8;            // 8-row steps a k-group
  const int tid = threadIdx.x, kg = tid >> 7;
  const int chunks = (n + BK - 1) / BK;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
  vsum = 0.f;
  vsq = 0.f;
  const int sc = tid & 127;        // a stats thread's column (b: sc - 64)
  const bool stats = kg == KG - 1 && (sc < TILE ? a_stats : b_stats);

  Stager<KG, VEC> stager(za, zb, n, d, i0, j0);
  int load_slot = 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks) stager.issue(ring + s * SLOT);
    cp_async_commit();
    load_slot = s + 1;
  }

  int slot = 0;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();               // chunk c landed; chunk c - 1 is done
    if (c + STAGES - 1 < chunks) stager.issue(ring + load_slot * SLOT);
    cp_async_commit();
    load_slot = load_slot + 1 == STAGES ? 0 : load_slot + 1;

    const float* sa = ring + slot * SLOT;
    const float* sb = sa + BK * LD;
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    const int rows = min(BK, n - c * BK);
    const int r0 = kg * KROWS;
    if (r0 < rows) {
      float part[2][4][4];
      mma_step<true>(sa, sb, r0, part);
      if (rows == BK) {            // a whole chunk: every step, unbranched
#pragma unroll
        for (int k = 1; k < STEPS; ++k)
          mma_step<false>(sa, sb, r0 + 8 * k, part);
      } else {
#pragma unroll
        for (int k = 1; k < STEPS; ++k)
          if (r0 + 8 * k < rows) mma_step<false>(sa, sb, r0 + 8 * k, part);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] += part[mi][nj][e];
    }
    if (stats) {
      const float* col = sc < TILE ? sa + sc : sb + sc - TILE;
      auto add = [&](int r) {
        const float v = col[r * LD];
        vsum += v;
        vsq = fmaf(v, v, vsq);
      };
      if (rows == BK) {
#pragma unroll
        for (int r = 0; r < BK; ++r) add(r);
      } else {
        for (int r = 0; r < rows; ++r) add(r);
      }
    }
  }
  cp_async_wait<0>();
}

// k-group 1 hands its sums to k-group 0 through the (now idle) ring, which
// adds them to its own: acc of k-group 0 = the tile's whole sum.
__device__ __forceinline__ void combine_k_groups(float (&acc)[2][4][4],
                                                 float* ring) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  float4* x = reinterpret_cast<float4*>(ring) + wq * 8 * 32 + lane;
  __syncthreads();                 // every warp is done with the ring
  if (threadIdx.x >= 128) {
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const float(&a)[4] = acc[f >> 2][f & 3];
      x[f * 32] = make_float4(a[0], a[1], a[2], a[3]);
    }
  }
  __syncthreads();
  if (threadIdx.x < 128) {
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const float4 o = x[f * 32];
      float(&a)[4] = acc[f >> 2][f & 3];
      a[0] += o.x;
      a[1] += o.y;
      a[2] += o.z;
      a[3] += o.w;
    }
  }
}

// Where this lane's tile slots land: local rows 4 g + q (q = 2 mi + h) of
// the warp's, local columns 16 a + 4 t + e (e = 2 (c % 2) + nj % 2, a =
// nj / 2): acc[mi][2 a + (e & 1)][2 h + (e >> 1)].
__device__ __forceinline__ float slot_value(const float (&acc)[2][4][4],
                                            int q, int a, int e) {
  return acc[q >> 1][2 * a + (e & 1)][2 * (q & 1) + (e >> 1)];
}

// Store the tile (i0, j0) to out (d x d) scaled by inv_n. MIRROR: an
// upper within-view tile (j0 > i0), also stored transposed at (j0, i0).
// DIAG: a diagonal within-view tile; its upper triangle is stored and
// mirrored into the strict lower one.
template <bool VEC>
__device__ __forceinline__ void store_tile(const float (&acc)[2][4][4],
                                           float* __restrict__ out, int d,
                                           int i0, int j0, float inv_n,
                                           bool mirror, bool diag) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rbase = i0 + (warp >> 1) * 32 + 4 * g;
  const int cbase = j0 + (warp & 1) * 32 + 4 * t;
  if (diag) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = rbase + q, col = cbase + 16 * a + e;
          if (row >= d || col >= d || row > col) continue;
          const float v = slot_value(acc, q, a, e) * inv_n;
          out[(size_t)row * d + col] = v;
          if (row < col) out[(size_t)col * d + row] = v;
        }
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int row = rbase + q, col = cbase + 16 * a;
      const float4 v = make_float4(slot_value(acc, q, a, 0) * inv_n,
                                   slot_value(acc, q, a, 1) * inv_n,
                                   slot_value(acc, q, a, 2) * inv_n,
                                   slot_value(acc, q, a, 3) * inv_n);
      if (VEC) {
        if (row < d && col < d)
          *reinterpret_cast<float4*>(out + (size_t)row * d + col) = v;
      } else if (row < d) {
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) out[(size_t)row * d + col + e] = w[e];
      }
    }
  if (!mirror) return;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = cbase + 16 * a + e;   // the transposed tile's row
      const float4 v = make_float4(slot_value(acc, 0, a, e) * inv_n,
                                   slot_value(acc, 1, a, e) * inv_n,
                                   slot_value(acc, 2, a, e) * inv_n,
                                   slot_value(acc, 3, a, e) * inv_n);
      if (VEC) {
        if (row < d && rbase < d)
          *reinterpret_cast<float4*>(out + (size_t)row * d + rbase) = v;
      } else if (row < d) {
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (rbase + q < d) out[(size_t)row * d + rbase + q] = w[q];
      }
    }
}

// FULL = false: the "cross" set, T^2 blocks; FULL = true: the "full" set,
// T^2 cross blocks then T (T + 1) / 2 cov_f and as many cov_g blocks. KG
// k-groups of 4 warps a block.
template <bool FULL, int KG, bool VEC>
__global__ void __launch_bounds__(128 * KG, KG == 1 ? 4 : 2)
cco_stats_kernel(const float* __restrict__ zf, const float* __restrict__ zg,
                 const float* __restrict__ num_valid,
                 float* __restrict__ cross,
                 float* __restrict__ mean_f, float* __restrict__ sq_f,
                 float* __restrict__ mean_g, float* __restrict__ sq_g,
                 float* __restrict__ cov_f, float* __restrict__ cov_g,
                 int n, int d) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int tiles = (d + TILE - 1) / TILE;
  int job = blockIdx.x;
  const float *za = zf, *zb = zg;
  float* out = cross;
  int ti, tj;
  bool is_cross = true;
  if (!FULL || job < tiles * tiles) {
    ti = job / tiles;
    tj = job % tiles;
  } else {
    job -= tiles * tiles;
    const int upper = tiles * (tiles + 1) / 2;
    const bool f = job < upper;
    job = f ? job : job - upper;
    ti = 0;                        // the job-th upper tile, row by row
    while (job >= tiles - ti) {
      job -= tiles - ti;
      ++ti;
    }
    tj = ti + job;
    za = zb = f ? zf : zg;
    out = f ? cov_f : cov_g;
    is_cross = false;
  }
  const int i0 = ti * TILE, j0 = tj * TILE;
  const bool f_stats = is_cross && tj == 0;
  const bool g_stats = is_cross && ti == 0;

  float acc[2][4][4];
  float vsum, vsq;
  tile_product<KG, VEC>(za, zb, n, d, i0, j0, f_stats, g_stats, ring, acc,
                        vsum, vsq);
  if (KG == 2) combine_k_groups(acc, ring);

  const float inv_n =
      num_valid != nullptr ? 1.f / fmaxf(*num_valid, 1.f) : 1.f / (float)n;
  const int tid = threadIdx.x, sc = tid & 127;
  if (tid < 128)
    store_tile<VEC>(acc, out, d, i0, j0, inv_n, !is_cross && tj > ti,
                    !is_cross && tj == ti);
  if (tid >> 7 != KG - 1) return;  // the statistics' threads store them
  if (f_stats && sc < TILE && i0 + sc < d) {
    mean_f[i0 + sc] = vsum * inv_n;
    sq_f[i0 + sc] = vsq * inv_n;
  } else if (g_stats && sc >= TILE && j0 + sc - TILE < d) {
    mean_g[j0 + sc - TILE] = vsum * inv_n;
    sq_g[j0 + sc - TILE] = vsq * inv_n;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool FULL, int KG, bool VEC>
int launch(const float* zf, const float* zg, const float* num_valid,
           float* cross, float* mean_f, float* sq_f, float* mean_g,
           float* sq_g, float* cov_f, float* cov_g, int n, int d,
           cudaStream_t stream) {
  static bool configured = false;   // the attribute, once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        cco_stats_kernel<FULL, KG, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, ring_bytes<KG>());
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long tiles = (d + TILE - 1) / TILE;
  const long long jobs = tiles * tiles + (FULL ? tiles * (tiles + 1) : 0);
  cco_stats_kernel<FULL, KG, VEC>
      <<<(unsigned)jobs, 128 * KG, ring_bytes<KG>(), stream>>>(
          zf, zg, num_valid, cross, mean_f, sq_f, mean_g, sq_g, cov_f, cov_g,
          n, d);
  return (int)cudaGetLastError();
}

// One launch: 2 k-groups from N = KG_MIN_N, where a 64-row chunk holds
// rows for both (below it the 8-warp block measured 5-20% slower than
// the 4-warp one at N = 8 and 37 on an H100 SXM), 16-byte copies and
// stores where d and the pointers allow them.
template <bool FULL>
int dispatch(const float* zf, const float* zg, const float* num_valid,
             float* cross, float* mean_f, float* sq_f, float* mean_g,
             float* sq_g, float* cov_f, float* cov_g, int n, int d,
             void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  bool vec = d % 4 == 0 && aligned16(zf) && aligned16(zg) && aligned16(cross);
  if (FULL) vec = vec && aligned16(cov_f) && aligned16(cov_g);
  const cudaStream_t st = (cudaStream_t)stream;
#define CCO_LAUNCH(KG, VEC)                                                 \
  launch<FULL, KG, VEC>(zf, zg, num_valid, cross, mean_f, sq_f, mean_g, sq_g, \
                        cov_f, cov_g, n, d, st)
  if (n >= KG_MIN_N) return vec ? CCO_LAUNCH(2, true) : CCO_LAUNCH(2, false);
  return vec ? CCO_LAUNCH(1, true) : CCO_LAUNCH(1, false);
#undef CCO_LAUNCH
}

}  // namespace

// C interface, loaded with ctypes. All pointers are device pointers to
// contiguous f32 arrays; num_valid may be null. Each launches once on
// `stream` and returns the CUDA error (0 on success); neither
// synchronises.
extern "C" int cco_stats_cross_f32(const float* zf, const float* zg,
                                   const float* num_valid, float* cross,
                                   float* mean_f, float* sq_f, float* mean_g,
                                   float* sq_g, int n, int d, void* stream) {
  return dispatch<false>(zf, zg, num_valid, cross, mean_f, sq_f, mean_g, sq_g,
                         nullptr, nullptr, n, d, stream);
}

extern "C" int cco_stats_full_f32(const float* zf, const float* zg,
                                  const float* num_valid, float* cross,
                                  float* mean_f, float* sq_f, float* mean_g,
                                  float* sq_g, float* cov_f, float* cov_g,
                                  int n, int d, void* stream) {
  if (cov_f == nullptr || cov_g == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true>(zf, zg, num_valid, cross, mean_f, sq_f, mean_g, sq_g,
                        cov_f, cov_g, n, d, stream);
}
