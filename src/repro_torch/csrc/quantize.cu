// Fused stochastic-rounding quantize -> dequantize of wire payloads, f32,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quantize.py:
// _qdq_kernel (one scale per client row) and _qdq_kernel_2d (column-mapped
// per-leaf scales), both launched by quant_dequant_pallas. On (K, n) rows:
//   out = clip(floor(x / s + u), -qmax, qmax) * s
// where s = scales[row * s_row + col * s_col]: (s_row, s_col) = (1, 0) for
// scales of shape (K,), (n, 1) for scales of shape (K, n). One kernel
// serves both forms. The uniforms u are an operand, so the kernel equals
// its plain PyTorch version bit for bit given the same draws: the division
// is IEEE (no __fdividef, no --use_fast_math), and no multiply meets an
// add that FMA contraction could fuse. clip propagates NaN as torch.clamp
// and jnp.clip do.
//
// Design. Elementwise, bound by memory: each element is read once (x, u,
// and a scale for the column-mapped form) and written once. A 2-D grid puts
// rows on blockIdx.y (strided past 65535) and columns on blockIdx.x, with a
// grid-stride loop; offsets are 64-bit since K * n reaches 3.3e8. Where n
// is a multiple of 4 and every pointer is 16-byte aligned, each thread
// moves float4s; otherwise it runs the scalar loop (a ragged n).
//
// Bound on an H100 SXM at 3.35 TB/s, 16 bytes an element for the
// column-mapped form (x, u, s read, out written) and 12 for the per-row
// one: 1.57 ms for the (64, 5,136,704) phase-2 deltas of the full-width
// ResNet-14, 0.32 ms for the (64, 1,052,672) DCCO statistics payload, and
// 0.24 ms for a (64, 1,048,576) per-row call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float qdq(float x, float u, float s, float qmax) {
  float q = floorf(__fdiv_rn(x, s) + u);
  q = q < -qmax ? -qmax : (q > qmax ? qmax : q);
  return q * s;
}

// Scalar form: any n, any alignment.
__global__ void __launch_bounds__(THREADS)
qdq_kernel(const float* __restrict__ x, const float* __restrict__ u,
           const float* __restrict__ scales, float* __restrict__ out,
           int64_t k, int64_t n, int64_t s_row, int64_t s_col, float qmax) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t row = blockIdx.y; row < k; row += gridDim.y) {
    const int64_t base = row * n;
    const float* srow = scales + row * s_row;
    for (int64_t col = (int64_t)blockIdx.x * THREADS + threadIdx.x; col < n;
         col += stride) {
      out[base + col] = qdq(x[base + col], u[base + col], srow[col * s_col],
                            qmax);
    }
  }
}

// float4 form: n % 4 == 0 and 16-byte aligned pointers, so every row starts
// on a float4 boundary.
__global__ void __launch_bounds__(THREADS)
qdq_kernel_vec4(const float4* __restrict__ x, const float4* __restrict__ u,
                const float* __restrict__ scales, float4* __restrict__ out,
                int64_t k, int64_t n4, int64_t s_row, int64_t s_col,
                float qmax) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t row = blockIdx.y; row < k; row += gridDim.y) {
    const int64_t base = row * n4;
    const float* srow = scales + row * s_row;
    for (int64_t c4 = (int64_t)blockIdx.x * THREADS + threadIdx.x; c4 < n4;
         c4 += stride) {
      const float4 xv = x[base + c4];
      const float4 uv = u[base + c4];
      float4 sv;
      if (s_col == 0) {
        const float s = srow[0];
        sv = make_float4(s, s, s, s);
      } else {  // s_col == 1: the scale row is laid out like x
        sv = reinterpret_cast<const float4*>(srow)[c4];
      }
      float4 o;
      o.x = qdq(xv.x, uv.x, sv.x, qmax);
      o.y = qdq(xv.y, uv.y, sv.y, qmax);
      o.z = qdq(xv.z, uv.z, sv.z, qmax);
      o.w = qdq(xv.w, uv.w, sv.w, qmax);
      out[base + c4] = o;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// C interface, loaded with ctypes. x, u, out: device pointers to contiguous
// (k, n) f32; scales: (k,) f32 when scale_2d == 0, else (k, n) f32.
// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// does not synchronise.
extern "C" int quant_dequant_f32(const float* x, const float* u,
                                 const float* scales, float* out, int64_t k,
                                 int64_t n, int scale_2d, float qmax,
                                 void* stream) {
  if (k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int64_t s_row = scale_2d ? n : 1;
  const int64_t s_col = scale_2d ? 1 : 0;
  const bool vec = n % 4 == 0 && aligned16(x) && aligned16(u) &&
                   aligned16(out) && (!scale_2d || aligned16(scales));
  const int64_t items = vec ? n / 4 : n;
  int64_t gx = (items + THREADS - 1) / THREADS;
  if (gx > 65535) gx = 65535;
  const dim3 grid((unsigned)gx, (unsigned)(k < MAX_GRID_Y ? k : MAX_GRID_Y));
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    qdq_kernel_vec4<<<grid, THREADS, 0, st>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(u),
        scales, reinterpret_cast<float4*>(out), k, items, s_row, s_col, qmax);
  } else {
    qdq_kernel<<<grid, THREADS, 0, st>>>(x, u, scales, out, k, n, s_row,
                                         s_col, qmax);
  }
  return (int)cudaGetLastError();
}
