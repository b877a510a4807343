// A bias-free depthwise 3x3 over an NHWC tensor on Hopper (sm_90a): f32
// sums, the output in x's type (float32 or bfloat16).
//
// Replaces the Pallas TPU kernel dw_kernel of run/probe_dw_roofline.py
// (pallas_call at :98, kernel at :49), the dw-only roofline probe of the
// fused Restormer block's taps. Its three variants compute two functions:
//   rows = 0 ("zero"): dw_base and dw_fma, SAME zero padding. The two differ
//     only in how the TPU kernel orders its multiplies and adds; on the card
//     they are one kernel.
//   rows = 1 ("edge"): dw_nomask, the halo rows left unmasked. The probe's
//     clamped halo index maps then repeat the first and last image rows, so
//     H is edge-replicated and W zero-padded.
// Taps k (3, 3, C) arrive as float32 (exact for bf16 taps). The sum runs
// over dx, then dh, as the TPU kernel's does.
//
// Bound: bytes. Each input element is read once and each output written once
// for 18 flops: at (15, 256, 256, 288) bf16 that is 1.1325 GB, 0.338 ms at
// 3.35 TB/s, against 0.038 ms of f32 work. Design: a thread owns a vector
// of 4 channels (16 bytes of f32, 8 of bf16) of one column and walks down a
// strip of 16 output rows with its 9 x 4 taps and a window of three input
// rows (3 x 3 vectors) in registers, so each input row is loaded once by the
// thread and its two W neighbours' loads of the same row hit L1;
// neighbouring threads hold neighbouring vectors of a pixel row, so a warp's
// loads are contiguous. The next row's loads are in flight while the current
// row is summed. A memory-bound kernel needs loads in flight: the vector of 4
// keeps a thread under 128 registers, two blocks of 256 threads an SM (a
// vector of 8 bf16 needed 168 registers, one block an SM; PERF.md has both
// versions' times). Where C is not a multiple of 4 (or x
// is not aligned to 4 elements) the same kernel runs with one channel a
// thread.
//
// Plain C interface for ctypes: launches on the stream it is given,
// allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 16;  // output rows a thread walks down

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A vector of channels: 4 (16 bytes of f32, 8 of bf16) or 1
template <typename T, int VEC>
struct Raw;
template <> struct Raw<float, 4> { using type = uint4; };
template <> struct Raw<__nv_bfloat16, 4> { using type = uint2; };

// VEC values from p (one vector load for VEC > 1)
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(p[0]);
  } else {
    using R = typename Raw<T, VEC>::type;
    const R raw = *reinterpret_cast<const R*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f32(e[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_f32<T>(v[0]);
  } else {
    using R = typename Raw<T, VEC>::type;
    R raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = from_f32<T>(v[j]);
    *reinterpret_cast<R*>(p) = raw;
  }
}

// the three vectors of input row hr around column w (zero outside the image;
// rows clamped into it for edge)
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* xn, int hr, int w, int c0, int H, int W,
                                         int C, int edge, float (&row)[3][VEC]) {
  int src = hr;
  bool row_in = hr >= 0 && hr < H;
  if (edge) {
    src = min(max(hr, 0), H - 1);
    row_in = true;
  }
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int col = w + dx - 1;
    if (row_in && col >= 0 && col < W) {
      load<T, VEC>(xn + (static_cast<int64_t>(src) * W + col) * C + c0, row[dx]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) row[dx][j] = 0.f;
    }
  }
}

// grid (ceil(W C / VEC / kThreads), ceil(H / kStrip), B)
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2) dw3x3_kernel(const T* __restrict__ x,
                                                            const float* __restrict__ k,
                                                            T* __restrict__ out, int H, int W,
                                                            int C, int edge) {
  const int cv = C / VEC;
  const int e = blockIdx.x * kThreads + threadIdx.x;  // (column, vector) of a row
  if (e >= W * cv) return;
  const int w = e / cv, c0 = (e - w * cv) * VEC;
  const int h0 = blockIdx.y * kStrip;
  const int h1 = min(h0 + kStrip, H);
  const T* xn = x + static_cast<int64_t>(blockIdx.z) * H * W * C;
  T* on = out + static_cast<int64_t>(blockIdx.z) * H * W * C;

  float tap[9][VEC];  // [3 dh + dx][channel]
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < VEC; ++j) tap[t][j] = __ldg(k + t * C + c0 + j);

  // the window of three input rows, oldest first; it moves down one row a
  // step by register moves (every index known at compile time), and the
  // next row's loads are issued before the current row's sums
  float win[3][3][VEC];  // [row][dx][channel]
  float next[3][VEC];
  load_row<T, VEC>(xn, h0 - 1, w, c0, H, W, C, edge, win[1]);
  load_row<T, VEC>(xn, h0, w, c0, H, W, C, edge, win[2]);
  load_row<T, VEC>(xn, h0 + 1, w, c0, H, W, C, edge, next);
  for (int r = h0; r < h1; ++r) {  // output row r needs input rows r - 1 .. r + 1
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        win[0][dx][j] = win[1][dx][j];
        win[1][dx][j] = win[2][dx][j];
        win[2][dx][j] = next[dx][j];
      }
    if (r + 1 < h1) load_row<T, VEC>(xn, r + 2, w, c0, H, W, C, edge, next);
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = fmaf(win[dh][dx][j], tap[3 * dh + dx][j], acc[j]);
    store<T, VEC>(on + (static_cast<int64_t>(r) * W + w) * C + c0, acc);
  }
}

template <typename T, int VEC>
int launch(const void* x, const float* k, void* out, int b, int h, int w, int c, int edge,
           cudaStream_t st) {
  const int64_t row_items = static_cast<int64_t>(w) * (c / VEC);
  const int64_t bx = (row_items + kThreads - 1) / kThreads;
  const int by = (h + kStrip - 1) / kStrip;
  if (bx > INT32_MAX || by > 65535 || b > 65535 || row_items > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  dw3x3_kernel<T, VEC><<<dim3(static_cast<unsigned>(bx), by, b), kThreads, 0, st>>>(
      static_cast<const T*>(x), k, static_cast<T*>(out), h, w, c, edge);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (b, h, w, c) NHWC contiguous; k (3, 3, c) float32. dtype: 0 =
// float32, 1 = bfloat16. rows: 0 = zero padding, 1 = edge rows repeated.
// vec: c is a multiple of 4 and x, out are aligned to 4 elements.
extern "C" int dw3x3_apply(const void* x, const void* k, void* out, int dtype, int b, int h,
                           int w, int c, int rows, int vec, void* stream) {
  if (b == 0 || h == 0 || w == 0 || c == 0) return 0;
  if (rows != 0 && rows != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kf = static_cast<const float*>(k);
  if (dtype == 0)
    return vec ? launch<float, 4>(x, kf, out, b, h, w, c, rows, st)
               : launch<float, 1>(x, kf, out, b, h, w, c, rows, st);
  if (dtype == 1)
    return vec ? launch<__nv_bfloat16, 4>(x, kf, out, b, h, w, c, rows, st)
               : launch<__nv_bfloat16, 1>(x, kf, out, b, h, w, c, rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
