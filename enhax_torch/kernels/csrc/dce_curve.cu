// Zero-DCE curve application on Hopper (sm_90a).
//
// Two kernels, each the counterpart of a Pallas TPU kernel in
// enhax/kernels/dce_curve.py:
//
//   curve_upsample_apply  replaces fused_curve_upsample_apply. It reads the
//     curve at 1/s resolution, interpolates it (half-pixel bilinear, W axis
//     first, then H, source index (p+0.5)/s-0.5 clamped at the edges, which
//     is jax.image.resize and F.interpolate(align_corners=False) at an
//     integer ratio) and applies num_iters steps of y <- y + r(y^2 - y).
//     The full-resolution curve never reaches device memory.
//   curve_apply  replaces fused_curve_apply: the same loop over a curve at
//     full resolution, shared (N,H,W,C) or per iteration (N,H,W,C*iters),
//     where iteration i reads channel i*C + c of its pixel.
//
// Bound: both are memory-bound. The upsample kernel must move the image in,
// the output out and the low-resolution curve in: (2C + C/s^2) elements per
// pixel, 1.21 GB at (48,1088,1920,3) bf16, s=8, or 0.36 ms at 3.35 TB/s.
// Its arithmetic (about 40 flops an element) is far under the card's rate.
// The apply kernel moves (2C + R) elements per pixel, R = C*iters or C.
//
// Design: threads map to output elements (n,h,w,c) in grid-stride loops, so
// neighbouring threads read and write neighbouring addresses. The upsample
// kernel walks rows (n,h) on grid y, so the row's source index and weights
// are computed once per row; the four low-resolution taps it reads are 1/64
// of the image at s=8 and stay in L1/L2. A thread takes kPerThread elements
// of its row, blockDim apart, and loads all their image values before it
// computes: with one 2-byte load per thread too few bytes are in flight to
// cover the memory latency. The interpolated curve is rounded to the
// storage type, as the TPU kernel does; y stays in f32 through the
// iterations and is stored once.
//
// Entry points have a plain C interface for ctypes. They launch on the
// stream they are given, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kMaxGridY = 65535;
constexpr int kMaxBlocks = 1 << 20;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void curve_upsample_apply_kernel(const T* __restrict__ image,
                                            const T* __restrict__ curves_lr,
                                            T* __restrict__ out, int rows, int H,
                                            int W, int C, int HL, int WL, int s,
                                            int num_iters) {
  const int row_len = W * C;
  const float inv_s = 1.0f / static_cast<float>(s);
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int n = row / H;
    const int h = row - n * H;
    const float sh = fmaxf((static_cast<float>(h) + 0.5f) * inv_s - 0.5f, 0.0f);
    const int h0 = static_cast<int>(sh);
    const int h1 = min(h0 + 1, HL - 1);
    const float ah = sh - static_cast<float>(h0);
    const T* lr0 = curves_lr + (static_cast<int64_t>(n) * HL + h0) * WL * C;
    const T* lr1 = curves_lr + (static_cast<int64_t>(n) * HL + h1) * WL * C;
    const T* x = image + static_cast<int64_t>(row) * row_len;
    T* o = out + static_cast<int64_t>(row) * row_len;
    const int stride = gridDim.x * blockDim.x * kPerThread;
    for (int j0 = blockIdx.x * blockDim.x * kPerThread + threadIdx.x; j0 < row_len;
         j0 += stride) {
      float xv[kPerThread];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int j = j0 + k * blockDim.x;
        xv[k] = j < row_len ? to_f32(x[j]) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int j = j0 + k * blockDim.x;
        if (j >= row_len) break;
        const int w = j / C;
        const int c = j - w * C;
        const float sw = fmaxf((static_cast<float>(w) + 0.5f) * inv_s - 0.5f, 0.0f);
        const int w0 = static_cast<int>(sw);
        const int w1 = min(w0 + 1, WL - 1);
        const float aw = sw - static_cast<float>(w0);
        const float top = to_f32(lr0[w0 * C + c]) * (1.0f - aw) + to_f32(lr0[w1 * C + c]) * aw;
        const float bot = to_f32(lr1[w0 * C + c]) * (1.0f - aw) + to_f32(lr1[w1 * C + c]) * aw;
        const float r = to_f32(from_f32<T>(top * (1.0f - ah) + bot * ah));
        float y = xv[k];
        for (int i = 0; i < num_iters; ++i) y = y + r * (y * y - y);
        o[j] = from_f32<T>(y);
      }
    }
  }
}

template <typename T>
__global__ void curve_apply_kernel(const T* __restrict__ image,
                                   const T* __restrict__ curves,
                                   T* __restrict__ out, int64_t total, int C,
                                   int rc, int num_iters, int shared) {
  const int step = shared ? 0 : C;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t p = idx / C;
    const int c = static_cast<int>(idx - p * C);
    const T* r = curves + p * rc + c;
    float y = to_f32(image[idx]);
    for (int i = 0; i < num_iters; ++i) {
      const float ri = to_f32(r[i * step]);
      y = y + ri * (y * y - y);
    }
    out[idx] = from_f32<T>(y);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. H and W are multiples of scale.
extern "C" int dce_curve_upsample_apply(const void* image, const void* curves_lr,
                                        void* out, int dtype, int n, int h, int w,
                                        int c, int scale, int num_iters,
                                        void* stream) {
  const int rows = n * h;
  const int row_len = w * c;
  if (rows == 0 || row_len == 0) return 0;
  const dim3 block(kThreads);
  const int per_block = kThreads * kPerThread;
  const dim3 grid((row_len + per_block - 1) / per_block, rows < kMaxGridY ? rows : kMaxGridY);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hl = h / scale, wl = w / scale;
  if (dtype == 0) {
    curve_upsample_apply_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(image), static_cast<const float*>(curves_lr),
        static_cast<float*>(out), rows, h, w, c, hl, wl, scale, num_iters);
  } else if (dtype == 1) {
    curve_upsample_apply_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(image),
        static_cast<const __nv_bfloat16*>(curves_lr),
        static_cast<__nv_bfloat16*>(out), rows, h, w, c, hl, wl, scale, num_iters);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// curves holds rc = c (shared) or c * num_iters (per iteration) channels.
extern "C" int dce_curve_apply(const void* image, const void* curves, void* out,
                               int dtype, int64_t total, int c, int rc,
                               int num_iters, int shared, void* stream) {
  if (total == 0) return 0;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks));
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    curve_apply_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(image), static_cast<const float*>(curves),
        static_cast<float*>(out), total, c, rc, num_iters, shared);
  } else if (dtype == 1) {
    curve_apply_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(image),
        static_cast<const __nv_bfloat16*>(curves),
        static_cast<__nv_bfloat16*>(out), total, c, rc, num_iters, shared);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
