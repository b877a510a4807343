// Zero-DCE curve application on Hopper (sm_90a).
//
// Two kernels, each the counterpart of a Pallas TPU kernel in
// enhax/kernels/dce_curve.py:
//
//   curve_upsample_apply  replaces fused_curve_upsample_apply (:81, its
//     pallas_call at :139). It reads the curve at 1/s resolution,
//     interpolates it (half-pixel bilinear, W axis first, then H, source
//     index (p+0.5)/s-0.5 clamped at the edges, which is jax.image.resize
//     and F.interpolate(align_corners=False) at an integer ratio), rounds it
//     once to the storage type and applies num_iters steps of
//     y <- y + r(y^2 - y), y in f32, stored once. The full-resolution curve
//     never reaches device memory. Two paths, picked by the wrapper before
//     the launch (dce_curve.upsample_path):
//       "vec"      C = 3, s in {2, 4, 8}, W % 8 == 0, x and out 16-byte
//                  aligned (always so behind Predictor, which pads to 32);
//       "general"  any C and s: the first design, kept as it was.
//   curve_apply  replaces fused_curve_apply (:28): the same loop over a
//     curve at full resolution, shared (N,H,W,C) or per iteration
//     (N,H,W,C*iters), where iteration i reads channel i*C + c of its pixel.
//
// Bound: both are memory-bound. The upsample kernel must move the image in,
// the output out and the low-resolution curve in: (2C + C/s^2) elements a
// pixel, 1.2126 GB at (48,1088,1920,3) bf16, s=8, or 0.3620 ms at
// 3.35 TB/s. Its arithmetic (about 40 flops an element) is far under the
// card's rate, but not under its issue rate if every element pays for its
// own index arithmetic and interpolation. The apply kernel moves (2C + R)
// elements a pixel, R = C*iters or C.
//
// "vec" design: a thread owns 8 consecutive pixels (24 values) of a row and
// walks down a band of 16 output rows (16/s low-resolution rows); a warp's
// 32 threads own 32 neighbouring groups of one band (a work item), and a
// resident grid from the occupancy API walks the items. The thread reads
// the 8/s + 2 low-resolution columns its pixels need from one
// low-resolution row, interpolates them in W once into 24 registers (the W
// phase weights are compile-time constants) and reuses that row for the 2s
// output rows that lie between it and its neighbours: each output row only
// blends two such rows in H with one weight. No integer division inside
// the row loop. A warp loads and stores its 1536-byte span of a row (bf16)
// as 16-byte vectors, lane l taking vectors l, l + 32 and l + 64, so each
// instruction moves 512 contiguous bytes, and hands each thread its own 48
// bytes through shared memory. A thread's own 48 bytes straight from
// global memory (three vectors 48 bytes apart) took 0.54 ms, the warp's
// span 0.46 ms (H100, PERF.md). x is read with the evict-first hint
// (ld.global.cs) two rows ahead of the arithmetic, out written with
// streaming stores (st.global.cs). bf16 caps registers at 128 for 16 warps
// an SM (a few bytes spilled): 12 warps at 143 registers were 6% slower.
//
// "general" design (the first one): threads map to output elements
// (n,h,w,c) in grid-stride loops, rows (n,h) on grid y (at most 65535, the
// kernel loops over the rest), so the row's source index and weights are
// computed once per row; a thread takes kPerThread elements of its row,
// blockDim apart, and loads all their image values before it computes.
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

// ------------------------------------------------------------ "vec" path ---

constexpr int kVecThreads = 128;
constexpr int kVecPixels = 8;                // consecutive pixels a thread
constexpr int kVecValues = 3 * kVecPixels;   // C = 3
constexpr int kBandRows = 16;                // output rows a work item
constexpr int kAhead = 2;                    // rows of x loaded ahead
// a band's rows are a multiple of s >= 2, so of kAhead: no partial step
static_assert(2 % kAhead == 0, "kAhead must divide every scale");

template <typename T>
struct Vec {
  static constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // values in 16 bytes
  static constexpr int kVecs = kVecValues / kPer;                 // 16-byte vectors a row
};

// two bf16 in the low and high halves of a word, rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// 16 bytes of the storage type as float32 values, and back
__device__ __forceinline__ void unpack(const uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = bf16_lo(w[i]);
    v[2 * i + 1] = bf16_hi(w[i]);
  }
}
__device__ __forceinline__ void unpack(const uint4 u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                    pack_bf16x2(v[6], v[7]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
// the interpolated curve rounded to the storage type
__device__ __forceinline__ void round_to_storage(float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = pack_bf16x2(v[2 * i], v[2 * i + 1]);
    v[2 * i] = bf16_lo(w);
    v[2 * i + 1] = bf16_hi(w);
  }
}
__device__ __forceinline__ void round_to_storage(float (&)[4]) {}

// Work item of a warp: (image n, band of kBandRows output rows, chunk of 32
// groups of 8 pixels); lane l owns group q = 32 chunk + l, and a lane past
// the row's last group computes on a clamped copy and stores nothing. The
// warp's 32 groups are one contiguous span of a row, so it loads and stores
// the span coalesced (lane l the 16-byte vectors l, l + 32, ...) and passes
// each lane its own 8 pixels through a staging buffer in shared memory
// (lane l's at 48 l bytes in bf16: conflict-free 16-byte accesses). The W
// pass of low-resolution row l is the lane's 24 values interpolated in W
// from its columns; output row h = s*l + p (phase p) blends the W passes of
// rows (l-1, l) for p < s/2 and (l, l+1) for p >= s/2 (clamped), so the
// pair only moves down at p = s/2. Weights as the general path's:
// a*(1-t) + b*t with t = src - floor(src), src = max((i+0.5)/s - 0.5, 0).
template <typename T, int S>
__global__ void __launch_bounds__(kVecThreads, sizeof(T) == 2 ? 4 : 1)
curve_upsample_vec_kernel(const T* __restrict__ image, const T* __restrict__ curves_lr,
                          T* __restrict__ out, int H, int W, int HL, int WL, int groups,
                          int chunks, int bands, int64_t items, int num_iters) {
  using V = Vec<T>;
  constexpr int NB = kBandRows / S;              // low-resolution rows a band
  constexpr int NCOL = kVecPixels / S + 2;       // low-resolution columns a lane reads
  constexpr int SPAN = 32 * V::kVecs;            // a warp's span of a row, in vectors
  constexpr int WARPS = kVecThreads / 32;
  __shared__ uint4 stage[WARPS][2][SPAN];        // a warp's x in and out
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4* const xin = stage[warp][0];
  uint4* const xout = stage[warp][1];
  const int64_t row_vecs = static_cast<int64_t>(W) * 3 / V::kPer;  // a row in vectors
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * WARPS + warp; item < items;
       item += static_cast<int64_t>(gridDim.x) * WARPS) {
    const int64_t nb = item / chunks;            // n * bands + band
    const int chunk = static_cast<int>(item - nb * chunks);
    const int n = static_cast<int>(nb / bands);
    const int hl0 = static_cast<int>(nb - static_cast<int64_t>(n) * bands) * NB;
    const int nrows = min(NB, HL - hl0) * S;
    const int span = min(SPAN, (groups - chunk * 32) * V::kVecs);  // the span's vectors
    const int q = min(chunk * 32 + lane, groups - 1);
    // the columns the lane's pixels read: its own 8/s, one more on each
    // side, clamped (a clamped column only ever meets a weight that makes it
    // the general path's value)
    int col[NCOL];
#pragma unroll
    for (int j = 0; j < NCOL; ++j)
      col[j] = min(max(q * (kVecPixels / S) - 1 + j, 0), WL - 1) * 3;
    const bool left = q == 0;
    const T* lr = curves_lr + static_cast<int64_t>(n) * HL * WL * 3;
    float lv[NCOL * 3];  // the next low-resolution row's columns, loaded ahead
    auto fetch = [&](int l, float (&dst)[NCOL * 3]) {
      const T* row = lr + static_cast<int64_t>(min(l, HL - 1)) * WL * 3;
#pragma unroll
      for (int j = 0; j < NCOL; ++j)
#pragma unroll
        for (int c = 0; c < 3; ++c) dst[3 * j + c] = to_f32(__ldg(row + col[j] + c));
    };
    auto w_pass = [&](const float (&src)[NCOL * 3], float (&rw)[kVecValues]) {
#pragma unroll
      for (int k = 0; k < kVecPixels; ++k) {
        const int blk = k / S, p = k % S;        // compile-time after unrolling
        const bool lo = 2 * p < S;
        const float t = lo ? ((blk == 0 && left) ? 0.f : 0.5f + (p + 0.5f) / S)
                           : (p + 0.5f) / S - 0.5f;
        const int j0 = lo ? blk : blk + 1;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          rw[3 * k + c] = src[3 * j0 + c] * (1.0f - t) + src[3 * (j0 + 1) + c] * t;
      }
    };
    const int64_t first = (static_cast<int64_t>(n) * H + static_cast<int64_t>(hl0) * S) * row_vecs +
                          static_cast<int64_t>(chunk) * SPAN;
    const uint4* xp = reinterpret_cast<const uint4*>(image) + first;
    uint4* op = reinterpret_cast<uint4*>(out) + first;
    uint4 buf[kAhead][V::kVecs];                 // lane's vectors l, l + 32, ... of a row
#pragma unroll
    for (int d = 0; d < kAhead; ++d)
#pragma unroll
      for (int k = 0; k < V::kVecs; ++k)
        buf[d][k] = lane + 32 * k < span ? __ldcs(xp + d * row_vecs + lane + 32 * k)
                                         : make_uint4(0, 0, 0, 0);
    float wa[kVecValues], wb[kVecValues];        // W passes of rows (l-1, l) or (l, l+1)
    float lv2[NCOL * 3];
    fetch(hl0 - 1 < 0 ? 0 : hl0 - 1, lv);
    fetch(hl0, lv2);
    w_pass(lv, wa);
    w_pass(lv2, wb);
    fetch(hl0 + 1, lv);
    for (int i0 = 0; i0 < nrows; i0 += kAhead) {
#pragma unroll
      for (int d = 0; d < kAhead; ++d) {
        const int i = i0 + d;
        const int p = i & (S - 1);
        const int l = hl0 + i / S;
        if (2 * p == S) {  // the pair moves down: (l, l+1)
#pragma unroll
          for (int e = 0; e < kVecValues; ++e) wa[e] = wb[e];
          w_pass(lv, wb);
          fetch(l + 2, lv);
        }
        const float th = 2 * p < S ? (l == 0 ? 0.f : 0.5f + (p + 0.5f) / S)
                                   : (p + 0.5f) / S - 0.5f;
        const float ts = 1.0f - th;
#pragma unroll
        for (int k = 0; k < V::kVecs; ++k) xin[lane + 32 * k] = buf[d][k];
        __syncwarp();
#pragma unroll
        for (int v = 0; v < V::kVecs; ++v) {
          float y[V::kPer], r[V::kPer];
          unpack(xin[lane * V::kVecs + v], y);
#pragma unroll
          for (int e = 0; e < V::kPer; ++e) r[e] = wa[v * V::kPer + e] * ts + wb[v * V::kPer + e] * th;
          round_to_storage(r);
#pragma unroll 4
          for (int it = 0; it < num_iters; ++it)
#pragma unroll
            for (int e = 0; e < V::kPer; ++e) y[e] = y[e] + r[e] * (y[e] * y[e] - y[e]);
          xout[lane * V::kVecs + v] = pack(y);
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < V::kVecs; ++k)
          if (lane + 32 * k < span) __stcs(op + i * row_vecs + lane + 32 * k, xout[lane + 32 * k]);
        if (i + kAhead < nrows)
#pragma unroll
          for (int k = 0; k < V::kVecs; ++k)
            if (lane + 32 * k < span)
              buf[d][k] = __ldcs(xp + (i + kAhead) * row_vecs + lane + 32 * k);
      }
    }
  }
}

// How many blocks of the kernel fit on the card at once.
template <typename F>
cudaError_t resident_blocks(F kernel, int threads, int* out) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  *out = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

template <typename T, int S>
int launch_vec(const void* image, const void* curves_lr, void* out, int n, int h, int w,
               int num_iters, cudaStream_t st) {
  auto kernel = curve_upsample_vec_kernel<T, S>;
  int resident = 0;
  const cudaError_t err = resident_blocks(kernel, kVecThreads, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hl = h / S, wl = w / S, groups = w / kVecPixels, chunks = (groups + 31) / 32;
  const int bands = (hl + kBandRows / S - 1) / (kBandRows / S);
  const int64_t items = static_cast<int64_t>(n) * bands * chunks;  // a warp each
  const int64_t want = (items + kVecThreads / 32 - 1) / (kVecThreads / 32);
  const int grid = static_cast<int>(want < resident ? want : resident);
  kernel<<<grid, kVecThreads, 0, st>>>(static_cast<const T*>(image),
                                       static_cast<const T*>(curves_lr), static_cast<T*>(out),
                                       h, w, hl, wl, groups, chunks, bands, items, num_iters);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vec_scale(const void* image, const void* curves_lr, void* out, int n, int h, int w,
                     int scale, int num_iters, cudaStream_t st) {
  switch (scale) {
    case 2: return launch_vec<T, 2>(image, curves_lr, out, n, h, w, num_iters, st);
    case 4: return launch_vec<T, 4>(image, curves_lr, out, n, h, w, num_iters, st);
    case 8: return launch_vec<T, 8>(image, curves_lr, out, n, h, w, num_iters, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. H and W are multiples of scale. path:
// 0 = "general", 1 = "vec" (C = 3, scale 2, 4 or 8, W % 8 == 0, image and
// out 16-byte aligned; anything else is refused).
extern "C" int dce_curve_upsample_apply(const void* image, const void* curves_lr,
                                        void* out, int dtype, int n, int h, int w,
                                        int c, int scale, int num_iters, int path,
                                        void* stream) {
  const int rows = n * h;
  const int row_len = w * c;
  if (rows == 0 || row_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    const bool aligned = (reinterpret_cast<uintptr_t>(image) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
    if (c != 3 || scale <= 0 || w % kVecPixels != 0 || h % scale != 0 || !aligned)
      return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0) return launch_vec_scale<float>(image, curves_lr, out, n, h, w, scale, num_iters, st);
    if (dtype == 1)
      return launch_vec_scale<__nv_bfloat16>(image, curves_lr, out, n, h, w, scale, num_iters, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (path != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreads);
  const int per_block = kThreads * kPerThread;
  const dim3 grid((row_len + per_block - 1) / per_block, rows < kMaxGridY ? rows : kMaxGridY);
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
