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
//     Two paths, picked by the wrapper before the launch
//     (dce_curve.apply_path):
//       "vec"      image, curves and out 16-byte aligned, and a shared curve
//                  of any C (curve_apply_flat_kernel) or per-iteration
//                  curves at C = 3 with 8 iterations, the count every
//                  Zero-DCE config sends (curve_apply_span_kernel);
//       "general"  anything else (Zero-DCE-V's C = 1 with 15 curves, any
//                  other count): the first design, kept as it was
//                  (curve_apply_kernel).
//
// Bound: both are memory-bound. The upsample kernel must move the image in,
// the output out and the low-resolution curve in: (2C + C/s^2) elements a
// pixel, 1.2126 GB at (48,1088,1920,3) bf16, s=8, or 0.3620 ms at
// 3.35 TB/s. Its arithmetic (about 40 flops an element) is far under the
// card's rate, but not under its issue rate if every element pays for its
// own index arithmetic and interpolation. The apply kernel moves (2C + R)
// elements a pixel, R = C*iters or C: 0.1510 GB at SGZ's (4,1092,1920,3)
// shared in bf16 (0.0451 ms), 0.1253 GB at Zero-DCE's (1,1088,1920,3) with
// 24 curves (0.0374 ms); twice that in float32. Its 16 flops an element
// (8 iterations of two fused multiply-adds) are not what bounds it, but
// the first design spent a 64-bit division by C and a scalar 2- or 4-byte
// load and store on every element: the same instructions in both dtypes,
// so bf16 was issue-bound and slower than float32 (0.1665 against
// 0.1446 ms at SGZ's shape, PERF.md).
//
// The apply kernel's "vec" paths move 16-byte vectors only: a flat pass
// for a shared curve (no channel index at all), and for per-iteration
// curves a warp that loads its contiguous span of x and of the curves
// coalesced and hands each lane its own pixels through shared memory, as
// the upsample's "vec" path does. Both launch one block a chunk (one warp
// an item): a resident grid walking the chunks, tried first, was the
// slower in every cell. Device time (chip_smoke.py's apply_turns, H100
// 80GB HBM3 at 700 W, 5 alternating turns of 20 launches into one
// output, PERF.md): shared bf16 0.0541 ms (83.3% of the bound, the first
// design 0.1633 ms, torch.add of the same bytes 0.0534 ms), float32
// 0.1028 ms (87.7%); 24 curves bf16 0.0473 ms (79.1%, the first design
// 0.0528 ms), float32 0.0895 ms (83.6%, the first design 0.0881 ms: kept
// on "vec", within 2% of it). Through the wrapper a call also pays 24-48
// us of host time, which can pace 8 launches at these sizes; the span
// kernel's 28 KB of shared memory need no opt-in, so no driver call is
// added to the launch. Both paths round the same way: y in float32
// through two fused multiply-adds an iteration, stored once.
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

// ------------------------------------------------ curve_apply "vec" path ---

// Shared curve: a flat pass over the values. A block's chunk is kFlatVecs
// 16-byte vectors of x and as many of r a thread, thread t taking vectors
// t, t + kFlatThreads, ...: all its loads go out before any arithmetic.
// One block a chunk (the grid walks the chunks only past kMaxBlocks). The
// values past the last whole vector (fewer than one vector) are the last
// block's.
constexpr int kFlatThreads = 256;
constexpr int kFlatVecs = 2;
constexpr int kFlatChunk = kFlatThreads * kFlatVecs;

template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
curve_apply_flat_kernel(const T* __restrict__ image, const T* __restrict__ curves,
                        T* __restrict__ out, int64_t nvec, int tail, int num_iters) {
  constexpr int kPer = Vec<T>::kPer;
  const int64_t chunks = (nvec + kFlatChunk - 1) / kFlatChunk;
  for (int64_t chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const int64_t first = chunk * kFlatChunk;
    const int n = static_cast<int>(nvec - first < kFlatChunk ? nvec - first : kFlatChunk);
    const uint4* xc = reinterpret_cast<const uint4*>(image) + first;
    const uint4* rc = reinterpret_cast<const uint4*>(curves) + first;
    uint4* oc = reinterpret_cast<uint4*>(out) + first;
    uint4 xv[kFlatVecs], rv[kFlatVecs];
#pragma unroll
    for (int k = 0; k < kFlatVecs; ++k) {
      const int j = threadIdx.x + k * kFlatThreads;
      if (j < n) {
        xv[k] = __ldcs(xc + j);
        rv[k] = __ldcs(rc + j);
      }
    }
#pragma unroll
    for (int k = 0; k < kFlatVecs; ++k) {
      const int j = threadIdx.x + k * kFlatThreads;
      if (j < n) {
        float y[kPer], r[kPer];
        unpack(xv[k], y);
        unpack(rv[k], r);
#pragma unroll 2
        for (int it = 0; it < num_iters; ++it)
#pragma unroll
          for (int e = 0; e < kPer; ++e) y[e] = y[e] + r[e] * (y[e] * y[e] - y[e]);
        __stcs(oc + j, pack(y));
      }
    }
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < tail) {
    const int64_t i = nvec * kPer + threadIdx.x;
    float y = to_f32(image[i]);
    const float r = to_f32(curves[i]);
    for (int it = 0; it < num_iters; ++it) y = y + r * (y * y - y);
    out[i] = from_f32<T>(y);
  }
}

// Per-iteration curves at C = 3: a lane owns kPix consecutive pixels (48
// bytes of x: 8 pixels in bf16, 4 in float32), a warp's item the 32 lanes'
// kItem pixels (flat over N*H*W), one item a warp. The warp copies its
// contiguous span of x and of the curves into shared memory as 16-byte
// vectors (cp.async, lane l vectors l, l + 32, ...), into one region a
// lane; each lane reads its own region back. Regions are an odd number of
// vectors apart, so a quarter-warp's 16-byte reads fall on distinct banks.
// The lane's curve values come in storage order (pixel, iteration,
// channel): with ITERS fixed at compile time each value's pixel and channel
// are constants, and the lane's y values stay in registers. The output
// goes back into the lane's x region and out coalesced. A short last item
// is copied element by element.
constexpr int kSpanWarps = 2;
constexpr int kSpanIters = 8;  // the only count instantiated

template <typename T, int ITERS>
struct Span {
  static constexpr int kPer = Vec<T>::kPer;
  static constexpr int kPix = 16 / static_cast<int>(sizeof(T));  // pixels a lane
  static constexpr int kItem = 32 * kPix;                // pixels a warp
  static constexpr int kVals = 3 * kPix;                 // x values a lane
  static constexpr int kRC = 3 * ITERS;                  // curve values a pixel
  static constexpr int kXV = kVals / kPer;               // x vectors a lane: 3
  static constexpr int kRV = kPix * kRC / kPer;          // curve vectors a lane: 3 ITERS
  static constexpr int kXS = kXV | 1;                    // region strides, odd
  static constexpr int kRS = kRV | 1;
  static constexpr int kWarpVecs = 32 * (kXS + kRS);     // a warp's shared memory
  static constexpr int kBytes = kSpanWarps * kWarpVecs * 16;
};

// vector v of a warp's span in regions of NV vectors at stride S
template <int NV, int S>
__device__ __forceinline__ int region_pos(int v) { return v / NV * S + v % NV; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, int ITERS>
__global__ void __launch_bounds__(32 * kSpanWarps)
curve_apply_span_kernel(const T* __restrict__ image, const T* __restrict__ curves,
                        T* __restrict__ out, int64_t pixels, int64_t items) {
  using S = Span<T, ITERS>;
  constexpr int kPer = S::kPer;
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4* const xs = smem + warp * S::kWarpVecs;          // x in, then y out
  uint4* const rs = xs + 32 * S::kXS;                    // the curves
  T* const xe = reinterpret_cast<T*>(xs);
  T* const re = reinterpret_cast<T*>(rs);
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * kSpanWarps + warp; item < items;
       item += static_cast<int64_t>(gridDim.x) * kSpanWarps) {
    const int64_t p0 = item * S::kItem;
    const int np = static_cast<int>(pixels - p0 < S::kItem ? pixels - p0 : S::kItem);
    const T* xg = image + p0 * 3;
    const T* rg = curves + p0 * S::kRC;
    T* og = out + p0 * 3;
    if (np == S::kItem) {
#pragma unroll
      for (int j = 0; j < S::kXV; ++j) {
        const int v = lane + 32 * j;
        cp_async16(xs + region_pos<S::kXV, S::kXS>(v), reinterpret_cast<const uint4*>(xg) + v);
      }
#pragma unroll
      for (int j = 0; j < S::kRV; ++j) {
        const int v = lane + 32 * j;
        cp_async16(rs + region_pos<S::kRV, S::kRS>(v), reinterpret_cast<const uint4*>(rg) + v);
      }
      cp_async_wait_all();
    } else {
      for (int e = lane; e < np * 3; e += 32)
        xe[region_pos<S::kXV, S::kXS>(e / kPer) * kPer + e % kPer] = xg[e];
      for (int e = lane; e < np * S::kRC; e += 32)
        re[region_pos<S::kRV, S::kRS>(e / kPer) * kPer + e % kPer] = rg[e];
    }
    __syncwarp();
    float y[S::kVals];
#pragma unroll
    for (int k = 0; k < S::kXV; ++k) {
      float v[kPer];
      unpack(xs[lane * S::kXS + k], v);
#pragma unroll
      for (int e = 0; e < kPer; ++e) y[k * kPer + e] = v[e];
    }
#pragma unroll
    for (int k = 0; k < S::kRV; ++k) {
      float r[kPer];
      unpack(rs[lane * S::kRS + k], r);
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int q = k * kPer + e;                      // (pixel, iteration, channel)
        float& yv = y[q / S::kRC * 3 + q % 3];
        yv = yv + r[e] * (yv * yv - yv);
      }
    }
#pragma unroll
    for (int k = 0; k < S::kXV; ++k) {
      float v[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) v[e] = y[k * kPer + e];
      xs[lane * S::kXS + k] = pack(v);
    }
    __syncwarp();
    if (np == S::kItem) {
#pragma unroll
      for (int j = 0; j < S::kXV; ++j) {
        const int v = lane + 32 * j;
        __stcs(reinterpret_cast<uint4*>(og) + v, xs[region_pos<S::kXV, S::kXS>(v)]);
      }
    } else {
      for (int e = lane; e < np * 3; e += 32)
        og[e] = xe[region_pos<S::kXV, S::kXS>(e / kPer) * kPer + e % kPer];
    }
    __syncwarp();  // the regions are free for the next item
  }
}

template <typename T>
int launch_flat(const void* image, const void* curves, void* out, int64_t total, int num_iters,
                cudaStream_t st) {
  const int64_t nvec = total / Vec<T>::kPer;
  const int tail = static_cast<int>(total - nvec * Vec<T>::kPer);
  const int64_t chunks = (nvec + kFlatChunk - 1) / kFlatChunk;
  const int grid = static_cast<int>(chunks < 1 ? 1 : (chunks < kMaxBlocks ? chunks : kMaxBlocks));
  curve_apply_flat_kernel<T><<<grid, kFlatThreads, 0, st>>>(
      static_cast<const T*>(image), static_cast<const T*>(curves), static_cast<T*>(out), nvec,
      tail, num_iters);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ITERS>
int launch_span(const void* image, const void* curves, void* out, int64_t pixels,
                cudaStream_t st) {
  auto kernel = curve_apply_span_kernel<T, ITERS>;
  using S = Span<T, ITERS>;
  // under the 48 KB a launch takes without an opt-in (a driver call on
  // the host's path at every launch)
  static_assert(S::kBytes <= 48 * 1024, "the span needs a shared-memory opt-in");
  const int64_t items = (pixels + S::kItem - 1) / S::kItem;  // a warp each
  const int64_t want = (items + kSpanWarps - 1) / kSpanWarps;
  const int grid = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  kernel<<<grid, 32 * kSpanWarps, S::kBytes, st>>>(static_cast<const T*>(image),
                                                   static_cast<const T*>(curves),
                                                   static_cast<T*>(out), pixels, items);
  return static_cast<int>(cudaGetLastError());
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
// path: 0 = "general" (anything), 1 = "vec" (image, curves and out 16-byte
// aligned; a shared curve of any C, or per-iteration curves at C = 3 with
// kSpanIters iterations; anything else is refused).
extern "C" int dce_curve_apply(const void* image, const void* curves, void* out,
                               int dtype, int64_t total, int c, int rc,
                               int num_iters, int shared, int path, void* stream) {
  if (total == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    const bool aligned = (reinterpret_cast<uintptr_t>(image) | reinterpret_cast<uintptr_t>(curves) |
                          reinterpret_cast<uintptr_t>(out)) % 16 == 0;
    const bool span = c == 3 && num_iters == kSpanIters && rc == 3 * kSpanIters;
    if (!aligned || num_iters < 0 || !(shared ? rc == c : span))
      return static_cast<int>(cudaErrorInvalidValue);
    if (shared) {
      if (dtype == 0) return launch_flat<float>(image, curves, out, total, num_iters, st);
      if (dtype == 1) return launch_flat<__nv_bfloat16>(image, curves, out, total, num_iters, st);
    } else {
      if (dtype == 0) return launch_span<float, kSpanIters>(image, curves, out, total / 3, st);
      if (dtype == 1)
        return launch_span<__nv_bfloat16, kSpanIters>(image, curves, out, total / 3, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (path != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t want = (total + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks));
  const dim3 block(kThreads);
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
