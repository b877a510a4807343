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
// 3.35 TB/s, against 0.038 ms of f32 work. A memory-bound kernel needs
// bytes in flight: about 3.35 TB/s x 600 ns = 2 MB on the card, 15 KB an SM.
//
// What held the first design (the column walk below) back: it had a thread
// walk one column of 4 channels with its taps and its window of three input
// rows in registers, so the loads in flight were the next row's three
// 8-byte vectors a thread, about 4 KB an SM (512 resident threads), and the
// two neighbours' vectors of each row were issued again (L1 hits). It ran
// at 38.5% of the bound.
//
// The ring (path 2) puts the bytes in flight in shared memory instead of
// registers. A block of 8 consumer warps and one producer warp stays
// resident and walks work units: a tile of TW output columns x a chunk of CC
// channels (CC x element size = 64 or 128 bytes) over a strip of rows of
// one image. One producer thread copies each input row tile (TW + 2 columns
// x CC channels) with a TMA load (cp.async.bulk.tensor.4d over (B, H, W, C))
// into a ring of NS stages, completing on the stage's `full` mbarrier; it
// runs up to NS rows ahead, across units, and refills a stage once all 8
// consumer warps have arrived on its `empty` mbarrier. NS - 3 row tiles are
// thus in flight without a register spent on them: in bf16 one block an SM
// with 16 stages, 56 KB; in f32 three blocks of 8, 65 KB. TMA zero-fills
// every coordinate outside the tensor: that is W's padding, H's for rows =
// 0, and the channels past C of a last chunk (masked at the store); for
// rows = 1 the producer clamps the row into [0, H - 1]. A consumer thread owns one vector of channels (16
// bytes: 8 bf16 or 4 f32) of one output column. For each output row it
// reads the three rows x three columns of vectors from shared memory (thread
// t at byte 16 t of a column window, so a quarter-warp reads 128 contiguous
// bytes: no bank conflicts), sums them with its taps in f32 registers and
// stores its 16 bytes with a streaming store. The host picks the strip
// height so that the units fill the resident blocks evenly; halo rows are
// then read twice only at strip edges, which neighbouring blocks walk at
// about the same time (L2 hits), and halo columns once a tile.
//
// The column walk (paths 0 and 1) stays for what TMA cannot address: rows of
// C x element size not a multiple of 16 bytes, or x not 16-byte aligned.
// Path 1 takes 4 channels a thread (C a multiple of 4, x aligned to 4
// elements), path 0 one. The wrapper chooses the path from the shape, the
// dtype and x's address before the launch.
//
// Plain C interface for ctypes: launches on the stream it is given,
// allocates nothing, returns a cudaError_t (cudaErrorInvalidValue where the
// tensor map cannot be encoded).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// The column walk (paths 0 and 1)

constexpr int kThreads = 256;
constexpr int kStrip = 16;  // output rows a thread walks down

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
int launch_walk(const void* x, const float* k, void* out, int b, int h, int w, int c, int edge,
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

// ---------------------------------------------------------------------------
// The ring (path 2)

constexpr int kConsumers = 256;               // 8 consumer warps
constexpr int kRingThreads = kConsumers + 32;  // and one producer warp

// The geometry of a ring kernel for element type T and CB-byte channel chunks
template <typename T, int CB>
struct Ring {
  static constexpr int VEC = 16 / sizeof(T);        // channels a consumer thread (16 bytes)
  static constexpr int CC = CB / sizeof(T);         // channels a chunk
  static constexpr int kPerCol = CC / VEC;          // consumer threads a column
  static constexpr int TW = kConsumers / kPerCol;   // output columns a tile
  static constexpr int kTile = (TW + 2) * CB;       // bytes of one input row tile
  static constexpr int kStride = (kTile + 127) / 128 * 128;
  // bf16 taps take 72 registers of a thread's 144 (held to fewer for two
  // blocks an SM, they spilled): one block an SM, 16 stages, 13 row tiles
  // (56 KB) in flight; f32 at 72 registers, three blocks of 8 stages
  static constexpr int NS = sizeof(T) == 2 ? 16 : 8;  // a power of two: indices are shifts
  static constexpr int kMinBlocks = sizeof(T) == 2 ? 1 : 3;
  static constexpr int kSmem = NS * kStride + 2 * NS * 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one input row tile: box (CC, TW + 2, 1, 1) at (channel, column, row, image)
__device__ __forceinline__ void tma_row(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                        int w, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(b), "r"(smem_addr(bar))
      : "memory");
}

// VEC consecutive channels from shared memory as f32 (one 16-byte load)
template <typename T, int VEC>
__device__ __forceinline__ void lds(const unsigned char* p, float (&v)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __uint_as_float(w[j]);
  } else {  // two bf16 a word, the first in the low half: exact as f32
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

// VEC channels to device memory in T, one 16-byte streaming store
template <typename T, int VEC>
__device__ __forceinline__ void stg(T* p, const float (&v)[VEC]) {
  uint32_t w[4];
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = __float_as_uint(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&pair);
    }
  }
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
}

struct Unit {
  int b, h0, rows, tile, chunk;
};

// unit u: the chunk varies fastest, then the tile, the strip and the image,
// so the blocks resident at one time read neighbouring chunks, tiles and
// strips (their shared halo columns and rows hit L2)
__device__ __forceinline__ Unit unit_of(int u, int H, int strip, int tiles, int chunks,
                                        int strips) {
  Unit r;
  r.chunk = u % chunks;
  u /= chunks;
  r.tile = u % tiles;
  u /= tiles;
  r.h0 = (u % strips) * strip;
  r.b = u / strips;
  r.rows = min(strip, H - r.h0);
  return r;
}

// grid: at most the resident blocks; block i takes units i, i + grid, ...
template <typename T, int CB>
__global__ void __launch_bounds__(kRingThreads, Ring<T, CB>::kMinBlocks)
    dw3x3_ring_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ k,
                      T* __restrict__ out, int H, int W, int C, int strip, int tiles, int chunks,
                      int strips, int units, int edge) {
  using R = Ring<T, CB>;
  constexpr int NS = R::NS;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NS * R::kStride);
  uint64_t* empty = full + NS;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread issues every copy
    if (tid == kConsumers) {
      uint32_t q = 0;  // input rows copied so far
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit t = unit_of(u, H, strip, tiles, chunks, strips);
        for (int i = 0; i < t.rows + 2; ++i, ++q) {
          const int s = q % NS;
          if (q >= NS) mbar_wait(&empty[s], ((q / NS) & 1) ^ 1);  // its last use released
          mbar_expect_tx(&full[s], R::kTile);
          int hr = t.h0 - 1 + i;
          if (edge) hr = min(max(hr, 0), H - 1);
          tma_row(smem + s * R::kStride, &map, &full[s], t.chunk * R::CC, t.tile * R::TW - 1, hr,
                  t.b);
        }
      }
    }
    return;
  }

  // a consumer: one vector of channels of one output column of the tile
  const int v = tid % R::kPerCol;
  const int col = tid / R::kPerCol;
  const bool lane0 = (tid & 31) == 0;
  const int col_bytes = col * CB + v * 16;  // in the window's first column
  uint32_t q = 0;                           // input rows consumed so far
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit t = unit_of(u, H, strip, tiles, chunks, strips);
    const int c = t.chunk * R::CC + v * R::VEC;
    const int w = t.tile * R::TW + col;
    const bool live = c < C && w < W;  // C is a multiple of VEC
    float tap[9][R::VEC];              // [3 dh + dx][channel]
#pragma unroll
    for (int i = 0; i < 9; ++i)
#pragma unroll
      for (int j = 0; j < R::VEC; ++j) tap[i][j] = c < C ? __ldg(k + i * C + c + j) : 0.f;
    T* on = out + ((static_cast<int64_t>(t.b) * H + t.h0) * W + w) * C + c;
    mbar_wait(&full[q % NS], (q / NS) & 1);
    mbar_wait(&full[(q + 1) % NS], ((q + 1) / NS) & 1);
    for (int j = 0; j < t.rows; ++j, ++q) {  // output row h0 + j: input rows q .. q + 2
      mbar_wait(&full[(q + 2) % NS], ((q + 2) / NS) & 1);
      const unsigned char* row[3];
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) row[dh] = smem + ((q + dh) % NS) * R::kStride + col_bytes;
      float acc[R::VEC];
#pragma unroll
      for (int i = 0; i < R::VEC; ++i) acc[i] = 0.f;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          float xv[R::VEC];
          lds<T, R::VEC>(row[dh] + dx * CB, xv);
#pragma unroll
          for (int i = 0; i < R::VEC; ++i) acc[i] = fmaf(xv[i], tap[3 * dh + dx][i], acc[i]);
        }
      if (live) stg<T, R::VEC>(on + static_cast<int64_t>(j) * W * C, acc);
      __syncwarp();
      if (lane0) mbar_arrive(&empty[q % NS]);  // input row q is no longer read
    }
    __syncwarp();
    if (lane0) {  // the unit's last two input rows
      mbar_arrive(&empty[q % NS]);
      mbar_arrive(&empty[(q + 1) % NS]);
    }
    q += 2;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library links no -lcuda
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The strip height: of 8, 16, 32, ... up to H, the one whose units fill
// `slots` resident blocks in the fewest row steps of the busiest block (each
// unit's two halo rows counted), the taller on a tie
int pick_strip(int b, int h, int64_t units_per_strip, int64_t slots) {
  int best = h;
  int64_t best_steps = INT64_MAX;
  for (int s = 8;; s *= 2) {
    const int sh = s < h ? s : h;
    const int64_t units = static_cast<int64_t>(b) * ((h + sh - 1) / sh) * units_per_strip;
    const int64_t steps = (units + slots - 1) / slots * (sh + 2);
    if (steps <= best_steps) {
      best = sh;
      best_steps = steps;
    }
    if (s >= h) break;
  }
  return best;
}

template <typename T, int CB>
int launch_ring(const void* x, const float* k, void* out, int b, int h, int w, int c, int edge,
                cudaStream_t st) {
  using R = Ring<T, CB>;
  const EncodeTiled encode = encoder();
  const uint64_t row_bytes = static_cast<uint64_t>(c) * sizeof(T);
  if (encode == nullptr || row_bytes % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {row_bytes, row_bytes * w, row_bytes * w * h};
  const cuuint32_t box[4] = {R::CC, R::TW + 2, 1, 1};
  const cuuint32_t unit_strides[4] = {1, 1, 1, 1};
  const CUresult enc = encode(
      &map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(x), dims, strides, box, unit_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (enc != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);

  auto kernel = dw3x3_ring_kernel<T, CB>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         R::kSmem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRingThreads, R::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t slots = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int tiles = (w + R::TW - 1) / R::TW;
  const int chunks = (c + R::CC - 1) / R::CC;
  const int strip = pick_strip(b, h, static_cast<int64_t>(tiles) * chunks, slots);
  const int strips = (h + strip - 1) / strip;
  const int64_t units = static_cast<int64_t>(b) * strips * tiles * chunks;
  if (units > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(units < slots ? units : slots);
  kernel<<<grid, kRingThreads, R::kSmem, st>>>(map, k, static_cast<T*>(out), h, w, c, strip,
                                                tiles, chunks, strips,
                                                static_cast<int>(units), edge);
  return static_cast<int>(cudaGetLastError());
}

// the chunk width: 128 bytes where they divide a pixel's row of channels,
// else 64 (C = 288 in bf16: 9 chunks of 32 channels, none of them ragged)
template <typename T>
int launch_ring_for(const void* x, const float* k, void* out, int b, int h, int w, int c,
                    int edge, cudaStream_t st) {
  if (static_cast<int64_t>(c) * sizeof(T) % 128 == 0)
    return launch_ring<T, 128>(x, k, out, b, h, w, c, edge, st);
  return launch_ring<T, 64>(x, k, out, b, h, w, c, edge, st);
}

template <typename T>
int launch(int path, const void* x, const float* k, void* out, int b, int h, int w, int c,
           int edge, cudaStream_t st) {
  switch (path) {
    case 0: return launch_walk<T, 1>(x, k, out, b, h, w, c, edge, st);
    case 1: return launch_walk<T, 4>(x, k, out, b, h, w, c, edge, st);
    case 2: return launch_ring_for<T>(x, k, out, b, h, w, c, edge, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, out (b, h, w, c) NHWC contiguous; k (3, 3, c) float32. dtype: 0 =
// float32, 1 = bfloat16. rows: 0 = zero padding, 1 = edge rows repeated.
// path: 0 = the column walk, a channel a thread; 1 = the column walk, 4
// channels a thread (c a multiple of 4, x aligned to 4 elements); 2 = the
// TMA ring (c x element size a multiple of 16 bytes, x 16-byte aligned).
extern "C" int dw3x3_apply(const void* x, const void* k, void* out, int dtype, int b, int h,
                           int w, int c, int rows, int path, void* stream) {
  if (b == 0 || h == 0 || w == 0 || c == 0) return 0;
  if (rows != 0 && rows != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kf = static_cast<const float*>(k);
  if (dtype == 0) return launch<float>(path, x, kf, out, b, h, w, c, rows, st);
  if (dtype == 1) return launch<__nv_bfloat16>(path, x, kf, out, b, h, w, c, rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
