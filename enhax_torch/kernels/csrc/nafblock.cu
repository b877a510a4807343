// The fused NAFBlock on Hopper (sm_90a): two kernels, each the counterpart
// of a Pallas TPU kernel in enhax/kernels/nafblock.py.
//
//   k1  replaces k1_apply (_k1_kernel): LayerNorm over C -> 1x1 C->2C + b1
//       -> depthwise 3x3 + b2 -> SimpleGate, NHWC x (B,H,W,C) -> g (B,H,W,C).
//   k2  replaces k2_apply (_k2_kernel): att = pooled @ Wsca + b; g*att ->
//       1x1 + b3 -> x1 = x + .*beta -> LayerNorm -> 1x1 C->2C + b4 -> gate
//       -> 1x1 + b5 -> x1 + .*gamma. pooled is the TLC local mean
//       (B,H,W,C) or the global mean (B,1,1,C).
//
// Rounding follows the TPU kernels: matmul operands are rounded to the
// params' type T and the products summed in f32; LayerNorm, the taps, the
// gate and the residuals are f32; the output is stored once in T. Params
// arrive in the reference torch layouts: 1x1 weights (O, I), the depthwise
// weight (2C, 3, 3), vectors (C) or (2C).
//
// Bound: on this card both are bound by bytes: K1 reads x and writes g
// (4 C-wide rows a pixel at bf16 is 8C bytes), K2 reads x, g, pooled and
// writes out. Their 1x1s (K1 2C^2, K2 5C^2 multiply-adds a pixel) fit the
// tensor cores' rate with room to spare. This first version does the 1x1s
// as f32 FMAs from shared memory, which holds it above the f32 rate
// (67 TFLOP/s): a later version moves them to mma/wgmma.
//
// Design.
//   Both kernels run as many blocks as fit on the card at once; each loads
//   its weights into shared memory (as f32) once and walks over tiles.
//   k1: a tile is 14x30 output pixels and its one-pixel halo, 16x32
//     pixels, one thread each (a warp is one halo row, neighbouring pixels
//     in memory). Each thread normalises its pixel's C channels in
//     registers. The 1x1's 2C outputs go to shared memory in passes of K
//     channel pairs (c, C+c), K = 16: a pass writes the pair's outputs for
//     all 512 halo pixels, zero for a halo pixel outside the image (the dw
//     conv's SAME padding, applied after the 1x1: zeroing x would feed the
//     taps LN(0)@W1+b1). Then a thread takes one pair of one tile column,
//     keeps the 18 tap weights in registers and walks down the column with
//     a window of three halo rows, so each 1x1 output is read once, not
//     nine times, and stores the gate of each pixel.
//     Shared memory: 512 x (2K+1) f32 of 1x1 output (the odd stride keeps
//     the per-pixel writes free of bank conflicts) plus W1 and the dw
//     weights in f32: 106 KB at C=64, so one block of 16 warps per SM.
//   k2: a tile is 32 pixels of one image, for 256 threads: a warp is the
//     32 pixels, and its 8 warps split each 1x1's output channels. The
//     per-pixel vectors pass through shared memory ([32][C+1] f32 each, x1,
//     and two stages) between the 1x1s; each thread holds the input row of
//     its pixel in registers and reads the weight rows (all in f32 shared
//     memory, broadcast across the warp). Loads and stores of the tiles
//     are coalesced. The global form computes att once per block.
//
// Entry points have a plain C interface for ctypes. They launch on the
// stream they are given, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// where the TPU kernel casts a matmul operand to the params' dtype
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T>
__device__ __forceinline__ void load_f32(float* dst, const void* src, int n) {
  const T* s = static_cast<const T*>(src);
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = to_f32(s[i]);
}

// ---------------------------------------------------------------- K1 -----

struct K1Params {
  const void* ln_w;
  const void* ln_b;
  const void* w1;    // (2C, C)
  const void* b1;    // (2C)
  const void* dw_w;  // (2C, 3, 3)
  const void* dw_b;  // (2C)
};

constexpr int kK1TileH = 14, kK1TileW = 30;
constexpr int kK1HaloW = kK1TileW + 2;
constexpr int kK1Threads = (kK1TileH + 2) * kK1HaloW;  // 512: one per halo pixel

template <int C>
struct K1Layout {
  static constexpr int K = C < 16 ? C : 16;  // channel pairs per pass
  static constexpr int YS = 2 * K + 1;       // odd stride: no bank conflicts
  static constexpr int y = 0;
  static constexpr int w1 = y + kK1Threads * YS;
  static constexpr int dw = w1 + 2 * C * C;
  static constexpr int b1 = dw + 2 * C * 9;
  static constexpr int dwb = b1 + 2 * C;
  static constexpr int lnw = dwb + 2 * C;
  static constexpr int lnb = lnw + C;
  static constexpr int floats = lnb + C;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int C>
__global__ void __launch_bounds__(kK1Threads, 1)
k1_kernel(const T* __restrict__ x, K1Params p, T* __restrict__ g, int H, int W,
          int tiles_w, int tiles_hw, int tiles) {
  using L = K1Layout<C>;
  constexpr int K = L::K;
  extern __shared__ __align__(16) float smem[];
  float* ys = smem + L::y;
  float* w1s = smem + L::w1;
  float* dws = smem + L::dw;
  float* b1s = smem + L::b1;
  float* dwbs = smem + L::dwb;
  float* lnws = smem + L::lnw;
  float* lnbs = smem + L::lnb;
  load_f32<T>(w1s, p.w1, 2 * C * C);
  load_f32<T>(dws, p.dw_w, 2 * C * 9);
  load_f32<T>(b1s, p.b1, 2 * C);
  load_f32<T>(dwbs, p.dw_b, 2 * C);
  load_f32<T>(lnws, p.ln_w, C);
  load_f32<T>(lnbs, p.ln_b, C);
  __syncthreads();

  const int tid = threadIdx.x;
  // the weights stay in shared memory while the block walks its tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n = tile / tiles_hw;
    const int t = tile - n * tiles_hw;
    const int h0 = (t / tiles_w) * kK1TileH, w0 = (t % tiles_w) * kK1TileW;
    const int h = h0 - 1 + tid / kK1HaloW;
    const int w = w0 - 1 + tid % kK1HaloW;
    const bool inside = h >= 0 && h < H && w >= 0 && w < W;

    // LayerNorm of this halo pixel, rounded to T: the 1x1's operand
    float v[C];
    if (inside) {
      const T* xp = x + ((static_cast<int64_t>(n) * H + h) * W + w) * C;
      float mean = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        v[i] = to_f32(xp[i]);
        mean += v[i];
      }
      mean /= C;
      float var = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const float d = v[i] - mean;
        var += d * d;
      }
      var /= C;
      const float rstd = 1.0f / sqrtf(var + kLnEps);
#pragma unroll
      for (int i = 0; i < C; ++i) v[i] = round_to<T>((v[i] - mean) * rstd * lnws[i] + lnbs[i]);
    } else {
#pragma unroll
      for (int i = 0; i < C; ++i) v[i] = 0.f;
    }

    for (int c0 = 0; c0 < C; c0 += K) {
      // 1x1 outputs c0..c0+K-1 and C+c0..C+c0+K-1 of this halo pixel
      for (int j = 0; j < 2 * K; ++j) {
        const int o = j < K ? c0 + j : C + c0 + (j - K);
        const float* wr = w1s + o * C;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < C; ++i) acc = fmaf(v[i], wr[i], acc);
        ys[tid * L::YS + j] = inside ? acc + b1s[o] : 0.f;
      }
      __syncthreads();
      // a thread takes one channel pair of one tile column and walks down
      // it: each halo row's three taps are read once and kept for the
      // three output rows that use them
      for (int item = tid; item < K * kK1TileW; item += kK1Threads) {
        const int k = item % K;
        const int q = item / K;
        const int ow = w0 + q;
        if (ow >= W) continue;
        const int ca = c0 + k, cb = C + c0 + k;
        float wa[9], wb[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          wa[i] = dws[ca * 9 + i];
          wb[i] = dws[cb * 9 + i];
        }
        const float ba = dwbs[ca], bb = dwbs[cb];
        float ya[3][3], yb[3][3];  // [halo row % 3][dx]
        T* gp = g + ((static_cast<int64_t>(n) * H + h0) * W + ow) * C;
#pragma unroll
        for (int hr = 0; hr < kK1TileH + 2; ++hr) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float* yp = ys + (hr * kK1HaloW + q + dx) * L::YS;
            ya[hr % 3][dx] = yp[k];
            yb[hr % 3][dx] = yp[K + k];
          }
          if (hr < 2) continue;
          const int r = hr - 2;
          if (h0 + r >= H) break;
          float a = 0.f, b = 0.f;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              a = fmaf(ya[(r + dy) % 3][dx], wa[dy * 3 + dx], a);
              b = fmaf(yb[(r + dy) % 3][dx], wb[dy * 3 + dx], b);
            }
          }
          gp[static_cast<int64_t>(r) * W * C + ca] = from_f32<T>((a + ba) * (b + bb));
        }
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------- K2 -----

struct K2Params {
  const void* sca_w;  // (C, C)
  const void* sca_b;
  const void* w3;     // (C, C)
  const void* b3;
  const void* beta;
  const void* ln_w;
  const void* ln_b;
  const void* w4;     // (2C, C)
  const void* b4;     // (2C)
  const void* w5;     // (C, C)
  const void* b5;
  const void* gamma;
};

constexpr int kK2Pixels = 32;
constexpr int kK2Groups = 8;
constexpr int kK2Threads = kK2Pixels * kK2Groups;  // 256

template <int C>
struct K2Layout {
  static constexpr int RS = C + 1;  // row stride of the per-pixel tiles
  static constexpr int sca = 0;
  static constexpr int w3 = sca + C * C;
  static constexpr int w4 = w3 + C * C;
  static constexpr int w5 = w4 + 2 * C * C;
  static constexpr int scab = w5 + C * C;
  static constexpr int b3 = scab + C;
  static constexpr int beta = b3 + C;
  static constexpr int lnw = beta + C;
  static constexpr int lnb = lnw + C;
  static constexpr int b4 = lnb + C;
  static constexpr int b5 = b4 + 2 * C;
  static constexpr int gamma = b5 + C;
  static constexpr int att = gamma + C;
  static constexpr int tx = att + C;           // x, then x1, then out
  static constexpr int ta = tx + kK2Pixels * RS;
  static constexpr int tb = ta + kK2Pixels * RS;
  static constexpr int floats = tb + kK2Pixels * RS;
  static constexpr size_t bytes = floats * sizeof(float);
};

// dot of the register row v with the f32 shared row wr
template <int C>
__device__ __forceinline__ float dot_row(const float (&v)[C], const float* wr) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) acc = fmaf(v[i], wr[i], acc);
  return acc;
}

template <int C>
__device__ __forceinline__ void load_row(float (&v)[C], const float* row) {
#pragma unroll
  for (int i = 0; i < C; ++i) v[i] = row[i];
}

template <typename T, int C>
__global__ void __launch_bounds__(kK2Threads, 2)
k2_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ pooled,
          int spatial, K2Params p, T* __restrict__ out, int HW, int tiles_hw) {
  using L = K2Layout<C>;
  constexpr int RS = L::RS;
  constexpr int kPer = C / kK2Groups > 0 ? C / kK2Groups : 1;  // outputs a thread
  extern __shared__ __align__(16) float smem[];
  float* scas = smem + L::sca;
  float* w3s = smem + L::w3;
  float* w4s = smem + L::w4;
  float* w5s = smem + L::w5;
  float* atts = smem + L::att;
  float* tx = smem + L::tx;
  float* ta = smem + L::ta;
  float* tb = smem + L::tb;
  load_f32<T>(scas, p.sca_w, C * C);
  load_f32<T>(w3s, p.w3, C * C);
  load_f32<T>(w4s, p.w4, 2 * C * C);
  load_f32<T>(w5s, p.w5, C * C);
  load_f32<T>(smem + L::scab, p.sca_b, C);
  load_f32<T>(smem + L::b3, p.b3, C);
  load_f32<T>(smem + L::beta, p.beta, C);
  load_f32<T>(smem + L::lnw, p.ln_w, C);
  load_f32<T>(smem + L::lnb, p.ln_b, C);
  load_f32<T>(smem + L::b4, p.b4, 2 * C);
  load_f32<T>(smem + L::b5, p.b5, C);
  load_f32<T>(smem + L::gamma, p.gamma, C);

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  __syncthreads();
  if (!spatial && tid < C) {
    // the global form: one attention vector for the image
    const T* pv = pooled + static_cast<int64_t>(n) * C;
    float acc = 0.f;
    for (int i = 0; i < C; ++i) acc = fmaf(round_to<T>(to_f32(pv[i])), scas[tid * C + i], acc);
    atts[tid] = acc + smem[L::scab + tid];
  }

  const int px = tid % kK2Pixels;   // a warp is the 32 pixels
  const int grp = tid / kK2Pixels;  // and the warps split the outputs
  const int o0 = grp * kPer;
  const bool active = o0 < C;
  float v[C];
  // the weights stay in shared memory while the block walks its tiles
  for (int tile = blockIdx.x; tile < tiles_hw; tile += gridDim.x) {
    const int pix0 = tile * kK2Pixels;
    const int npix = min(kK2Pixels, HW - pix0);
    const int64_t base = (static_cast<int64_t>(n) * HW + pix0) * C;
    // the tiles, coalesced: x -> tx, g -> tb, the TLC pooled mean -> ta
    for (int e = tid; e < kK2Pixels * C; e += kK2Threads) {
      const int pp = e / C, c = e - pp * C;
      const bool ok = pp < npix;
      tx[pp * RS + c] = ok ? to_f32(x[base + e]) : 0.f;
      tb[pp * RS + c] = ok ? to_f32(g[base + e]) : 0.f;
      if (spatial) ta[pp * RS + c] = ok ? to_f32(pooled[base + e]) : 0.f;
    }
    __syncthreads();

    // SCA: tb <- round(g * att)
    if (active) {
      if (spatial) load_row<C>(v, ta + px * RS);
      for (int o = o0; o < o0 + kPer; ++o) {
        const float att = spatial ? dot_row<C>(v, scas + o * C) + smem[L::scab + o] : atts[o];
        tb[px * RS + o] = round_to<T>(tb[px * RS + o] * att);
      }
    }
    __syncthreads();
    // conv3 and the first residual: tx <- x + (. @ W3 + b3) * beta
    if (active) {
      load_row<C>(v, tb + px * RS);
      for (int o = o0; o < o0 + kPer; ++o) {
        const float z = dot_row<C>(v, w3s + o * C) + smem[L::b3 + o];
        tx[px * RS + o] = tx[px * RS + o] + z * smem[L::beta + o];
      }
    }
    __syncthreads();
    // LayerNorm of x1, rounded: ta (each thread writes its own channels)
    if (active) {
      load_row<C>(v, tx + px * RS);
      float mean = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) mean += v[i];
      mean /= C;
      float var = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const float d = v[i] - mean;
        var += d * d;
      }
      var /= C;
      const float rstd = 1.0f / sqrtf(var + kLnEps);
      for (int o = o0; o < o0 + kPer; ++o) {
        ta[px * RS + o] = round_to<T>((tx[px * RS + o] - mean) * rstd * smem[L::lnw + o] +
                                      smem[L::lnb + o]);
      }
    }
    __syncthreads();
    // conv4 and the gate: tb <- round((. @ W4a + b4a) * (. @ W4b + b4b))
    if (active) {
      load_row<C>(v, ta + px * RS);
      for (int o = o0; o < o0 + kPer; ++o) {
        const float a = dot_row<C>(v, w4s + o * C) + smem[L::b4 + o];
        const float b = dot_row<C>(v, w4s + (C + o) * C) + smem[L::b4 + C + o];
        tb[px * RS + o] = round_to<T>(a * b);
      }
    }
    __syncthreads();
    // conv5 and the second residual: tx <- x1 + (. @ W5 + b5) * gamma
    if (active) {
      load_row<C>(v, tb + px * RS);
      for (int o = o0; o < o0 + kPer; ++o) {
        const float y = dot_row<C>(v, w5s + o * C) + smem[L::b5 + o];
        tx[px * RS + o] = tx[px * RS + o] + y * smem[L::gamma + o];
      }
    }
    __syncthreads();
    for (int e = tid; e < npix * C; e += kK2Threads) {
      const int pp = e / C, c = e - pp * C;
      out[base + e] = from_f32<T>(tx[pp * RS + c]);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ launches ---

// How many blocks of the kernel fit on the card at once: the grid of a
// kernel whose blocks walk over tiles, so each block loads its weights once.
template <typename F>
cudaError_t resident_blocks(F kernel, int threads, size_t smem, int* out) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *out = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

template <typename T, int C>
int launch_k1(const void* x, const void* const* prm, void* g, int n, int h, int w,
              cudaStream_t st) {
  const K1Params p{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5]};
  const size_t bytes = K1Layout<C>::bytes;
  cudaError_t err = cudaFuncSetAttribute(k1_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (w + kK1TileW - 1) / kK1TileW;
  const int tiles_hw = tiles_w * ((h + kK1TileH - 1) / kK1TileH);
  const int64_t tiles = static_cast<int64_t>(tiles_hw) * n;
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  err = resident_blocks(k1_kernel<T, C>, kK1Threads, bytes, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  grid = static_cast<int>(tiles < grid ? tiles : grid);
  k1_kernel<T, C><<<grid, kK1Threads, bytes, st>>>(static_cast<const T*>(x), p,
                                                    static_cast<T*>(g), h, w, tiles_w,
                                                    tiles_hw, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_k2(const void* x, const void* g, const void* pooled, int spatial,
              const void* const* prm, void* out, int n, int hw, cudaStream_t st) {
  const K2Params p{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5],
                   prm[6], prm[7], prm[8], prm[9], prm[10], prm[11]};
  const size_t bytes = K2Layout<C>::bytes;
  cudaError_t err = cudaFuncSetAttribute(k2_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_hw = (hw + kK2Pixels - 1) / kK2Pixels;
  int resident = 0;
  err = resident_blocks(k2_kernel<T, C>, kK2Threads, bytes, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks per image: enough to fill the card once over all n images
  int per_image = (resident + n - 1) / n;
  per_image = tiles_hw < per_image ? tiles_hw : per_image;
  const dim3 grid(per_image, n);
  k2_kernel<T, C><<<grid, kK2Threads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(pooled),
      spatial, p, static_cast<T*>(out), hw, tiles_hw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_k1(int c, const void* x, const void* const* prm, void* g, int n, int h,
                int w, cudaStream_t st) {
  switch (c) {
    case 8: return launch_k1<T, 8>(x, prm, g, n, h, w, st);
    case 16: return launch_k1<T, 16>(x, prm, g, n, h, w, st);
    case 32: return launch_k1<T, 32>(x, prm, g, n, h, w, st);
    case 64: return launch_k1<T, 64>(x, prm, g, n, h, w, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_k2(int c, const void* x, const void* g, const void* pooled, int spatial,
                const void* const* prm, void* out, int n, int hw, cudaStream_t st) {
  switch (c) {
    case 8: return launch_k2<T, 8>(x, g, pooled, spatial, prm, out, n, hw, st);
    case 16: return launch_k2<T, 16>(x, g, pooled, spatial, prm, out, n, hw, st);
    case 32: return launch_k2<T, 32>(x, g, pooled, spatial, prm, out, n, hw, st);
    case 64: return launch_k2<T, 64>(x, g, pooled, spatial, prm, out, n, hw, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, g and every param). params: norm1
// weight and bias, conv1 weight and bias, conv2 weight and bias.
extern "C" int nafblock_k1(const void* x, const void* const* params, void* g, int dtype,
                           int n, int h, int w, int c, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_k1<float>(c, x, params, g, n, h, w, st);
  if (dtype == 1) return dispatch_k1<__nv_bfloat16>(c, x, params, g, n, h, w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// params: sca.1 weight and bias, conv3 weight and bias, beta, norm2 weight
// and bias, conv4 weight and bias, conv5 weight and bias, gamma. pooled is
// (n,h,w,c) with spatial = 1, or (n,1,1,c) with spatial = 0.
extern "C" int nafblock_k2(const void* x, const void* g, const void* pooled, int spatial,
                           const void* const* params, void* out, int dtype, int n, int h,
                           int w, int c, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hw = h * w;
  if (dtype == 0) return dispatch_k2<float>(c, x, g, pooled, spatial, params, out, n, hw, st);
  if (dtype == 1)
    return dispatch_k2<__nv_bfloat16>(c, x, g, pooled, spatial, params, out, n, hw, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
