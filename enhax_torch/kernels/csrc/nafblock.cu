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
// params' dtype and the products summed in f32; LayerNorm, the taps, the
// gate and the residuals are f32; the output is stored once in x's dtype
// (bf16 or f32: in f32 nothing is rounded). The general forms take their
// params in the reference torch layouts: 1x1 weights (O, I), the depthwise
// weight (2C, 3, 3), vectors (C) or (2C); the bf16 forms' layouts are at
// their entry points.
//
// Bound: on this card both are bound by bytes: K1 reads x and writes g
// (at bf16 4C bytes a pixel), K2 reads x, g, pooled and writes out (8C
// bytes). Their 1x1s (K1 2C^2 multiply-adds a pixel; K2 4C^2 with the
// global mean, 5C^2 with the TLC mean) fit the tensor cores' rate with room
// to spare, but not the f32 rate (67 TFLOP/s) outside them.
//
// Two forms of each, fixed at compile time by dtype:
//   bf16 forms (k1_bf16_kernel, k2_bf16_kernel) for bfloat16 at every
//     width: the 1x1s on mma.sync m16n8k16 with bf16 operands and f32 sums,
//     the weights bf16 in shared memory for the block's life, the tiles by
//     16-byte cp.async ahead of their use, grids of the blocks resident on
//     the card.
//   general forms (k1_kernel, k2_kernel) for float32: f32 FMAs from f32
//     weights in shared memory (a tensor-core product of f32 operands would
//     be TF32, outside the 1e-5 tolerance).
//
// Design of the bf16 forms.
//   k1: a work item is a strip of 62 output columns (64 pixels with the
//     halo, four m-tiles; 30 and two at C = 64) of up to 64 rows of one
//     image; 8 warps walk down it. Each input row is normalised once (8
//     channels a thread, summed by shuffles, rounded to bf16 in place) and
//     projected once by the 1x1 into a ring of four f32 rows of 2C channels
//     (+ b1; zero outside the image, after the 1x1: LN(0) W1 + b1 is not
//     zero); the output row above it then takes its taps from the ring. A
//     step normalises one row, projects the one before and takes the taps
//     of the row above that, on buffers none of the others touches: one
//     barrier a row. In the taps a thread holds two channels of both gate
//     halves and their 18 tap pairs in registers and walks a run of columns
//     with a window of three, one new column of loads a step. So the halo
//     costs 2 of 64 (32) columns and 2 rows of a run of 64. x rows arrive
//     three ahead; g leaves as bf16 pairs, a warp a contiguous row segment.
//     K1 is bound by instruction issue and latency at two blocks an SM,
//     not by bytes: its taps at the f32 rate would take an eighth of its time.
//     Shared memory: 72 KB of ring, 25 KB of x rows, 5 KB of W1 at C = 32;
//     68, 23 and 18 KB at C = 64: two blocks an SM.
//   k2: a warp owns tiles of 16 pixels and takes each through the whole
//     chain in registers: the m16n8 output fragments of one product,
//     rounded to bf16 where the TPU kernel rounds, are the next product's A
//     fragments (SCA -> conv3 -> LN2 -> conv4 and the gate -> conv5); LN2's
//     row sums are quad shuffles; x1 stays f32. Its x, g (and pooled) tiles
//     come by cp.async into its own two stages, one tile ahead; the output
//     leaves through the x buffer by 16-byte stores. No block barrier after
//     the weights' load. The global form computes att once an image a warp.
//
// Design of the general forms.
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

__device__ __forceinline__ void load_f32(float* dst, const void* src, int n) {
  const float* s = static_cast<const float*>(src);
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = s[i];
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

template <int C>
__global__ void __launch_bounds__(kK1Threads, 1)
k1_kernel(const float* __restrict__ x, K1Params p, float* __restrict__ g, int H, int W,
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
  load_f32(w1s, p.w1, 2 * C * C);
  load_f32(dws, p.dw_w, 2 * C * 9);
  load_f32(b1s, p.b1, 2 * C);
  load_f32(dwbs, p.dw_b, 2 * C);
  load_f32(lnws, p.ln_w, C);
  load_f32(lnbs, p.ln_b, C);
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

    // LayerNorm of this halo pixel: the 1x1's operand
    float v[C];
    if (inside) {
      const float* xp = x + ((static_cast<int64_t>(n) * H + h) * W + w) * C;
      float mean = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        v[i] = xp[i];
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
      for (int i = 0; i < C; ++i) v[i] = (v[i] - mean) * rstd * lnws[i] + lnbs[i];
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
        float* gp = g + ((static_cast<int64_t>(n) * H + h0) * W + ow) * C;
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
          gp[static_cast<int64_t>(r) * W * C + ca] = (a + ba) * (b + bb);
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

template <int C>
__global__ void __launch_bounds__(kK2Threads, 2)
k2_kernel(const float* __restrict__ x, const float* __restrict__ g,
          const float* __restrict__ pooled, int spatial, K2Params p, float* __restrict__ out,
          int HW, int tiles_hw) {
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
  load_f32(scas, p.sca_w, C * C);
  load_f32(w3s, p.w3, C * C);
  load_f32(w4s, p.w4, 2 * C * C);
  load_f32(w5s, p.w5, C * C);
  load_f32(smem + L::scab, p.sca_b, C);
  load_f32(smem + L::b3, p.b3, C);
  load_f32(smem + L::beta, p.beta, C);
  load_f32(smem + L::lnw, p.ln_w, C);
  load_f32(smem + L::lnb, p.ln_b, C);
  load_f32(smem + L::b4, p.b4, 2 * C);
  load_f32(smem + L::b5, p.b5, C);
  load_f32(smem + L::gamma, p.gamma, C);

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  __syncthreads();
  if (!spatial && tid < C) {
    // the global form: one attention vector for the image
    const float* pv = pooled + static_cast<int64_t>(n) * C;
    float acc = 0.f;
    for (int i = 0; i < C; ++i) acc = fmaf(pv[i], scas[tid * C + i], acc);
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
      tx[pp * RS + c] = ok ? x[base + e] : 0.f;
      tb[pp * RS + c] = ok ? g[base + e] : 0.f;
      if (spatial) ta[pp * RS + c] = ok ? pooled[base + e] : 0.f;
    }
    __syncthreads();

    // SCA: tb <- g * att
    if (active) {
      if (spatial) load_row<C>(v, ta + px * RS);
      for (int o = o0; o < o0 + kPer; ++o) {
        const float att = spatial ? dot_row<C>(v, scas + o * C) + smem[L::scab + o] : atts[o];
        tb[px * RS + o] = tb[px * RS + o] * att;
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
    // LayerNorm of x1: ta (each thread writes its own channels)
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
        ta[px * RS + o] =
            (tx[px * RS + o] - mean) * rstd * smem[L::lnw + o] + smem[L::lnb + o];
      }
    }
    __syncthreads();
    // conv4 and the gate: tb <- (. @ W4a + b4a) * (. @ W4b + b4b)
    if (active) {
      load_row<C>(v, ta + px * RS);
      for (int o = o0; o < o0 + kPer; ++o) {
        const float a = dot_row<C>(v, w4s + o * C) + smem[L::b4 + o];
        const float b = dot_row<C>(v, w4s + (C + o) * C) + smem[L::b4 + C + o];
        tb[px * RS + o] = a * b;
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
      out[base + e] = tx[pp * RS + c];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------- bf16 forms ---
//
// K1 and K2 for bf16 at every width: the 1x1s on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 sums), the weights bf16 in shared
// memory for the block's life, the tiles in by 16-byte cp.async a step
// ahead of their use (see the note at the head of this file).

using bf16 = __nv_bfloat16;

// A stage boundary inside a warp's own chain, where no barrier marks one;
// empty in the build (tools/nafblock_stage_clocks.py stamps a clock there).
#define NAF_STAGE() \
  do {              \
  } while (0)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled where !in (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b: one m16n8k16 product, bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two values rounded to bf16 and packed, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 bf16x2_f32(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ float2 ld_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The products over C channels: K padded to a multiple of 16 (C = 8 has 8
// zero columns), n-tiles of 8 outputs, and the stride of a bf16 row in
// shared memory: KP + 8 elements, so that ldmatrix and the fragment reads
// of 8 rows touch every bank once (C >= 16).
template <int C>
struct Bf {
  static constexpr int KP = C < 16 ? 16 : C;
  static constexpr int KT = KP / 16;  // k-steps
  static constexpr int NT = C / 8;    // n-tiles over C outputs
  static constexpr int LD = KP + 8;
};

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// b[0..1]: the B fragment of the 8 weight rows at r0, b[2..3]: of those at
// r1, both over k0 .. k0 + 15; W bf16 rows of stride ld in shared memory
__device__ __forceinline__ void ldsm_pair(uint32_t (&b)[4], const bf16* W, int ld, int r0, int r1,
                                          int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  ldsm_x4(b, smem_u32(W + ((mi < 2 ? r0 : r1) + (lane & 7)) * ld + k0 + (mi & 1) * 8));
}

// acc = A W^T over C outputs, on a warp: A as m16n8k16 fragments in
// registers (its 16 rows, KT k-steps), W (KP rows at least) bf16 in shared
// memory. n-tiles go two at a time; at C = 8 the second reads W's zero rows.
template <int C>
__device__ __forceinline__ void gemm_c(float (&acc)[Bf<C>::NT][4],
                                       const uint32_t (&a)[Bf<C>::KT][4], const bf16* W) {
  using G = Bf<C>;
#pragma unroll
  for (int j = 0; j < G::NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
  for (int s = 0; s < G::KT; ++s) {
#pragma unroll
    for (int j = 0; j < G::NT; j += 2) {
      uint32_t b[4];
      ldsm_pair(b, W, G::LD, 8 * j, 8 * j + 8, 16 * s);
      mma_bf16(acc[j], a[s], b[0], b[1]);
      if (j + 1 < G::NT) mma_bf16(acc[j + 1], a[s], b[2], b[3]);
    }
  }
}

// Fragment positions. A thread (group gq = lane / 4, t4 = lane % 4) holds
// of an m16n8 tile j rows gq and gq + 8, columns 8 j + 2 t4 and the next;
// those of tiles 2s and 2s + 1 are the A fragment of k-step s: a product's
// f32 output becomes the next product's operand in registers, rounded.
template <int C>
__device__ __forceinline__ void set_operand(uint32_t (&a)[Bf<C>::KT][4], int j, uint32_t row_lo,
                                            uint32_t row_hi) {
  a[j / 2][2 * (j % 2)] = row_lo;
  a[j / 2][2 * (j % 2) + 1] = row_hi;
}
template <int C>
__device__ __forceinline__ void pad_operand(uint32_t (&a)[Bf<C>::KT][4]) {
  if (Bf<C>::NT % 2) {  // C = 8: k 8..15 are padding
    a[Bf<C>::KT - 1][2] = 0u;
    a[Bf<C>::KT - 1][3] = 0u;
  }
}

// rows x KP bf16 into shared rows of stride LD by cp.async: rows below
// `valid` from the (valid, C) matrix at src, zero elsewhere
template <int C>
__device__ __forceinline__ void load_weight(bf16* dst, const bf16* src, int rows, int valid) {
  constexpr int CH = Bf<C>::KP / 8;
  for (int e = threadIdx.x; e < rows * CH; e += blockDim.x) {
    const int r = e / CH, ch = e - r * CH;
    const bool in = r < valid && ch * 8 < C;
    cp_async16(dst + r * Bf<C>::LD + ch * 8, in ? src + r * C + ch * 8 : src, in);
  }
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = bf16x2_f32(w[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// ---- K1, bf16 form ----

struct K1BParams {
  const bf16* w1;    // (2C, C)
  const float* vec;  // ln_w, ln_b (C each), b1, dw_b (2C each), taps (9, 2C)
};

constexpr int kK1BThreads = 256;
constexpr int kK1BRows = 64;            // output rows a work item at most
constexpr int kK1BStages = 5;           // x rows in shared memory: three in flight

// pixels of a strip's row, the two halo columns included: 64 (four
// m-tiles) at C <= 32, 32 at C = 64, whose ring rows are twice as wide
__host__ __device__ constexpr int k1b_pix(int c) { return c <= 32 ? 64 : 32; }

template <int C>
struct K1BLayout {
  using G = Bf<C>;
  static constexpr int PIX = k1b_pix(C);
  static constexpr int LDR = 2 * C + 8;  // f32 ring rows: 64-bit accesses free of conflicts
  static constexpr size_t ring = 0;      // f32 [4][PIX][LDR]
  static constexpr size_t xs = ring + 4 * PIX * LDR * 4;            // bf16 [stages][PIX][LD]
  static constexpr size_t w1 = xs + kK1BStages * PIX * G::LD * 2;  // bf16 [2C][LD]
  static constexpr size_t b1 = w1 + 2 * C * G::LD * 2;            // f32 [2C]
  static constexpr size_t bytes = b1 + 2 * C * 4;
};

// grid: work items (image, strip of PIX - 2 columns, run of up to 64 rows),
// walked by resident blocks; 256 threads. Each item walks down its rows:
// input row j (its PIX pixels with the halo columns) arrives by cp.async
// three rows ahead, is normalised in place (bf16) one step, projected by the
// 1x1 into ring slot j % 4 (f32, + b1, zero outside the image) the next, and
// the step after that the output row above it takes its taps from ring rows
// j - 2 .. j and its gate goes out.
template <int C>
__global__ void __launch_bounds__(kK1BThreads, 2)
k1_bf16_kernel(const bf16* __restrict__ x, K1BParams p, bf16* __restrict__ g, int H, int W,
               int strips, int segs, int items) {
  using G = Bf<C>;
  using L = K1BLayout<C>;
  constexpr int LD = G::LD, LDR = L::LDR, CH = C / 8;
  constexpr int PIX = L::PIX, STRIP = PIX - 2, MT = PIX / 16;
  constexpr int NTW = MT * C / 32 > 2 ? MT * C / 32 : 2;  // 1x1: n-tiles a warp
  constexpr int ITEMS = MT * ((C / 4) / NTW);         // 1x1: warp items
  constexpr int PAIRS = C / 2;                        // taps: channel pairs
  constexpr int RUNS = kK1BThreads / PAIRS;           // taps: runs of columns
  constexpr int RUN = (STRIP + RUNS - 1) / RUNS;
  static_assert(ITEMS <= kK1BThreads / 32 && PIX * CH <= kK1BThreads, "K1 geometry");
  extern __shared__ __align__(16) unsigned char smem_k1[];
  float* ring = reinterpret_cast<float*>(smem_k1 + L::ring);
  bf16* xs0 = reinterpret_cast<bf16*>(smem_k1 + L::xs);
  bf16* w1 = reinterpret_cast<bf16*>(smem_k1 + L::w1);
  float* b1s = reinterpret_cast<float*>(smem_k1 + L::b1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;

  // the x rows' padding columns (C = 8) stay zero: the 1x1's zero k
  for (int i = tid; i < static_cast<int>((L::w1 - L::xs) / 16); i += kK1BThreads)
    reinterpret_cast<uint4*>(smem_k1 + L::xs)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < 2 * C; i += kK1BThreads) b1s[i] = p.vec[2 * C + i];
  __syncthreads();
  load_weight<C>(w1, p.w1, 2 * C, 2 * C);
  cp_async_commit();
  // this thread's taps: channels 2 cp, 2 cp + 1 of both gate halves, for
  // the output columns q0 .. q1 - 1 of the strip; weights kept in registers
  const int cp = tid % PAIRS, run = tid / PAIRS;
  const int q0 = run * RUN, q1 = min(q0 + RUN, STRIP);
  float2 wa[9], wb[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    wa[k] = ld_f2(p.vec + 6 * C + k * 2 * C + 2 * cp);
    wb[k] = ld_f2(p.vec + 6 * C + k * 2 * C + C + 2 * cp);
  }
  const float2 ba = ld_f2(p.vec + 4 * C + 2 * cp), bb = ld_f2(p.vec + 5 * C + 2 * cp);
  // a row's load: one 16-byte copy a thread (PIX * CH <= 256), and in the
  // LayerNorm the same 8 channels of the pixel, whose weights it keeps
  const bool loader = tid < PIX * CH;
  const int lm = tid / CH, lch = tid % CH;
  float lnw[8], lnb[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    lnw[k] = p.vec[lch * 8 + k];
    lnb[k] = p.vec[C + lch * 8 + k];
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int strip = item % strips, rest = item / strips;
    const int seg = rest % segs, n = rest / segs;
    const int w0 = strip * STRIP, o0 = seg * kK1BRows, o1 = min(o0 + kK1BRows, H);
    const int rows_in = o1 - o0 + 2;  // input rows o0 - 1 .. o1: row j is o0 - 1 + j
    // this thread's 16 bytes of each row: pixel lm's channels 8 lch ..
    const int lw = w0 - 1 + lm;
    const bool lcol = loader && lw >= 0 && lw < W;
    const int64_t lbase = (static_cast<int64_t>(n) * H * W + lw) * C + lch * 8;
    // input row j of the item into stage j % kK1BStages (zero outside)
    const auto load_row = [&](int j) {
      if (loader && j < rows_in) {
        const int r = o0 - 1 + j;
        const bool in = lcol && r >= 0 && r < H;
        cp_async16(xs0 + (j % kK1BStages) * PIX * LD + lm * LD + lch * 8,
                   in ? x + lbase + static_cast<int64_t>(r) * W * C : x, in);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int j = 0; j < kK1BStages; ++j) load_row(j);

    // step i: the LayerNorm of row i + 2, the 1x1 of row i + 1 and the taps
    // of the output row above row i, each on buffers the others leave alone,
    // so one barrier a step
    for (int i = -2; i < rows_in; ++i) {
      cp_async_wait<kK1BStages - 3>();
      __syncthreads();  // row i + 2 is in; the last step's readers are done
      if (i >= 0) load_row(i + kK1BStages);  // into row i's stage, whose 1x1 is done
      // LayerNorm of row i + 2's pixels in place, rounded to bf16: CH
      // threads a pixel, 8 channels each, summed by shuffles
      if (i + 2 < rows_in) {
        bf16* xs = xs0 + ((i + 2) % kK1BStages) * PIX * LD;
        if (loader) {  // the 16 bytes it loaded
          uint4* px = reinterpret_cast<uint4*>(xs + lm * LD + lch * 8);
          float v[8];
          unpack8(*px, v);
          float sum = 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k) sum += v[k];
#pragma unroll
          for (int o = 1; o < CH; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          const float mean = sum / C;
          float d2 = 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k) d2 += (v[k] - mean) * (v[k] - mean);
#pragma unroll
          for (int o = 1; o < CH; o <<= 1) d2 += __shfl_xor_sync(0xffffffffu, d2, o);
          const float rstd = rsqrtf(d2 / C + kLnEps);
          uint4 o;
          uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            ow[k] = bf16x2_bits((v[2 * k] - mean) * rstd * lnw[2 * k] + lnb[2 * k],
                                (v[2 * k + 1] - mean) * rstd * lnw[2 * k + 1] + lnb[2 * k + 1]);
          *px = o;
        }
      }
      // the 1x1 (C -> 2C) of row i + 1's PIX pixels into its ring slot: a
      // warp one m-tile x NTW n-tiles; f32 + b1, zero outside the image (the
      // dw conv's SAME padding comes after the 1x1: LN(0) W1 + b1 is not zero)
      if (i + 1 >= 0 && i + 1 < rows_in) {
        const int r = o0 + i;
        const bf16* xs = xs0 + ((i + 1) % kK1BStages) * PIX * LD;
        float* slot = ring + ((i + 1) % 4) * PIX * LDR;
        if (warp < ITEMS) {
          const int mt = warp % MT, n0 = (warp / MT) * 8 * NTW;
          float acc[NTW][4];
#pragma unroll
          for (int j = 0; j < NTW; ++j)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
          const uint32_t a_addr = smem_u32(xs + (16 * mt + (lane & 15)) * LD + (lane >> 4) * 8);
#pragma unroll
          for (int s = 0; s < G::KT; ++s) {
            uint32_t a[4];
            ldsm_x4(a, a_addr + 2 * 16 * s);
#pragma unroll
            for (int j = 0; j < NTW; j += 2) {
              uint32_t b[4];
              ldsm_pair(b, w1, LD, n0 + 8 * j, n0 + 8 * j + 8, 16 * s);
              mma_bf16(acc[j], a, b[0], b[1]);
              mma_bf16(acc[j + 1], a, b[2], b[3]);
            }
          }
          const bool row_in = r >= 0 && r < H;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = 16 * mt + gq + 8 * half;
            const int w = w0 - 1 + m;
            const bool in = row_in && w >= 0 && w < W;
#pragma unroll
            for (int j = 0; j < NTW; ++j) {
              const int col = n0 + 8 * j + 2 * t4;
              const float2 b1 = ld_f2(b1s + col);
              *reinterpret_cast<float2*>(slot + m * LDR + col) =
                  in ? make_float2(acc[j][2 * half] + b1.x, acc[j][2 * half + 1] + b1.y)
                     : make_float2(0.f, 0.f);
            }
          }
        }
      }
      if (i < 2) continue;
      // output row o0 + i - 2: the taps over ring rows i - 2 .. i, walking the
      // thread's columns with a window of three (one new column a step)
      NAF_STAGE();
      if (q0 >= q1) continue;  // C = 8: 64 runs of one column for 62 columns
      const float* rows[3] = {ring + ((i - 2) % 4) * PIX * LDR, ring + ((i - 1) % 4) * PIX * LDR,
                              ring + (i % 4) * PIX * LDR};
      float2 ya[3][3], yb[3][3];  // [dy][dx]
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float* yp = rows[dy] + (q0 + dx) * LDR + 2 * cp;
          ya[dy][dx] = ld_f2(yp);
          yb[dy][dx] = ld_f2(yp + C);
        }
      bf16* gp = g + ((static_cast<int64_t>(n) * H + o0 + i - 2) * W + w0) * C + 2 * cp;
#pragma unroll
      // past q1 too (stores masked): no branch. The last run's window reads up
      // to two columns past the strip, inside the block's shared memory; its
      // warp issues those loads for its other lanes anyway, and a clamped
      // column would cost integer work every step.
      for (int k = 0; k < RUN; ++k) {
        const int q = q0 + k;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* yp = rows[dy] + (q + 2) * LDR + 2 * cp;
          ya[dy][2] = ld_f2(yp);
          yb[dy][2] = ld_f2(yp + C);
        }
        float2 sa = make_float2(0.f, 0.f), sb = make_float2(0.f, 0.f);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            sa.x = fmaf(ya[dy][dx].x, wa[dy * 3 + dx].x, sa.x);
            sa.y = fmaf(ya[dy][dx].y, wa[dy * 3 + dx].y, sa.y);
            sb.x = fmaf(yb[dy][dx].x, wb[dy * 3 + dx].x, sb.x);
            sb.y = fmaf(yb[dy][dx].y, wb[dy * 3 + dx].y, sb.y);
          }
        if (q < q1 && w0 + q < W)
          *reinterpret_cast<uint32_t*>(gp + static_cast<int64_t>(q) * C) =
              bf16x2_bits((sa.x + ba.x) * (sb.x + bb.x), (sa.y + ba.y) * (sb.y + bb.y));
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          ya[dy][0] = ya[dy][1];
          ya[dy][1] = ya[dy][2];
          yb[dy][0] = yb[dy][1];
          yb[dy][1] = yb[dy][2];
        }
      }
    }
    __syncthreads();  // the next item's rows go to stages read above
  }
  cp_async_wait<0>();
}

// ---- K2, bf16 form ----

struct K2BParams {
  const bf16* w_sca;  // (C, C)
  const bf16* w3;     // (C, C)
  const bf16* w4;     // (2C, C)
  const bf16* w5;     // (C, C)
  const float* vec;   // sca_b, b3, beta, ln_w, ln_b (C each), b4 (2C), b5, gamma (C each)
};

constexpr int kK2BWarps = 8;
constexpr int kK2BThreads = 32 * kK2BWarps;
constexpr int kK2BRows = 16;   // pixels a warp tile: one m-tile
constexpr int kK2BStages = 2;  // a warp's tiles in shared memory: one in flight

template <int C, bool SPATIAL>
struct K2BLayout {
  using G = Bf<C>;
  static constexpr size_t sq = G::KP * G::LD * 2;    // a (C, C) weight, KP rows
  static constexpr size_t tile = kK2BRows * G::LD * 2;
  static constexpr int arrays = SPATIAL ? 3 : 2;     // x, g (, pooled)
  static constexpr size_t sca = 0;
  static constexpr size_t w3 = sca + sq;
  static constexpr size_t w4 = w3 + sq;
  static constexpr size_t w5 = w4 + 2 * C * G::LD * 2;
  static constexpr size_t vec = w5 + sq;
  static constexpr size_t tiles = vec + align16(9 * C * 4);
  static constexpr size_t warp_bytes = kK2BStages * arrays * tile;
  static constexpr size_t bytes = tiles + kK2BWarps * warp_bytes;
};

// grid: resident blocks of 8 warps. A warp owns tiles of 16 pixels of one
// image (the last of an image ragged) and takes each through the whole
// chain in registers: the fragments of one product, rounded where the TPU
// kernel rounds, are the next one's operand; LN2's sums are quad shuffles;
// x1 stays f32. Its tiles come by cp.async one tile ahead into its own
// buffers, and the output leaves through the x buffer by 16-byte stores.
// No block barrier after the weights' load.
template <int C, bool SPATIAL>
__global__ void __launch_bounds__(kK2BThreads)
k2_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
               const bf16* __restrict__ pooled, K2BParams p, bf16* __restrict__ out, int HW,
               int tiles_hw, int tiles) {
  using G = Bf<C>;
  using L = K2BLayout<C, SPATIAL>;
  constexpr int NT = G::NT, KT = G::KT, LD = G::LD, CH = C / 8;
  extern __shared__ __align__(16) unsigned char smem_k2[];
  const bf16* wsca = reinterpret_cast<const bf16*>(smem_k2 + L::sca);
  const bf16* w3 = reinterpret_cast<const bf16*>(smem_k2 + L::w3);
  const bf16* w4 = reinterpret_cast<const bf16*>(smem_k2 + L::w4);
  const bf16* w5 = reinterpret_cast<const bf16*>(smem_k2 + L::w5);
  float* vec = reinterpret_cast<float*>(smem_k2 + L::vec);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  load_weight<C>(reinterpret_cast<bf16*>(smem_k2 + L::sca), p.w_sca, G::KP, C);
  load_weight<C>(reinterpret_cast<bf16*>(smem_k2 + L::w3), p.w3, G::KP, C);
  load_weight<C>(reinterpret_cast<bf16*>(smem_k2 + L::w4), p.w4, 2 * C, 2 * C);
  load_weight<C>(reinterpret_cast<bf16*>(smem_k2 + L::w5), p.w5, G::KP, C);
  cp_async_commit();
  for (int i = tid; i < 9 * C; i += kK2BThreads) vec[i] = p.vec[i];

  bf16* mine = reinterpret_cast<bf16*>(smem_k2 + L::tiles + warp * L::warp_bytes);
  const auto buf = [&](int s, int a) { return mine + (s * L::arrays + a) * kK2BRows * LD; };
  const int stride = gridDim.x * kK2BWarps;
  const int first = blockIdx.x * kK2BWarps + warp;
  // tile t's x, g (and pooled) into stage s: its 16 rows, zero past the image
  const auto load = [&](int t, int s) {
    if (t < tiles) {
      const int n = t / tiles_hw, pix0 = (t - n * tiles_hw) * kK2BRows;
      const int npix = min(kK2BRows, HW - pix0);
      const int64_t base = (static_cast<int64_t>(n) * HW + pix0) * C;
      for (int e = lane; e < kK2BRows * CH; e += 32) {
        const int r = e / CH, ch = e - r * CH;
        const bool in = r < npix;
        const int64_t off = in ? base + r * C + ch * 8 : 0;
        cp_async16(buf(s, 0) + r * LD + ch * 8, x + off, in);
        cp_async16(buf(s, 1) + r * LD + ch * 8, g + off, in);
        if (SPATIAL) cp_async16(buf(s, 2) + r * LD + ch * 8, pooled + off, in);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kK2BStages; ++st) load(first + st * stride, st);
  cp_async_wait<kK2BStages>();
  __syncthreads();  // the weights are in

  int att_n = -1;     // the global form: the image whose att the warp holds
  float att_g[NT][2];
  int s = 0;
  for (int t = first; t < tiles; t += stride, s = s + 1 == kK2BStages ? 0 : s + 1) {
    const int n = t / tiles_hw, pix0 = (t - n * tiles_hw) * kK2BRows;
    const int npix = min(kK2BRows, HW - pix0);
    cp_async_wait<kK2BStages - 1>();
    __syncwarp();
    bf16* xs = buf(s, 0);
    const bf16* gs = buf(s, 1);
    // SCA: att = round(pooled) Wsca^T + b, f32
    float att[NT][4];
    if constexpr (SPATIAL) {
      const bf16* ps = buf(s, 2);
      uint32_t a[KT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = 8 * j + 2 * t4;
        set_operand<C>(a, j, ld_pair(ps + gq * LD + col), ld_pair(ps + (gq + 8) * LD + col));
      }
      pad_operand<C>(a);
      gemm_c<C>(att, a, wsca);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 b = ld_f2(vec + 8 * j + 2 * t4);
        att[j][0] += b.x, att[j][1] += b.y, att[j][2] += b.x, att[j][3] += b.y;
      }
    } else {
      if (n != att_n) {  // once an image: every row of the operand is pooled[n]
        uint32_t a[KT][4];
        const bf16* pv = pooled + static_cast<int64_t>(n) * C;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t v = ld_pair(pv + 8 * j + 2 * t4);
          set_operand<C>(a, j, v, v);
        }
        pad_operand<C>(a);
        gemm_c<C>(att, a, wsca);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 b = ld_f2(vec + 8 * j + 2 * t4);
          att_g[j][0] = att[j][0] + b.x;
          att_g[j][1] = att[j][1] + b.y;
        }
        att_n = n;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        att[j][0] = att[j][2] = att_g[j][0], att[j][1] = att[j][3] = att_g[j][1];
    }
    NAF_STAGE();
    // conv3 on round(g * att), and the first residual: x1 = x + (. + b3) beta
    uint32_t a[KT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * t4;
      const float2 g0 = bf16x2_f32(ld_pair(gs + gq * LD + col));
      const float2 g1 = bf16x2_f32(ld_pair(gs + (gq + 8) * LD + col));
      set_operand<C>(a, j, bf16x2_bits(g0.x * att[j][0], g0.y * att[j][1]),
                     bf16x2_bits(g1.x * att[j][2], g1.y * att[j][3]));
    }
    pad_operand<C>(a);
    float acc[NT][4];
    gemm_c<C>(acc, a, w3);
    float x1[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * t4;
      const float2 x0 = bf16x2_f32(ld_pair(xs + gq * LD + col));
      const float2 x8 = bf16x2_f32(ld_pair(xs + (gq + 8) * LD + col));
      const float2 b3 = ld_f2(vec + C + col), beta = ld_f2(vec + 2 * C + col);
      x1[j][0] = x0.x + (acc[j][0] + b3.x) * beta.x;
      x1[j][1] = x0.y + (acc[j][1] + b3.y) * beta.y;
      x1[j][2] = x8.x + (acc[j][2] + b3.x) * beta.x;
      x1[j][3] = x8.y + (acc[j][3] + b3.y) * beta.y;
    }
    NAF_STAGE();
    // LN2 of x1 (rows gq and gq + 8: the quad holds a row), rounded
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s0 += x1[j][0] + x1[j][1];
      s1 += x1[j][2] + x1[j][3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    const float m0 = s0 / C, m1 = s1 / C;
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      d0 += (x1[j][0] - m0) * (x1[j][0] - m0) + (x1[j][1] - m0) * (x1[j][1] - m0);
      d1 += (x1[j][2] - m1) * (x1[j][2] - m1) + (x1[j][3] - m1) * (x1[j][3] - m1);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, o);
      d1 += __shfl_xor_sync(0xffffffffu, d1, o);
    }
    const float r0 = rsqrtf(d0 / C + kLnEps), r1 = rsqrtf(d1 / C + kLnEps);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * t4;
      const float2 w = ld_f2(vec + 3 * C + col), b = ld_f2(vec + 4 * C + col);
      set_operand<C>(a, j,
                     bf16x2_bits((x1[j][0] - m0) * r0 * w.x + b.x,
                                 (x1[j][1] - m0) * r0 * w.y + b.y),
                     bf16x2_bits((x1[j][2] - m1) * r1 * w.x + b.x,
                                 (x1[j][3] - m1) * r1 * w.y + b.y));
    }
    pad_operand<C>(a);
    NAF_STAGE();
    // conv4 and the gate: tile j of each half, (. + b4a)(. + b4b), rounded
    uint32_t gt[KT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float da[4] = {0.f, 0.f, 0.f, 0.f}, db[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        uint32_t b[4];
        ldsm_pair(b, w4, LD, 8 * j, C + 8 * j, 16 * k);
        mma_bf16(da, a[k], b[0], b[1]);
        mma_bf16(db, a[k], b[2], b[3]);
      }
      const int col = 8 * j + 2 * t4;
      const float2 ea = ld_f2(vec + 5 * C + col), eb = ld_f2(vec + 6 * C + col);
      set_operand<C>(gt, j,
                     bf16x2_bits((da[0] + ea.x) * (db[0] + eb.x), (da[1] + ea.y) * (db[1] + eb.y)),
                     bf16x2_bits((da[2] + ea.x) * (db[2] + eb.x), (da[3] + ea.y) * (db[3] + eb.y)));
    }
    pad_operand<C>(gt);
    NAF_STAGE();
    // conv5 and the second residual: out = x1 + (. + b5) gamma, into x's buffer
    gemm_c<C>(acc, gt, w5);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * t4;
      const float2 b5 = ld_f2(vec + 7 * C + col), gm = ld_f2(vec + 8 * C + col);
      *reinterpret_cast<uint32_t*>(xs + gq * LD + col) =
          bf16x2_bits(x1[j][0] + (acc[j][0] + b5.x) * gm.x, x1[j][1] + (acc[j][1] + b5.y) * gm.y);
      *reinterpret_cast<uint32_t*>(xs + (gq + 8) * LD + col) =
          bf16x2_bits(x1[j][2] + (acc[j][2] + b5.x) * gm.x, x1[j][3] + (acc[j][3] + b5.y) * gm.y);
    }
    __syncwarp();
    const int64_t base = (static_cast<int64_t>(n) * HW + pix0) * C;
    for (int e = lane; e < npix * CH; e += 32) {
      const int r = e / CH, ch = e - r * CH;
      *reinterpret_cast<uint4*>(out + base + r * C + ch * 8) =
          *reinterpret_cast<const uint4*>(xs + r * LD + ch * 8);
    }
    __syncwarp();
    load(t + kK2BStages * stride, s);  // the stage is free again
  }
  cp_async_wait<0>();
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

template <int C>
int launch_k1(const void* x, const void* const* prm, void* g, int n, int h, int w,
              cudaStream_t st) {
  const K1Params p{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5]};
  const size_t bytes = K1Layout<C>::bytes;
  cudaError_t err = cudaFuncSetAttribute(k1_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (w + kK1TileW - 1) / kK1TileW;
  const int tiles_hw = tiles_w * ((h + kK1TileH - 1) / kK1TileH);
  const int64_t tiles = static_cast<int64_t>(tiles_hw) * n;
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  err = resident_blocks(k1_kernel<C>, kK1Threads, bytes, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  grid = static_cast<int>(tiles < grid ? tiles : grid);
  k1_kernel<C><<<grid, kK1Threads, bytes, st>>>(static_cast<const float*>(x), p,
                                                    static_cast<float*>(g), h, w, tiles_w,
                                                    tiles_hw, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_k2(const void* x, const void* g, const void* pooled, int spatial,
              const void* const* prm, void* out, int n, int hw, cudaStream_t st) {
  const K2Params p{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5],
                   prm[6], prm[7], prm[8], prm[9], prm[10], prm[11]};
  const size_t bytes = K2Layout<C>::bytes;
  cudaError_t err = cudaFuncSetAttribute(k2_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_hw = (hw + kK2Pixels - 1) / kK2Pixels;
  int resident = 0;
  err = resident_blocks(k2_kernel<C>, kK2Threads, bytes, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks per image: enough to fill the card once over all n images
  int per_image = (resident + n - 1) / n;
  per_image = tiles_hw < per_image ? tiles_hw : per_image;
  const dim3 grid(per_image, n);
  k2_kernel<C><<<grid, kK2Threads, bytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), static_cast<const float*>(pooled),
      spatial, p, static_cast<float*>(out), hw, tiles_hw);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_k1_bf16(const void* x, const void* const* prm, void* g, int n, int h, int w,
                   cudaStream_t st) {
  const K1BParams p{static_cast<const bf16*>(prm[0]), static_cast<const float*>(prm[1])};
  const size_t bytes = K1BLayout<C>::bytes;
  cudaError_t err = cudaFuncSetAttribute(k1_bf16_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int strip_w = k1b_pix(C) - 2;
  const int strips = (w + strip_w - 1) / strip_w;
  const int segs = (h + kK1BRows - 1) / kK1BRows;
  const int64_t items = static_cast<int64_t>(n) * strips * segs;
  if (items > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  err = resident_blocks(k1_bf16_kernel<C>, kK1BThreads, bytes, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  grid = static_cast<int>(items < grid ? items : grid);
  k1_bf16_kernel<C><<<grid, kK1BThreads, bytes, st>>>(static_cast<const bf16*>(x), p,
                                                      static_cast<bf16*>(g), h, w, strips, segs,
                                                      static_cast<int>(items));
  return static_cast<int>(cudaGetLastError());
}

template <int C, bool SPATIAL>
int launch_k2_bf16(const void* x, const void* g, const void* pooled, const void* const* prm,
                   void* out, int n, int hw, cudaStream_t st) {
  const K2BParams p{static_cast<const bf16*>(prm[0]), static_cast<const bf16*>(prm[1]),
                    static_cast<const bf16*>(prm[2]), static_cast<const bf16*>(prm[3]),
                    static_cast<const float*>(prm[4])};
  const size_t bytes = K2BLayout<C, SPATIAL>::bytes;
  cudaError_t err = cudaFuncSetAttribute(k2_bf16_kernel<C, SPATIAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_hw = (hw + kK2BRows - 1) / kK2BRows;
  const int64_t tiles = static_cast<int64_t>(tiles_hw) * n;
  if (tiles > INT32_MAX / 2) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  err = resident_blocks(k2_bf16_kernel<C, SPATIAL>, kK2BThreads, bytes, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (tiles + kK2BWarps - 1) / kK2BWarps;
  grid = static_cast<int>(needed < grid ? needed : grid);
  k2_bf16_kernel<C, SPATIAL><<<grid, kK2BThreads, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const bf16*>(pooled),
      p, static_cast<bf16*>(out), hw, tiles_hw, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_k2_bf16(const void* x, const void* g, const void* pooled, int spatial,
                   const void* const* prm, void* out, int n, int hw, cudaStream_t st) {
  return spatial ? launch_k2_bf16<C, true>(x, g, pooled, prm, out, n, hw, st)
                 : launch_k2_bf16<C, false>(x, g, pooled, prm, out, n, hw, st);
}

int dispatch_k1_bf16(int c, const void* x, const void* const* prm, void* g, int n, int h, int w,
                     cudaStream_t st) {
  switch (c) {
    case 8: return launch_k1_bf16<8>(x, prm, g, n, h, w, st);
    case 16: return launch_k1_bf16<16>(x, prm, g, n, h, w, st);
    case 32: return launch_k1_bf16<32>(x, prm, g, n, h, w, st);
    case 64: return launch_k1_bf16<64>(x, prm, g, n, h, w, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_k2_bf16(int c, const void* x, const void* g, const void* pooled, int spatial,
                     const void* const* prm, void* out, int n, int hw, cudaStream_t st) {
  switch (c) {
    case 8: return launch_k2_bf16<8>(x, g, pooled, spatial, prm, out, n, hw, st);
    case 16: return launch_k2_bf16<16>(x, g, pooled, spatial, prm, out, n, hw, st);
    case 32: return launch_k2_bf16<32>(x, g, pooled, spatial, prm, out, n, hw, st);
    case 64: return launch_k2_bf16<64>(x, g, pooled, spatial, prm, out, n, hw, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_k1(int c, const void* x, const void* const* prm, void* g, int n, int h,
                int w, cudaStream_t st) {
  switch (c) {
    case 8: return launch_k1<8>(x, prm, g, n, h, w, st);
    case 16: return launch_k1<16>(x, prm, g, n, h, w, st);
    case 32: return launch_k1<32>(x, prm, g, n, h, w, st);
    case 64: return launch_k1<64>(x, prm, g, n, h, w, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_k2(int c, const void* x, const void* g, const void* pooled, int spatial,
                const void* const* prm, void* out, int n, int hw, cudaStream_t st) {
  switch (c) {
    case 8: return launch_k2<8>(x, g, pooled, spatial, prm, out, n, hw, st);
    case 16: return launch_k2<16>(x, g, pooled, spatial, prm, out, n, hw, st);
    case 32: return launch_k2<32>(x, g, pooled, spatial, prm, out, n, hw, st);
    case 64: return launch_k2<64>(x, g, pooled, spatial, prm, out, n, hw, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and g). params of the general form
// (float32), in x's dtype: norm1 weight and bias, conv1 weight and bias,
// conv2 weight and bias. Of the bf16 form: conv1's weight (2C, C) in bf16
// and one float32 array of norm1's weight and bias, conv1's and conv2's
// biases and conv2's taps (9, 2C). x 16-byte aligned for the bf16 form.
extern "C" int nafblock_k1(const void* x, const void* const* params, void* g, int dtype,
                           int n, int h, int w, int c, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_k1(c, x, params, g, n, h, w, st);
  if (dtype == 1) return dispatch_k1_bf16(c, x, params, g, n, h, w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// params of the general form (float32): sca.1 weight and bias, conv3
// weight and bias, beta, norm2 weight and bias, conv4 weight and bias, conv5
// weight and bias, gamma. Of the bf16 form: the weights of sca.1, conv3,
// conv4 and conv5 in bf16 and one float32 array of sca.1's and conv3's
// biases, beta, norm2's weight and bias, conv4's and conv5's biases and
// gamma. pooled is (n,h,w,c) with spatial = 1, or (n,1,1,c) with spatial =
// 0. x, g, pooled and out 16-byte aligned for the bf16 form.
extern "C" int nafblock_k2(const void* x, const void* g, const void* pooled, int spatial,
                           const void* const* params, void* out, int dtype, int n, int h,
                           int w, int c, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hw = h * w;
  if (dtype == 0) return dispatch_k2(c, x, g, pooled, spatial, params, out, n, hw, st);
  if (dtype == 1) return dispatch_k2_bf16(c, x, g, pooled, spatial, params, out, n, hw, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
