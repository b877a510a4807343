// The fused RestormerBlock on Hopper (sm_90a): two kernels, each the
// counterpart of a Pallas TPU kernel in enhax/kernels/restormer_block.py.
//
//   r1  replaces _r1_kernel (called from restormer_block_fast): LayerNorm
//       (eps 1e-5) -> qkv 1x1 C->3C -> depthwise 3x3 on 3C (no biases, SAME).
//       Writes V only; accumulates over every pixel of the image the per-head
//       raw gram q_h^T k_h (stacked heads*hd x hd, f32) and the per-channel
//       sums of squares of q and k (f32).
//   r2  replaces _r2_kernel: per head out = v_h attn_h^T, project_out C->C,
//       x1 = x + .; LayerNorm -> project_in C->2h -> depthwise 3x3 ->
//       gelu(a) * b -> project_out h->C -> x1 + . .
//
// Rounding follows the TPU kernels: matmul operands are rounded to the
// params' type T and the products summed in f32 (bf16 products are exact in
// f32); LayerNorm, the taps, GELU and the residuals are f32; outputs are
// stored once in T. The sums of squares are of the unrounded q and k. The
// wrapper hands every weight over as f32 (an exact copy of the T values):
// the qkv weight (3C, C), the taps (3C, 9), project_out (C, C), attn
// (B, C, hd), project_in (2hp, C) with its taps (2hp, 9) and project_out
// (C, hp), the hidden width h padded to hp, a multiple of 32, with zero
// weights (exact: gelu(0) * 0 = 0) and the rows ordered so that each chunk
// of 32 gate pairs is one block of 64 rows [a_j..., b_j...].
//
// Bound. At the main path's shapes (chunks of 8 tiles of 384x384, bf16) both
// are bound by operations, not bytes: R1 moves 4C bytes a pixel for 6C^2 +
// 2C*hd flops of 1x1 and gram, R2 6C bytes for 2C*hd + 2C^2 + 6C*h flops
// (h = 2.66C); at C=48 that is 15 and 9 times the tensor cores' 295 flops a
// byte. On bf16 the 1x1s and the gram run on the tensor cores (mma.sync
// m16n8k16: bf16 operands, f32 accumulators, so the TPU's rounding holds:
// bf16 products are exact in f32); on float32 they are f32 FMAs (the f32
// rate, 67 TFLOP/s, is that path's roof). The 1x1s are recomputed over a
// one-pixel halo. The taps, LayerNorm and GELU stay on the FMA units;
// wgmma with TMA-fed tiles is a later step.
//
// Design.
//   A tile is TH x TW output pixels and its one-pixel halo, PH = (TH+2)(TW+2)
//   pixels: 8x8 (PH 100) up to C=192, 4x8 (PH 60) at C=384, where the
//   operands would not fit. A block of 256 threads holds in shared memory,
//   in f32, the tile's matmul operand over the halo (PH x C, odd row stride:
//   no bank conflicts) and streams the weights from global memory (L1/L2
//   resident, the same address across a warp) in chunks of output channels.
//   The products are register-tiled: on float32 a thread computes 2 pixels
//   x 8 outputs from float4 weight loads; on bf16 a warp computes 16 pixels
//   x 16 outputs with mma, packing the (already rounded) f32 operands into
//   bf16 pairs as it loads them. A 1x1's output over the halo is zeroed at the
//   pixels outside the image after the 1x1 (the dw conv's SAME padding;
//   zeroing x would feed the taps LN(0) @ W); then a thread takes one
//   channel of one tile column, holds its taps in registers and walks down
//   the column with a window of three halo rows (as K1 in nafblock.cu).
//   r1: grid (splits, heads, images). A block takes one head of one image
//     and walks a run of its tiles: LN of the halo; per group (q_h, k_h,
//     v_h) the hd-wide 1x1 and the taps; v_h is stored, q_h and k_h stay in
//     shared memory (P x hd each) for the sums of squares (a thread a
//     channel, unrounded) and the gram (Gram: on float32 a thread a 3x3
//     or 6x6 block of it, on bf16 a warp a set of mma tiles). Each tile's
//     sums start from zero and are added to the run's sums, held in
//     registers. At the end of its run a block writes one partial gram
//     and one partial pair of sums to scratch (images, splits, ...); a
//     second kernel sums the partials in split order. No atomics: the result
//     is the same from run to run.
//     Shared memory: PH x lda + PH x ldh + 2 P x ldq floats (strides in
//     Geo): float32 / bf16 65 / 72 KB at C=48, 128 / 135 KB at C=96 (one
//     head), 84 / 91 KB at C=96 (two), 122 / 129 KB at C=192, 117 / 121 KB
//     at C=384.
//   r2: blocks that stay resident walk over all tiles. Load x -> x1 and v
//     over the halo; per head attn @ v (rounded) and its project_out added
//     into x1 over the halo; LN of x1 over the halo into the operand
//     buffer; per chunk of 32 hidden channels: project_in over the halo
//     (64 outputs), taps and gate on the tile (rounded), project_out of the
//     chunk added into x1 on the tile; store x1 on the tile.
//     Shared memory: 2 PH x lda floats plus the larger of the attention
//     output PH x ldh and the chunk's PH x 65 + P x ldg: float32 / bf16
//     74 / 81 KB at C=48, 117 / 125 KB at C=96 (one head), 112 / 120 KB at
//     C=96 (two), 189 / 197 KB at C=192, 205 / 209 KB at C=384.
//
// The tap-folded forms (FOLD = true; restormer_r1_mxu, restormer_r2_mxu)
// replace the same two pallas_calls with dw_mxu=True (restormer_block.py:327
// and :378; _dw9_inputs :111, _fold_dw_into_pointwise :131). Each 1x1 -> dw
// 3x3 pair is one product with K = 9C against a weight folded by the wrapper
// (W[i, o] k[dh, dx, o], rounded to T after the fold, as the TPU kernel's
// caller does), on the tile's own P pixels only: no taps stage and no 1x1
// over the halo. The A operand is never built: the Taps policy reads the LN
// tile in shared memory at pixel (r + dh, c + dx), so a fragment of K-block
// (tap, i0) is a shifted read of the halo tile (the LN is zeroed at every
// halo pixel outside the image, in H and in W: that is the dw conv's SAME
// padding, exact because the 1x1 has no bias; zeroing x would give LN(0) =
// the LN's bias). The folded weights (3C x 9C, handed over in f32: 15.9 MB
// at C = 384, far beyond a block's shared memory) stream from L2 a K-slice
// of 16 at a time, as the 1x1s' do.
//   Bound: operations. R1 does 54 C^2 flops a pixel on the tensor cores
//   (vs 6 C^2 for the 1x1 and 54 C f32 tap flops), R2 36 C h for the folded
//   project_in (vs 4 C h + 36 h); at dec0 that is 0.634 / 1.30 ms against
//   0.198 / 0.531 ms for the default forms. It pays only where the default
//   forms' taps and halo recompute cost more than the 9x tensor-core work.
//   Shared memory: R1 drops the 1x1 output buffer (93 KB at C = 96, one
//   head, in bf16; at most 107 KB): two blocks share an SM, with registers
//   for two; R2 holds its chunk's 1x1 output on the tile only.
//
// Entry points have a plain C interface for ctypes. They launch on the
// stream they are given, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kLnEps = 1e-5f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // R2's hidden channels a pass
constexpr size_t kMaxSmem = 232448;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_erf(float a) {
  return 0.5f * a * (1.0f + erff(a * 0.70710678118654752f));
}

// ------------------------------------------------------------- geometry ---

// Row strides (floats) of the shared tiles. The float32 path's products
// read A down its rows (a warp's lanes on neighbouring rows): odd strides,
// no bank conflicts. The bf16 path's mma fragments read row g, columns 2t
// and 2t + 1 (lane = 4g + t) as float2: strides of 8 (mod 32) put a
// half-warp's 16 lanes on 16 distinct bank pairs; the gram reads q and k
// at rows 2t, column g: strides of 4 (mod 16) put the 32 lanes on 32 banks.
template <int C, int HEADS, bool MMA>
struct Geo {
  static constexpr int HD = C / HEADS;
  static constexpr int TH = C >= 384 ? 4 : 8;
  static constexpr int TW = 8;
  static constexpr int HW2 = TW + 2;
  static constexpr int PH = (TH + 2) * HW2;  // halo pixels of a tile
  static constexpr int P = TH * TW;          // output pixels of a tile
  static constexpr int LDA = MMA ? C + 8 : C + 1;
  static constexpr int LDH = MMA ? HD + 8 : HD + 1;
  static constexpr int LDQ = MMA ? HD + 4 : HD + 1;
  static constexpr int LDY = 2 * kChunk + 1;
  static constexpr int LDG = MMA ? kChunk + 8 : kChunk + 1;
  static_assert(HD % 16 == 0 && 2 * HD <= kThreads, "head width");
};

template <typename T>
constexpr bool kMma = std::is_same_v<T, __nv_bfloat16>;

template <typename T, int C, int HEADS, bool FOLD>
struct R1Layout {
  using G = Geo<C, HEADS, kMma<T>>;
  static constexpr int a = 0;                         // LN(x) over the halo
  static constexpr int y = a + G::PH * G::LDA;        // one group's 1x1 output
  static constexpr int q = y + (FOLD ? 0 : G::PH * G::LDH);  // q_h on the tile
  static constexpr int k = q + G::P * G::LDQ;         // k_h on the tile
  static constexpr int inside = k + G::P * G::LDQ;    // halo pixel in the image
  static constexpr int floats = inside + G::PH;
  static constexpr size_t bytes = floats * sizeof(float);
  static_assert(bytes <= kMaxSmem, "R1 shared memory");
};

template <typename T, int C, int HEADS, bool FOLD>
struct R2Layout {
  using G = Geo<C, HEADS, kMma<T>>;
  static constexpr int v = 0;                         // v, then LN(x1), over the halo
  static constexpr int x1 = v + G::PH * G::LDA;       // x, then x1, then out
  static constexpr int u = x1 + G::PH * G::LDA;       // attention output, or:
  static constexpr int y = u;                         //   a chunk's 1x1 output
  static constexpr int YROWS = FOLD ? G::P : G::PH;   //   (FOLD: on the tile only)
  static constexpr int g = y + YROWS * G::LDY;        //   and its gate
  static constexpr int u_floats = G::PH * G::LDH > YROWS * G::LDY + G::P * G::LDG
                                      ? G::PH * G::LDH
                                      : YROWS * G::LDY + G::P * G::LDG;
  static constexpr int inside = u + u_floats;
  static constexpr int floats = inside + G::PH;
  static constexpr size_t bytes = floats * sizeof(float);
  static_assert(bytes <= kMaxSmem, "R2 shared memory");
};

// ------------------------------------------------------------- products ---

// How a product reads its A operand: element (m, k) at A[row(m) + col(k)].
// Dense: a matrix with row stride lda.
struct Dense {
  int lda;
  __device__ __forceinline__ int row(int m) const { return m * lda; }
  __device__ __forceinline__ int col(int k) const { return k; }
};

// The implicit im2col of the tap-folded 1x1 (FOLD): A is a halo tile in
// shared memory (row stride lda, (TH + 2) x (TW + 2) pixels); row m is output
// pixel (m / TW, m % TW) of the tile, column k = tap * C + i (tap = 3 dh + dx)
// reads channel i of halo pixel (m / TW + dh, m % TW + dx). A column block of
// 4 or 16 never crosses a tap (C % 16 == 0).
template <int C, int TW>
struct Taps {
  int lda;
  __device__ __forceinline__ int row(int m) const {
    return ((m / TW) * (TW + 2) + m % TW) * lda;
  }
  __device__ __forceinline__ int col(int k) const {
    const int tap = k / C;
    return ((tap / 3) * (TW + 2) + tap % 3) * lda + (k - tap * C);
  }
};

// out[m][n] = sum_k A(m, k) * W[n * ldw + k] for m < M, n < N, handed to
// epi(m, n, value). A is in shared memory, read through the policy AP (Dense
// or Taps), W in global memory (f32, rows 16-byte aligned); K % 4 == 0 and
// N % RN == 0. A thread computes RM rows
// (strided by M / RM, so a warp's lanes read neighbouring rows) by RN
// outputs (the same across most of a warp: the weight loads broadcast).
template <int RM, int RN, typename AP, typename Epi>
__device__ __forceinline__ void gemm(const AP& addr, const float* A, int M,
                                     const float* __restrict__ W, int ldw, int N, int K,
                                     const Epi& epi) {
  const int mr = (M + RM - 1) / RM;
  const int items = mr * (N / RN);
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int cg = item / mr;
    const int rg = item - cg * mr;
    const float* ap[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = rg + i * mr;
      ap[i] = A + addr.row(m < M ? m : 0);
    }
    const float* wp = W + static_cast<int64_t>(cg * RN) * ldw;
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      const int kc = addr.col(k);
      float a[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) a[i][kk] = ap[i][kc + kk];
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(wp + j * ldw + k));
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          acc[i][j] = fmaf(a[i][0], w.x, acc[i][j]);
          acc[i][j] = fmaf(a[i][1], w.y, acc[i][j]);
          acc[i][j] = fmaf(a[i][2], w.z, acc[i][j]);
          acc[i][j] = fmaf(a[i][3], w.w, acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = rg + i * mr;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < RN; ++j) epi(m, cg * RN + j, acc[i][j]);
    }
  }
}

// two f32 values that are bf16 already, packed for mma (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a * b: one m16n8k16 product, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The product of gemm() on the tensor cores, for operands that are bf16
// values (the bf16 path rounds them before they are stored): a warp computes
// 16 rows by 8 * NT outputs with m16n8k16 mma. Lane (g, t) = (lane / 4,
// lane % 4) packs A rows g and g + 8 at columns 2t, 2t + 1 (+8) from shared
// memory (float2 loads: lda even) and the weight row g of each 8-wide block
// at the same columns from global memory. K % 16 == 0, N % (8 NT) == 0;
// rows past M read row M - 1 and are not stored.
template <int NT, typename AP, typename Epi>
__device__ __forceinline__ void gemm_mma(const AP& addr, const float* A, int M,
                                         const float* __restrict__ W, int ldw, int N, int K,
                                         const Epi& epi) {
  // the folded products' K is 9C: four K-steps in flight hide more of the
  // weights' L2 latency
  constexpr int kUnroll = std::is_same_v<AP, Dense> ? 2 : 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mtiles = (M + 15) / 16;
  const int items = mtiles * (N / (8 * NT));
  for (int item = warp; item < items; item += kWarps) {
    const int ng = item / mtiles, mt = item - ng * mtiles;
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    const float* a0 = A + addr.row(r0 < M ? r0 : M - 1) + 2 * t;
    const float* a1 = A + addr.row(r1 < M ? r1 : M - 1) + 2 * t;
    const float* wp[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      wp[j] = W + static_cast<int64_t>((ng * NT + j) * 8 + g) * ldw + 2 * t;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll kUnroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int kc = addr.col(k0);
      const float2 x00 = *reinterpret_cast<const float2*>(a0 + kc);
      const float2 x10 = *reinterpret_cast<const float2*>(a1 + kc);
      const float2 x01 = *reinterpret_cast<const float2*>(a0 + kc + 8);
      const float2 x11 = *reinterpret_cast<const float2*>(a1 + kc + 8);
      const uint32_t a[4] = {pack_bf16(x00.x, x00.y), pack_bf16(x10.x, x10.y),
                             pack_bf16(x01.x, x01.y), pack_bf16(x11.x, x11.y)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 w0 = __ldg(reinterpret_cast<const float2*>(wp[j] + k0));
        const float2 w1 = __ldg(reinterpret_cast<const float2*>(wp[j] + k0 + 8));
        const uint32_t b[2] = {pack_bf16(w0.x, w0.y), pack_bf16(w1.x, w1.y)};
        mma_bf16(acc[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = (ng * NT + j) * 8 + 2 * t;
      if (r0 < M) {
        epi(r0, col, acc[j][0]);
        epi(r0, col + 1, acc[j][1]);
      }
      if (r1 < M) {
        epi(r1, col, acc[j][2]);
        epi(r1, col + 1, acc[j][3]);
      }
    }
  }
}

// bf16 operands go to the tensor cores; float32 keeps its FMAs
template <typename T, typename AP, typename Epi>
__device__ __forceinline__ void gemm_t(const AP& addr, const float* A, int M,
                                       const float* __restrict__ W, int ldw, int N, int K,
                                       const Epi& epi) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    gemm_mma<2>(addr, A, M, W, ldw, N, K, epi);
  } else {
    gemm<2, 8>(addr, A, M, W, ldw, N, K, epi);
  }
}

template <typename T, typename Epi>
__device__ __forceinline__ void gemm_t(const float* A, int lda, int M,
                                       const float* __restrict__ W, int ldw, int N, int K,
                                       const Epi& epi) {
  gemm_t<T>(Dense{lda}, A, M, W, ldw, N, K, epi);
}

// The per-head gram q_h^T k_h of a block's run of tiles, held in
// registers. Each tile's P pixels are summed from zero and then added to
// the run's sum: two short chains of f32 adds, not one of ~9000, whose
// rounding error would grow with the image. qs and ks are P x HD with row
// stride LD.
template <typename T, int HD, int P, int LD>
struct Gram;

// float32: a thread holds an MG x MG block, rows i + 16a, columns j + 16b
template <int HD, int P, int LD>
struct Gram<float, HD, P, LD> {
  static constexpr int MG = HD / 16;
  float acc[MG][MG];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int a = 0; a < MG; ++a)
#pragma unroll
      for (int b = 0; b < MG; ++b) acc[a][b] = 0.f;
  }

  __device__ __forceinline__ void add_tile(const float* qs, const float* ks) {
    const int gi = threadIdx.x / 16, gj = threadIdx.x % 16;
    float part[MG][MG];
#pragma unroll
    for (int a = 0; a < MG; ++a)
#pragma unroll
      for (int b = 0; b < MG; ++b) part[a][b] = 0.f;
    for (int px = 0; px < P; ++px) {
      float qa[MG], kb[MG];
#pragma unroll
      for (int a = 0; a < MG; ++a) qa[a] = qs[px * LD + gi + 16 * a];
#pragma unroll
      for (int b = 0; b < MG; ++b) kb[b] = ks[px * LD + gj + 16 * b];
#pragma unroll
      for (int a = 0; a < MG; ++a)
#pragma unroll
        for (int b = 0; b < MG; ++b) part[a][b] = fmaf(qa[a], kb[b], part[a][b]);
    }
#pragma unroll
    for (int a = 0; a < MG; ++a)
#pragma unroll
      for (int b = 0; b < MG; ++b) acc[a][b] += part[a][b];
  }

  __device__ __forceinline__ void store(float* gp) const {
    const int gi = threadIdx.x / 16, gj = threadIdx.x % 16;
#pragma unroll
    for (int a = 0; a < MG; ++a)
#pragma unroll
      for (int b = 0; b < MG; ++b) gp[(gi + 16 * a) * HD + gj + 16 * b] = acc[a][b];
  }
};

// bf16: the HD x HD gram is (HD/16) x (HD/8) mma tiles, dealt to the warps
// in turn; the contraction runs over the pixels (A = q^T, B = k)
template <int HD, int P, int LD>
struct Gram<__nv_bfloat16, HD, P, LD> {
  static constexpr int NTILE = HD / 8;
  static constexpr int TILES = (HD / 16) * NTILE;
  static constexpr int PER = (TILES + kWarps - 1) / kWarps;
  static_assert(P % 16 == 0, "gram tiles");
  float acc[PER][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < PER; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void add_tile(const float* qs, const float* ks) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int tile = warp + kWarps * i;
      if (tile >= TILES) break;
      const int c = (tile / NTILE) * 16 + g, d = (tile % NTILE) * 8 + g;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k0 = 0; k0 < P; k0 += 16) {
        const float* q = qs + (k0 + 2 * t) * LD + c;  // pixels k0 + 2t, +1, +8, +9
        const float* k = ks + (k0 + 2 * t) * LD + d;
        const uint32_t a[4] = {pack_bf16(q[0], q[LD]), pack_bf16(q[8], q[LD + 8]),
                               pack_bf16(q[8 * LD], q[9 * LD]),
                               pack_bf16(q[8 * LD + 8], q[9 * LD + 8])};
        const uint32_t b[2] = {pack_bf16(k[0], k[LD]), pack_bf16(k[8 * LD], k[9 * LD])};
        mma_bf16(part, a, b);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[j];
    }
  }

  __device__ __forceinline__ void store(float* gp) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int tile = warp + kWarps * i;
      if (tile >= TILES) break;
      const int r = (tile / NTILE) * 16 + g, col = (tile % NTILE) * 8 + 2 * t;
      gp[r * HD + col] = acc[i][0];
      gp[r * HD + col + 1] = acc[i][1];
      gp[(r + 8) * HD + col] = acc[i][2];
      gp[(r + 8) * HD + col + 1] = acc[i][3];
    }
  }
};

// a 1x1 over the halo: zero at the pixels outside the image
struct StoreMasked {
  float* y;
  int ld;
  const float* inside;
  __device__ void operator()(int m, int n, float v) const {
    y[m * ld + n] = inside[m] != 0.f ? v : 0.f;
  }
};

struct Store {
  float* y;
  int ld;
  __device__ void operator()(int m, int n, float v) const { y[m * ld + n] = v; }
};

// row m of a tile's output pixels is image pixel (h0 + m / TW, w0 + m % TW)
template <int TW>
struct TilePixel {
  int h0, w0, H, W;
  __device__ __forceinline__ bool inside(int m) const {
    return h0 + m / TW < H && w0 + m % TW < W;
  }
  __device__ __forceinline__ int64_t index(int m) const {
    return static_cast<int64_t>(h0 + m / TW) * W + w0 + m % TW;
  }
};

// a product on the tile's own pixels: zero at the pixels outside the image
template <int TW>
struct StoreTileMasked {
  float* y;
  int ld;
  TilePixel<TW> px;
  __device__ void operator()(int m, int n, float v) const {
    y[m * ld + n] = px.inside(m) ? v : 0.f;
  }
};

// a product on the tile's own pixels into an NHWC image (channel stride ldc),
// where the pixel lies inside it
template <typename T, int TW>
struct StoreImage {
  T* out;
  int ldc;
  TilePixel<TW> px;
  __device__ void operator()(int m, int n, float v) const {
    if (px.inside(m)) out[px.index(m) * ldc + n] = from_f32<T>(v);
  }
};

template <typename T>
struct StoreRounded {
  float* y;
  int ld;
  __device__ void operator()(int m, int n, float v) const { y[m * ld + n] = round_to<T>(v); }
};

struct AddTo {
  float* y;
  int ld;
  __device__ void operator()(int m, int n, float v) const { y[m * ld + n] += v; }
};

// row m of a tile's output pixels is halo pixel (m / TW + 1, m % TW + 1)
template <int TW>
struct AddInterior {
  float* y;
  int ld;
  __device__ void operator()(int m, int n, float v) const {
    const int hm = (m / TW + 1) * (TW + 2) + m % TW + 1;
    y[hm * ld + n] += v;
  }
};

// LayerNorm of a C-row (in registers, NV per lane of a warp), rounded to T
template <typename T, int C, int NV>
__device__ __forceinline__ void ln_store(float (&v)[NV], const float* __restrict__ lnw,
                                         const float* __restrict__ lnb, float* dst) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) s += v[i];
  const float mean = warp_sum(s) / C;
  float d2 = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    const float d = c < C ? v[i] - mean : 0.f;
    d2 += d * d;
  }
  const float rstd = 1.0f / sqrtf(warp_sum(d2) / C + kLnEps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < C) dst[c] = round_to<T>((v[i] - mean) * rstd * __ldg(lnw + c) + __ldg(lnb + c));
  }
}

// ------------------------------------------------------------------- R1 ---

struct R1Params {
  const float* ln_w;
  const float* ln_b;
  const float* wqkv;  // (3C, C); FOLD: the tap-folded (3C, 9C)
  const float* dw;    // (3C, 9); FOLD: unused
};

// FOLD needs no 1x1 output over the halo: two blocks fit an SM's shared
// memory at every width, so it asks for registers for two
template <typename T, int C, int HEADS, bool FOLD>
__global__ void __launch_bounds__(kThreads, FOLD ? 2 : 1)
r1_kernel(const T* __restrict__ x, R1Params p, T* __restrict__ v, float* __restrict__ gram_part,
          float* __restrict__ ss_part, int H, int W, int tiles_w, int tiles) {
  using G = Geo<C, HEADS, kMma<T>>;
  using L = R1Layout<T, C, HEADS, FOLD>;
  constexpr int HD = G::HD, TH = G::TH, TW = G::TW, HW2 = G::HW2, PH = G::PH, P = G::P;
  constexpr int NV = (C + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* as = smem + L::a;
  float* ys = smem + L::y;
  float* qs = smem + L::q;
  float* ks = smem + L::k;
  float* inside = smem + L::inside;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, splits = gridDim.x, hh = blockIdx.y, n = blockIdx.z;
  const int t0 = static_cast<int>(static_cast<int64_t>(split) * tiles / splits);
  const int t1 = static_cast<int>(static_cast<int64_t>(split + 1) * tiles / splits);
  Gram<T, HD, P, G::LDQ> gram;
  gram.zero();
  float ss = 0.f;  // tid < HD: sum q_c^2; HD <= tid < 2HD: sum k_c^2

  for (int t = t0; t < t1; ++t) {
    const int h0 = (t / tiles_w) * TH, w0 = (t % tiles_w) * TW;
    // LayerNorm of the halo pixels, a warp a pixel, rounded to T
    for (int q = warp; q < PH; q += kWarps) {
      const int gh = h0 - 1 + q / HW2, gw = w0 - 1 + q % HW2;
      const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W;
      if (lane == 0) inside[q] = in ? 1.f : 0.f;
      float* dst = as + q * G::LDA;
      if (!in) {
        for (int c = lane; c < C; c += 32) dst[c] = 0.f;
        continue;
      }
      const T* xp = x + ((static_cast<int64_t>(n) * H + gh) * W + gw) * C;
      float xv[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + 32 * i;
        xv[i] = c < C ? to_f32(xp[c]) : 0.f;
      }
      ln_store<T, C, NV>(xv, p.ln_w, p.ln_b, dst);
    }
    __syncthreads();

    if constexpr (FOLD) {
      // q_h, k_h, v_h straight from the LN tile: one product on the tile's
      // own pixels, K = 9C through the implicit im2col, no taps stage and no
      // 1x1 over the halo (the LN is zero outside the image)
      const Taps<C, TW> taps{G::LDA};
      const TilePixel<TW> px{h0, w0, H, W};
      const float* wq = p.wqkv + static_cast<int64_t>(hh * HD) * 9 * C;
      gemm_t<T>(taps, as, P, wq, 9 * C, HD, 9 * C, StoreTileMasked<TW>{qs, G::LDQ, px});
      gemm_t<T>(taps, as, P, wq + static_cast<int64_t>(C) * 9 * C, 9 * C, HD, 9 * C,
                StoreTileMasked<TW>{ks, G::LDQ, px});
      gemm_t<T>(taps, as, P, wq + static_cast<int64_t>(2 * C) * 9 * C, 9 * C, HD, 9 * C,
                StoreImage<T, TW>{v + static_cast<int64_t>(n) * H * W * C + hh * HD, C, px});
      __syncthreads();
    } else {
      for (int grp = 0; grp < 3; ++grp) {  // q_h, k_h, v_h
        const int row0 = grp * C + hh * HD;  // first qkv channel of the group
        gemm_t<T>(as, G::LDA, PH, p.wqkv + static_cast<int64_t>(row0) * C, C, HD, C,
                   StoreMasked{ys, G::LDH, inside});
        __syncthreads();
        // the taps: a thread takes one channel of one tile column, holds its
        // 9 taps in registers and walks down the column with a window of
        // three halo rows, so each 1x1 output is read three times, not nine
        for (int item = tid; item < HD * TW; item += kThreads) {
          const int j = item % HD, cc = item / HD;
          const float* tap = p.dw + static_cast<int64_t>(row0 + j) * 9;
          float wt[9];
#pragma unroll
          for (int i = 0; i < 9; ++i) wt[i] = __ldg(tap + i);
          float win[3][3];  // [halo row % 3][dx]
#pragma unroll
          for (int hr = 0; hr < TH + 2; ++hr) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) win[hr % 3][dx] = ys[(hr * HW2 + cc + dx) * G::LDH + j];
            if (hr < 2) continue;
            const int r = hr - 2;
            float acc = 0.f;
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
#pragma unroll
              for (int dy = 0; dy < 3; ++dy) acc = fmaf(win[(r + dy) % 3][dx], wt[dy * 3 + dx], acc);
            const bool valid = h0 + r < H && w0 + cc < W;
            const int px = r * TW + cc;
            if (grp == 0) {
              qs[px * G::LDQ + j] = valid ? acc : 0.f;
            } else if (grp == 1) {
              ks[px * G::LDQ + j] = valid ? acc : 0.f;
            } else if (valid) {
              v[((static_cast<int64_t>(n) * H + h0 + r) * W + w0 + cc) * C + hh * HD + j] =
                  from_f32<T>(acc);
            }
          }
        }
        __syncthreads();
      }
    }

    // sums of squares of the unrounded q and k, a thread a channel, summed
    // in two levels as the gram is
    if (tid < 2 * HD) {
      const float* src = tid < HD ? qs + tid : ks + (tid - HD);
      float part = 0.f;
      for (int px = 0; px < P; ++px) part = fmaf(src[px * G::LDQ], src[px * G::LDQ], part);
      ss += part;
    }
    __syncthreads();
    // the gram's operands are rounded to T
    for (int e = tid; e < 2 * P * G::LDQ; e += kThreads) qs[e] = round_to<T>(qs[e]);
    __syncthreads();
    gram.add_tile(qs, ks);
    __syncthreads();
  }

  // this block's partials: gram_part (images, splits, C, HD), ss_part
  // (images, splits, 2, C); a block with no tiles writes zeros
  const int64_t base = static_cast<int64_t>(n) * splits + split;
  gram.store(gram_part + (base * C + hh * HD) * HD);
  if (tid < HD) {
    ss_part[base * 2 * C + hh * HD + tid] = ss;
  } else if (tid < 2 * HD) {
    ss_part[base * 2 * C + C + hh * HD + tid - HD] = ss;
  }
}

// gram (images, C, HD), qss and kss (images, C): the partials summed in
// split order
__global__ void r1_reduce(const float* __restrict__ gram_part,
                          const float* __restrict__ ss_part, float* __restrict__ gram,
                          float* __restrict__ qss, float* __restrict__ kss, int images,
                          int splits, int C, int HD) {
  const int64_t per = static_cast<int64_t>(C) * HD + 2 * C;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= images * per) return;
  const int64_t n = e / per, r = e - n * per;
  float s = 0.f;
  if (r < static_cast<int64_t>(C) * HD) {
    for (int k = 0; k < splits; ++k) s += gram_part[(n * splits + k) * C * HD + r];
    gram[n * C * HD + r] = s;
  } else {
    const int64_t r2 = r - static_cast<int64_t>(C) * HD;  // [0, 2C): q then k
    for (int k = 0; k < splits; ++k) s += ss_part[(n * splits + k) * 2 * C + r2];
    if (r2 < C) {
      qss[n * C + r2] = s;
    } else {
      kss[n * C + r2 - C] = s;
    }
  }
}

// ------------------------------------------------------------------- R2 ---

struct R2Params {
  const float* attn;   // (B, C, HD)
  const float* wp;     // (C, C)
  const float* ln_w;
  const float* ln_b;
  const float* win;    // (2hp, C), chunk-ordered; FOLD: tap-folded (2hp, 9C)
  const float* dw;     // (2hp, 9), chunk-ordered; FOLD: unused
  const float* wout;   // (C, hp)
};

template <typename T, int C, int HEADS, bool FOLD>
__global__ void __launch_bounds__(kThreads, 1)
r2_kernel(const T* __restrict__ x, const T* __restrict__ v, R2Params p, T* __restrict__ out,
          int H, int W, int hp, int tiles_w, int tiles_hw, int tiles) {
  using G = Geo<C, HEADS, kMma<T>>;
  using L = R2Layout<T, C, HEADS, FOLD>;
  constexpr int HD = G::HD, TH = G::TH, TW = G::TW, HW2 = G::HW2, PH = G::PH, P = G::P;
  constexpr int NV = (C + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* vs = smem + L::v;
  float* x1 = smem + L::x1;
  float* att = smem + L::u;
  float* ys = smem + L::y;
  float* gs = smem + L::g;
  float* inside = smem + L::inside;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n = tile / tiles_hw;
    const int t = tile - n * tiles_hw;
    const int h0 = (t / tiles_w) * TH, w0 = (t % tiles_w) * TW;
    // x and v over the halo (zero outside the image), coalesced
    for (int q = tid; q < PH; q += kThreads) {
      const int gh = h0 - 1 + q / HW2, gw = w0 - 1 + q % HW2;
      inside[q] = gh >= 0 && gh < H && gw >= 0 && gw < W ? 1.f : 0.f;
    }
    for (int e = tid; e < PH * C; e += kThreads) {
      const int q = e / C, c = e - q * C;
      const int gh = h0 - 1 + q / HW2, gw = w0 - 1 + q % HW2;
      float xv = 0.f, vv = 0.f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W) {
        const int64_t i = ((static_cast<int64_t>(n) * H + gh) * W + gw) * C + c;
        xv = to_f32(x[i]);
        vv = to_f32(v[i]);
      }
      x1[q * G::LDA + c] = xv;
      vs[q * G::LDA + c] = vv;
    }
    __syncthreads();

    // per head: out[p, c] = sum_d attn[c, d] v[p, d], rounded; then its
    // part of project_out, added into x1 over the halo
    const float* attn = p.attn + static_cast<int64_t>(n) * C * HD;
    for (int hh = 0; hh < HEADS; ++hh) {
      gemm_t<T>(vs + hh * HD, G::LDA, PH, attn + hh * HD * HD, HD, HD, HD,
                 StoreRounded<T>{att, G::LDH});
      __syncthreads();
      gemm_t<T>(att, G::LDH, PH, p.wp + hh * HD, C, C, HD, AddTo{x1, G::LDA});
      __syncthreads();
    }

    // LayerNorm of x1 over the halo into the operand buffer, a warp a pixel;
    // FOLD zeroes it outside the image (the dw conv's SAME padding, applied
    // before the bias-free 1x1: LN(0) would be the LN's bias)
    for (int q = warp; q < PH; q += kWarps) {
      if (FOLD && inside[q] == 0.f) {
        for (int c = lane; c < C; c += 32) vs[q * G::LDA + c] = 0.f;
        continue;
      }
      float xv[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + 32 * i;
        xv[i] = c < C ? x1[q * G::LDA + c] : 0.f;
      }
      ln_store<T, C, NV>(xv, p.ln_w, p.ln_b, vs + q * G::LDA);
    }
    __syncthreads();

    // the GDFN, 32 hidden channels a pass
    for (int j0 = 0; j0 < hp; j0 += kChunk) {
      if constexpr (FOLD) {
        // the chunk's 64 folded outputs on the tile's own pixels (K = 9C
        // through the implicit im2col of the LN tile), then the gate
        gemm_t<T>(Taps<C, TW>{G::LDA}, vs, P, p.win + static_cast<int64_t>(2 * j0) * 9 * C,
                  9 * C, 2 * kChunk, 9 * C, Store{ys, G::LDY});
        __syncthreads();
        for (int e = tid; e < P * kChunk; e += kThreads) {
          const int m = e / kChunk, j = e - m * kChunk;
          gs[m * G::LDG + j] = round_to<T>(gelu_erf(ys[m * G::LDY + j]) *
                                           ys[m * G::LDY + kChunk + j]);
        }
        __syncthreads();
      } else {
        gemm_t<T>(vs, G::LDA, PH, p.win + static_cast<int64_t>(2 * j0) * C, C, 2 * kChunk, C,
                   StoreMasked{ys, G::LDY, inside});
        __syncthreads();
        // taps and gate: a thread one gate pair of one tile column, its 18
        // taps in registers, walking down the column as in R1
        for (int item = tid; item < kChunk * TW; item += kThreads) {
          const int j = item % kChunk, cc = item / kChunk;
          const float* ta = p.dw + static_cast<int64_t>(2 * j0 + j) * 9;
          const float* tb = ta + kChunk * 9;
          float wa[9], wb[9];
#pragma unroll
          for (int i = 0; i < 9; ++i) {
            wa[i] = __ldg(ta + i);
            wb[i] = __ldg(tb + i);
          }
          float ya[3][3], yb[3][3];  // [halo row % 3][dx]
#pragma unroll
          for (int hr = 0; hr < TH + 2; ++hr) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const float* yp = ys + (hr * HW2 + cc + dx) * G::LDY;
              ya[hr % 3][dx] = yp[j];
              yb[hr % 3][dx] = yp[kChunk + j];
            }
            if (hr < 2) continue;
            const int r = hr - 2;
            float a = 0.f, b = 0.f;
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
#pragma unroll
              for (int dy = 0; dy < 3; ++dy) {
                a = fmaf(ya[(r + dy) % 3][dx], wa[dy * 3 + dx], a);
                b = fmaf(yb[(r + dy) % 3][dx], wb[dy * 3 + dx], b);
              }
            gs[(r * TW + cc) * G::LDG + j] = round_to<T>(gelu_erf(a) * b);
          }
        }
        __syncthreads();
      }
      gemm_t<T>(gs, G::LDG, P, p.wout + j0, hp, C, kChunk, AddInterior<TW>{x1, G::LDA});
      __syncthreads();
    }

    for (int e = tid; e < P * C; e += kThreads) {
      const int px = e / C, c = e - px * C;
      const int r = px / TW, cc = px - r * TW;
      if (h0 + r < H && w0 + cc < W) {
        out[((static_cast<int64_t>(n) * H + h0 + r) * W + w0 + cc) * C + c] =
            from_f32<T>(x1[((r + 1) * HW2 + cc + 1) * G::LDA + c]);
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ launches ---

template <typename F>
cudaError_t resident_blocks(F kernel, size_t smem, int* out) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  *out = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

template <typename F>
cudaError_t set_smem(F kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int C, int HEADS>
int64_t tile_count(int h, int w, int* tiles_w) {
  using G = Geo<C, HEADS, false>;
  *tiles_w = (w + G::TW - 1) / G::TW;
  return static_cast<int64_t>(*tiles_w) * ((h + G::TH - 1) / G::TH);
}

template <typename T, int C, int HEADS, bool FOLD>
struct R1 {
  // blocks of one image and head: enough that all images' fill the card once
  static int splits(int n, int h, int w) {
    const size_t bytes = R1Layout<T, C, HEADS, FOLD>::bytes;
    cudaError_t err = set_smem(r1_kernel<T, C, HEADS, FOLD>, bytes);
    int resident = 0;
    if (err == cudaSuccess) err = resident_blocks(r1_kernel<T, C, HEADS, FOLD>, bytes, &resident);
    if (err != cudaSuccess) return -static_cast<int>(err);
    int tiles_w = 0;
    const int64_t tiles = tile_count<C, HEADS>(h, w, &tiles_w);
    const int64_t per_image = static_cast<int64_t>(n) * HEADS;
    int64_t s = (resident + per_image - 1) / per_image;
    if (s > tiles) s = tiles;
    if (s > 65535) s = 65535;
    return s < 1 ? 1 : static_cast<int>(s);
  }

  static int run(const void* x, const void* const* prm, void* v, float* gram_part,
                 float* ss_part, float* gram, float* qss, float* kss, int n, int h, int w,
                 int splits, cudaStream_t st) {
    const size_t bytes = R1Layout<T, C, HEADS, FOLD>::bytes;
    cudaError_t err = set_smem(r1_kernel<T, C, HEADS, FOLD>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int tiles_w = 0;
    const int64_t tiles = tile_count<C, HEADS>(h, w, &tiles_w);
    if (tiles > INT32_MAX || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const R1Params p{static_cast<const float*>(prm[0]), static_cast<const float*>(prm[1]),
                     static_cast<const float*>(prm[2]),
                     FOLD ? nullptr : static_cast<const float*>(prm[3])};
    r1_kernel<T, C, HEADS, FOLD><<<dim3(splits, HEADS, n), kThreads, bytes, st>>>(
        static_cast<const T*>(x), p, static_cast<T*>(v), gram_part, ss_part, h, w, tiles_w,
        static_cast<int>(tiles));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t total = static_cast<int64_t>(n) * (C * Geo<C, HEADS, false>::HD + 2 * C);
    r1_reduce<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        gram_part, ss_part, gram, qss, kss, n, splits, C, Geo<C, HEADS, false>::HD);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int C, int HEADS, bool FOLD>
struct R2 {
  static int run(const void* x, const void* v, const void* const* prm, void* out, int n,
                 int h, int w, int hp, cudaStream_t st) {
    const size_t bytes = R2Layout<T, C, HEADS, FOLD>::bytes;
    cudaError_t err = set_smem(r2_kernel<T, C, HEADS, FOLD>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (hp <= 0 || hp % kChunk) return static_cast<int>(cudaErrorInvalidValue);
    int tiles_w = 0;
    const int64_t tiles_hw = tile_count<C, HEADS>(h, w, &tiles_w);
    const int64_t tiles = tiles_hw * n;
    if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    int grid = 0;
    err = resident_blocks(r2_kernel<T, C, HEADS, FOLD>, bytes, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    grid = static_cast<int>(tiles < grid ? tiles : grid);
    const auto f = [prm](int i) { return static_cast<const float*>(prm[i]); };
    // FOLD takes no taps: its params are attn, wp, ln_w, ln_b, win, wout
    const R2Params p = FOLD ? R2Params{f(0), f(1), f(2), f(3), f(4), nullptr, f(5)}
                            : R2Params{f(0), f(1), f(2), f(3), f(4), f(5), f(6)};
    r2_kernel<T, C, HEADS, FOLD><<<grid, kThreads, bytes, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(v), p, static_cast<T*>(out), h, w, hp,
        tiles_w, static_cast<int>(tiles_hw), static_cast<int>(tiles));
    return static_cast<int>(cudaGetLastError());
  }
};

// the (C, heads) pairs of Restormer's levels
#define RESTORMER_WIDTHS(X) X(48, 1) X(96, 1) X(96, 2) X(192, 4) X(384, 8)

template <typename T, bool FOLD>
int r1_splits(int c, int heads, int n, int h, int w) {
#define R1_SPLITS(CC, HH) \
  if (c == CC && heads == HH) return R1<T, CC, HH, FOLD>::splits(n, h, w);
  RESTORMER_WIDTHS(R1_SPLITS)
#undef R1_SPLITS
  return -static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool FOLD>
int r1_run(int c, int heads, const void* x, const void* const* prm, void* v, float* gram_part,
           float* ss_part, float* gram, float* qss, float* kss, int n, int h, int w,
           int splits, cudaStream_t st) {
#define R1_RUN(CC, HH)                                                                    \
  if (c == CC && heads == HH)                                                             \
    return R1<T, CC, HH, FOLD>::run(x, prm, v, gram_part, ss_part, gram, qss, kss, n, h, w, \
                                    splits, st);
  RESTORMER_WIDTHS(R1_RUN)
#undef R1_RUN
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool FOLD>
int r2_run(int c, int heads, const void* x, const void* v, const void* const* prm, void* out,
           int n, int h, int w, int hp, cudaStream_t st) {
#define R2_RUN(CC, HH)         \
  if (c == CC && heads == HH) \
    return R2<T, CC, HH, FOLD>::run(x, v, prm, out, n, h, w, hp, st);
  RESTORMER_WIDTHS(R2_RUN)
#undef R2_RUN
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool FOLD>
int r1_splits_any(int dtype, int c, int heads, int n, int h, int w) {
  if (dtype == 0) return r1_splits<float, FOLD>(c, heads, n, h, w);
  if (dtype == 1) return r1_splits<__nv_bfloat16, FOLD>(c, heads, n, h, w);
  return -static_cast<int>(cudaErrorInvalidValue);
}

template <bool FOLD>
int r1_any(const void* x, const void* const* params, void* v, void* gram_part, void* ss_part,
           void* gram, void* qss, void* kss, int dtype, int n, int h, int w, int c, int heads,
           int splits, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* gp = static_cast<float*>(gram_part);
  float* sp = static_cast<float*>(ss_part);
  float* g = static_cast<float*>(gram);
  float* qs = static_cast<float*>(qss);
  float* ks = static_cast<float*>(kss);
  if (dtype == 0)
    return r1_run<float, FOLD>(c, heads, x, params, v, gp, sp, g, qs, ks, n, h, w, splits, st);
  if (dtype == 1)
    return r1_run<__nv_bfloat16, FOLD>(c, heads, x, params, v, gp, sp, g, qs, ks, n, h, w,
                                       splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool FOLD>
int r2_any(const void* x, const void* v, const void* const* params, void* out, int dtype, int n,
           int h, int w, int c, int heads, int hp, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return r2_run<float, FOLD>(c, heads, x, v, params, out, n, h, w, hp, st);
  if (dtype == 1)
    return r2_run<__nv_bfloat16, FOLD>(c, heads, x, v, params, out, n, h, w, hp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and v). How many partials R1 writes
// per image and head at this shape (>= 1), or minus a cudaError_t.
extern "C" int restormer_r1_splits(int dtype, int c, int heads, int n, int h, int w) {
  return r1_splits_any<false>(dtype, c, heads, n, h, w);
}

// the same for R1 with the taps folded in (restormer_r1_mxu)
extern "C" int restormer_r1_mxu_splits(int dtype, int c, int heads, int n, int h, int w) {
  return r1_splits_any<true>(dtype, c, heads, n, h, w);
}

// params (f32): norm1 weight and bias, qkv (3C, C), qkv taps (3C, 9).
// gram_part (n, splits, C, C/heads) and ss_part (n, splits, 2, C) are scratch;
// gram (n, C, C/heads), qss and kss (n, C) the f32 results.
extern "C" int restormer_r1(const void* x, const void* const* params, void* v, void* gram_part,
                            void* ss_part, void* gram, void* qss, void* kss, int dtype, int n,
                            int h, int w, int c, int heads, int splits, void* stream) {
  return r1_any<false>(x, params, v, gram_part, ss_part, gram, qss, kss, dtype, n, h, w, c,
                       heads, splits, stream);
}

// R1 with the taps folded into the qkv 1x1 (replaces _r1_kernel with
// dw_mxu=True). params (f32): norm1 weight and bias, the folded qkv (3C, 9C),
// row o holding W[i, o] k[dh, dx, o] at column (3 dh + dx) C + i. The rest as
// restormer_r1.
extern "C" int restormer_r1_mxu(const void* x, const void* const* params, void* v,
                                void* gram_part, void* ss_part, void* gram, void* qss, void* kss,
                                int dtype, int n, int h, int w, int c, int heads, int splits,
                                void* stream) {
  return r1_any<true>(x, params, v, gram_part, ss_part, gram, qss, kss, dtype, n, h, w, c,
                      heads, splits, stream);
}

// params (f32): attn (n, C, C/heads), project_out (C, C), norm2 weight and
// bias, project_in (2hp, C) and its taps (2hp, 9) chunk-ordered, the GDFN's
// project_out (C, hp); hp a multiple of 32.
extern "C" int restormer_r2(const void* x, const void* v, const void* const* params, void* out,
                            int dtype, int n, int h, int w, int c, int heads, int hp,
                            void* stream) {
  return r2_any<false>(x, v, params, out, dtype, n, h, w, c, heads, hp, stream);
}

// R2 with project_in's taps folded in (replaces _r2_kernel with
// dw_mxu=True). params (f32): attn, project_out, norm2 weight and bias as
// restormer_r2, the folded project_in (2hp, 9C) chunk-ordered, the GDFN's
// project_out (C, hp).
extern "C" int restormer_r2_mxu(const void* x, const void* v, const void* const* params,
                                void* out, int dtype, int n, int h, int w, int c, int heads,
                                int hp, void* stream) {
  return r2_any<true>(x, v, params, out, dtype, n, h, w, c, heads, hp, stream);
}
