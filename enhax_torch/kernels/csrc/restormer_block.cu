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
// wrapper prepares the weights once per parameter version: project_in (2hp,
// C) and its taps with the hidden width h padded to hp, a multiple of 32,
// with zero weights (exact: gelu(0) * 0 = 0) and the rows ordered so that
// each chunk of 32 gate pairs is one block of 64 rows [a_j..., b_j...];
// project_out (C, hp). The bf16 forms take every weight in bf16 and the taps
// in f32; the general forms take them all as f32 copies.
//
// Bound. At the main path's shapes (chunks of 8 tiles of 384x384, bf16) both
// are bound by operations, not bytes: R1 moves 4C bytes a pixel for 6C^2 +
// 2C*hd flops of 1x1 and gram, R2 6C bytes for 2C*hd + 2C^2 + 6C*h flops
// (h = 2.66C); at C=48 that is 15 and 9 times the tensor cores' 295 flops a
// byte. On bf16 the 1x1s and the gram run on the tensor cores (mma.sync
// m16n8k16: bf16 operands, f32 accumulators, so the TPU's rounding holds);
// on float32 they are f32 FMAs (the f32 rate, 67 TFLOP/s, is that path's
// roof). The 1x1s are recomputed over a one-pixel halo. The taps, LayerNorm
// and GELU stay on the FMA units: 54C (R1) and 36h + the GELU (R2) f32 flops
// a pixel, beside 6C^2 + 2C*hd tensor-core flops.
//
// Two forms of each kernel, chosen at compile time by dtype: the bf16
//   forms, r1_bf16_kernel and r2_bf16_kernel, run bf16 at every width of
//   Restormer (R1::kNew, R2::kNew), the default and the tap-folded forms
//   (FOLD, below) alike; the general forms, r1_kernel and r2_kernel, run
//   float32, the tap-folded forms included.
//
// What held the general forms back (bf16, dec0: C = 96, one head, a chunk
// of 8 x 384 x 384; tools/restormer_stage_clocks.py and
// tools/restormer_levels.py on an NVIDIA H100 80GB HBM3 at 700 W):
//   1. R1's grid rounded its splits up: 136 blocks on 132 resident, the 4
//      past them a second wave as long as the first. Choosing the splits so
//      that the grid is one wave (r1_grid in the wrapper: resident //
//      (images x heads)) took R1 from 11.18 to 6.09 ms at dec0 and from
//      2.17 / 2.12 / 1.81 to 1.37 / 1.34 / 1.34 ms at the three smaller
//      levels (enc0's grid was one wave already). Both forms use it.
//   2. Weights streamed from L1/L2 as f32 a K-step at a time, packed to
//      bf16 in registers: the three 1x1s over the halo took 52% of R1's
//      time, project_in 40% of R2's.
//   3. LayerNorm a warp a pixel straight from global memory, each load's
//      latency in its own chain: 26% of R1; R2's load of x and v 16%.
//   4. Operands in shared memory as f32 (131.6 KB for R1): one block of 8
//      warps an SM, nothing to hide latency behind; the taps 14% of R1 and
//      11% of R2, about 10 barriers a tile in R1 and 29 in R2.
//   5. 8 x 8 tiles: the 1x1s over 100 halo pixels for 64 outputs (+56%).
// What the bf16 forms do about each:
//   - the same one-wave grid (1);
//   - a block's weights in shared memory as bf16: R1's head's qkv rows
//     loaded once a block (its head is fixed), R2's attn and project_out a
//     tile at a time and its GDFN weights streamed by cp.async a chunk of 32
//     hidden channels ahead into a ring of two stages; fragments read with
//     ldmatrix (2);
//   - x (R1) and v (R2) by cp.async, the next tile's issued as soon as its
//     buffer is free; LayerNorm from shared memory, two threads a pixel (3);
//   - matmul operands in shared memory as bf16 (exact: they are rounded to
//     bf16 already), 16 warps a block; R2's GDFN project_out summed over the
//     chunks in registers, two barriers a chunk (4);
//   - tiles of 8 x 16 (180 halo pixels for 128: +41%) (5).
// Tiles: 8 x 16 up to C = 96 (R2) and C = 192 (R1); 8 x 8 for R2 at C = 192
// and 4 x 8 for both at C = 384, where the LN tile, x1 and the weights
// would not fit beside each other. x1 is held in f32 on the tile, and on
// its halo ring only until LN2; at C = 384 R2 loads attn and project_out a
// head at a time and its GDFN ring has one stage.
// Times, the chunk of 8 tiles, bf16, general form (with the one-wave grid)
// -> bf16 form in the same call (tools/restormer_levels.py; H100 at 700 W):
//   enc0 (48, 1):       R1 1.80 -> 0.55 ms, R2 3.36 -> 1.15 ms
//   dec0 (96, 1):       R1 6.09 -> 1.24 ms, R2 13.95 -> 2.72 ms
//   enc1/dec1 (96, 2):  R1 1.37 -> 0.38 ms, R2 3.51 -> 0.72 ms
//   enc2/dec2 (192, 4): R1 1.34 -> 0.27 ms, R2 2.67 -> 0.71 ms
//   latent (384, 8):    R1 1.34 -> 0.45 ms, R2 2.77 -> 1.05 ms
// so every width takes the bf16 forms. They are now bound by their taps
// (R1 44%, R2's taps and gate 39% of their time at dec0), then the
// products on mma.sync. A ring of row tiles (the dw 3x3's
// design) was reckoned for R2 and not built: at 2h = 512 f32 channels three
// ring rows of 18 pixels take 110 KB beside x1 and the weights.
//
// Design of the general forms (float32; the bf16 forms took over their bf16
// paths, the tap-folded ones included).
//   A tile is TH x TW output pixels and its one-pixel halo, PH = (TH+2)(TW+2)
//   pixels: 8x8 (PH 100) up to C=192, 4x8 (PH 60) at C=384, where the
//   operands would not fit. A block of 256 threads holds in shared memory,
//   in f32, the tile's matmul operand over the halo (PH x C, odd row stride:
//   no bank conflicts) and streams the weights from global memory (L1/L2
//   resident, the same address across a warp) in chunks of output channels.
//   The products are register-tiled: a thread computes 2 pixels x 8 outputs
//   from float4 weight loads. A 1x1's output over the halo is zeroed at the
//   pixels outside the image after the 1x1 (the dw conv's SAME padding;
//   zeroing x would feed the taps LN(0) @ W); then a thread takes one
//   channel of one tile column, holds its taps in registers and walks down
//   the column with a window of three halo rows (as K1 in nafblock.cu).
//   r1: grid (splits, heads, images). A block takes one head of one image
//     and walks a run of its tiles: LN of the halo; per group (q_h, k_h,
//     v_h) the hd-wide 1x1 and the taps; v_h is stored, q_h and k_h stay in
//     shared memory (P x hd each) for the sums of squares (a thread a
//     channel) and the gram (Gram: a thread a 3x3 or 6x6 block of it).
//     Each tile's
//     sums start from zero and are added to the run's sums, held in
//     registers. At the end of its run a block writes one partial gram
//     and one partial pair of sums to scratch (images, splits, ...); a
//     second kernel sums the partials in split order. No atomics: the result
//     is the same from run to run. The bf16 forms keep this scheme.
//   r2: blocks that stay resident walk over all tiles. Load x -> x1 and v
//     over the halo; per head attn @ v (rounded) and its project_out added
//     into x1 over the halo; LN of x1 over the halo into the operand
//     buffer; per chunk of 32 hidden channels: project_in over the halo
//     (64 outputs), taps and gate on the tile (rounded), project_out of the
//     chunk added into x1 on the tile; store x1 on the tile.
//
// The tap-folded forms (FOLD = true; restormer_r1_mxu, restormer_r2_mxu)
// replace the same two pallas_calls with dw_mxu=True (restormer_block.py:327
// and :378; _dw9_inputs :111, _fold_dw_into_pointwise :131). Each 1x1 -> dw
// 3x3 pair is one product with K = 9C against a weight folded by the wrapper
// (W[i, o] k[dh, dx, o], rounded to T after the fold, as the TPU kernel's
// caller does), on the tile's own P pixels only: no taps stage and no 1x1
// over the halo. The A operand is never built: column tap * C + i of output
// pixel (r, c) is channel i of the LN tile's halo pixel (r + dh, c + dx),
// read in place (the LN is zeroed at every halo pixel outside the image, in
// H and in W, after it is computed: that is the dw conv's SAME padding,
// exact because the 1x1 has no bias; zeroing x would give LN(0) = the LN's
// bias).
//   Bound: operations. R1 does 54 C^2 flops a pixel on the tensor cores
//   (vs 6 C^2 for the 1x1 and 54 C f32 tap flops), R2 36 C h for the folded
//   project_in (vs 4 C h + 36 h); at dec0 that is 0.634 / 1.30 ms against
//   0.198 / 0.531 ms for the default forms. It pays only where the default
//   forms' taps and halo recompute cost more than the 9x tensor-core work.
//   float32 (the general forms): FMA products through the Taps policy, the
//   folded weights as f32 from L2.
//   bf16 (the bf16 forms with FOLD). What held the general form's bf16
//   products back (the general form's bf16 path; restormer_stage_clocks.py):
//   every 16-pixel warp item read its weight rows from L2 as f32 for every
//   k-step (62 KB (R1) and 111 KB (R2) a pixel at dec0, ~5 TB/s: L2's rate)
//   and packed A and B to bf16 in registers. What the bf16 forms do:
//   1. the folded weight is bf16, prepared once a parameter version
//      (r1_mxu_weights: each head's q, k and v rows adjacent; r2_mxu_weights:
//      _chunk_order), and streams by cp.async in K-slices (Fold: a tap; one
//      dh row of three taps at C = 48; half a tap at C = 384) through a ring
//      of 2-5 stages, one commit group and one barrier a slice, the next
//      slices in flight while the warps compute; every warp reads the same
//      stage, so a weight byte leaves L2 once a tile: 3.9 KB (R1) and 6.9 KB
//      (R2) a pixel at dec0;
//   2. A by ldmatrix straight from the bf16 LN tile at each lane's shifted
//      halo pixel (rows of C + 8, stage rows of SLICE + 8: conflict-free);
//   3. a warp item is FMI m-tiles by 3-6 n-tiles of 8: R1 in passes of up to
//      96 of the head's 3HD rows (q_h, k_h, v_h in turn); R2 two chunks of 32
//      gate pairs a step at 8 x 16 tiles (items of 2 m-tiles by 4 n-tiles:
//      each B fragment feeds two m-tiles), one chunk elsewhere, a warp
//      holding a and b of the same gate pairs, so the gate comes from its own
//      accumulators;
//   4. the bf16 gram's accuracy at a one-row image holds: R1's q, k and v
//      are summed in chains of Fold::kChain k-steps, each from zero, added
//      to the f32 sum (v keeps the general form's chains); R1's LayerNorm
//      runs in float64
//      (ln_rows<C, true>); R2 keeps one accumulator;
//   5. tiles 8 x 16 (R1 8 x 8 at C = 384, beside three stages; R2 the
//      default form's tiles), one block of 16 warps an SM, R1 on
//      r1_grid's one wave; R1's next x streams into a buffer of its own where
//      it fits (C <= 96).
//   Times, bf16, a chunk of 8 tiles, the general form -> these forms in one
//   call (tools/restormer_levels.py --mxu; H100 at 700 W; PERF.md §6):
//   R1-mxu 3.52 / 13.39 / 3.32 -> 1.09 / 3.42 / 1.23 ms and R2-mxu 5.96 /
//   29.75 / 9.40 -> 1.52 / 5.03 / 2.87 ms at enc0 / dec0 / latent. 72-94%
//   of each is the folded product (the ring's steps), at 120-230 TFLOP/s:
//   bound by shared-memory reads of the mma.sync fragments (R1's items read
//   341 bytes an mma; its chains double the accumulators, so its items stay
//   one m-tile wide) and the ring's barriers.

// Entry points have a plain C interface for ctypes. They launch on the
// stream they are given, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kLnEps = 1e-5f;
constexpr double kLnEps64 = 1e-5;  // ln_store's in float64
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // R2's hidden channels a pass
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_erf(float a) {
  return 0.5f * a * (1.0f + erff(a * 0.70710678118654752f));
}

// ------------------------------------------------------------- geometry ---

// Row strides (floats) of the general forms' shared tiles. Their products
// read A down its rows (a warp's lanes on neighbouring rows): odd strides,
// no bank conflicts.
template <int C, int HEADS>
struct Geo {
  static constexpr int HD = C / HEADS;
  static constexpr int TH = C >= 384 ? 4 : 8;
  static constexpr int TW = 8;
  static constexpr int HW2 = TW + 2;
  static constexpr int PH = (TH + 2) * HW2;  // halo pixels of a tile
  static constexpr int P = TH * TW;          // output pixels of a tile
  static constexpr int LDA = C + 1;
  static constexpr int LDH = HD + 1;
  static constexpr int LDQ = HD + 1;
  static constexpr int LDY = 2 * kChunk + 1;
  static constexpr int LDG = kChunk + 1;
  static_assert(HD % 16 == 0 && 2 * HD <= kThreads, "head width");
};

template <int C, int HEADS, bool FOLD>
struct R1Layout {
  using G = Geo<C, HEADS>;
  static constexpr int a = 0;                         // LN(x) over the halo
  static constexpr int y = a + G::PH * G::LDA;        // one group's 1x1 output
  static constexpr int q = y + (FOLD ? 0 : G::PH * G::LDH);  // q_h on the tile
  static constexpr int k = q + G::P * G::LDQ;         // k_h on the tile
  static constexpr int inside = k + G::P * G::LDQ;    // halo pixel in the image
  static constexpr int floats = inside + G::PH;
  static constexpr size_t bytes = floats * sizeof(float);
  static_assert(bytes <= kMaxSmem, "R1 shared memory");
};

template <int C, int HEADS, bool FOLD>
struct R2Layout {
  using G = Geo<C, HEADS>;
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
// 4 never crosses a tap (C % 16 == 0).
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

// d += a * b: one m16n8k16 product, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The per-head gram q_h^T k_h of a block's run of tiles, held in
// registers. Each tile's P pixels are summed from zero and then added to
// the run's sum: two short chains of f32 adds, not one of ~9000, whose
// rounding error would grow with the image. qs and ks are P x HD with row
// stride LD. A thread holds an MG x MG block, rows i + 16a, columns j + 16b.
template <int HD, int P, int LD>
struct Gram {
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
template <int TW>
struct StoreImage {
  float* out;
  int ldc;
  TilePixel<TW> px;
  __device__ void operator()(int m, int n, float v) const {
    if (px.inside(m)) out[px.index(m) * ldc + n] = v;
  }
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

// LayerNorm of a C-row (in registers, NV per lane of a warp). F64 (the
// tap-folded R1): every step in float64, rounded once to float32, as the
// bf16 form's ln_rows<C, true> does before its bf16 rounding.
template <int C, int NV, bool F64 = false>
__device__ __forceinline__ void ln_store(float (&v)[NV], const float* __restrict__ lnw,
                                         const float* __restrict__ lnb, float* dst) {
  const int lane = threadIdx.x & 31;
  if constexpr (F64) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < NV; ++i) s += static_cast<double>(v[i]);
    const double mean = warp_sum(s) / C;
    double d2 = 0.0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      const double d = c < C ? v[i] - mean : 0.0;
      d2 += d * d;
    }
    const double rstd = 1.0 / sqrt(warp_sum(d2) / C + kLnEps64);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < C)
        dst[c] = static_cast<float>((v[i] - mean) * rstd * static_cast<double>(__ldg(lnw + c)) +
                                    static_cast<double>(__ldg(lnb + c)));
    }
  } else {
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
      if (c < C) dst[c] = (v[i] - mean) * rstd * __ldg(lnw + c) + __ldg(lnb + c);
    }
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
template <int C, int HEADS, bool FOLD>
__global__ void __launch_bounds__(kThreads, FOLD ? 2 : 1)
r1_kernel(const float* __restrict__ x, R1Params p, float* __restrict__ v,
          float* __restrict__ gram_part, float* __restrict__ ss_part, int H, int W, int tiles_w,
          int tiles) {
  using G = Geo<C, HEADS>;
  using L = R1Layout<C, HEADS, FOLD>;
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
  Gram<HD, P, G::LDQ> gram;
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
      const float* xp = x + ((static_cast<int64_t>(n) * H + gh) * W + gw) * C;
      float xv[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + 32 * i;
        xv[i] = c < C ? to_f32(xp[c]) : 0.f;
      }
      ln_store<C, NV, FOLD>(xv, p.ln_w, p.ln_b, dst);
    }
    __syncthreads();

    if constexpr (FOLD) {
      // q_h, k_h, v_h straight from the LN tile: one product on the tile's
      // own pixels, K = 9C through the implicit im2col, no taps stage and no
      // 1x1 over the halo (the LN is zero outside the image)
      const Taps<C, TW> taps{G::LDA};
      const TilePixel<TW> px{h0, w0, H, W};
      const float* wq = p.wqkv + static_cast<int64_t>(hh * HD) * 9 * C;
      gemm<2, 8>(taps, as, P, wq, 9 * C, HD, 9 * C, StoreTileMasked<TW>{qs, G::LDQ, px});
      gemm<2, 8>(taps, as, P, wq + static_cast<int64_t>(C) * 9 * C, 9 * C, HD, 9 * C,
                 StoreTileMasked<TW>{ks, G::LDQ, px});
      gemm<2, 8>(taps, as, P, wq + static_cast<int64_t>(2 * C) * 9 * C, 9 * C, HD, 9 * C,
                 StoreImage<TW>{v + static_cast<int64_t>(n) * H * W * C + hh * HD, C, px});
      __syncthreads();
    } else {
      for (int grp = 0; grp < 3; ++grp) {  // q_h, k_h, v_h
        const int row0 = grp * C + hh * HD;  // first qkv channel of the group
        gemm<2, 8>(Dense{G::LDA}, as, PH, p.wqkv + static_cast<int64_t>(row0) * C, C, HD, C,
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
              v[((static_cast<int64_t>(n) * H + h0 + r) * W + w0 + cc) * C + hh * HD + j] = acc;
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

template <int C, int HEADS, bool FOLD>
__global__ void __launch_bounds__(kThreads, 1)
r2_kernel(const float* __restrict__ x, const float* __restrict__ v, R2Params p,
          float* __restrict__ out, int H, int W, int hp, int tiles_w, int tiles_hw, int tiles) {
  using G = Geo<C, HEADS>;
  using L = R2Layout<C, HEADS, FOLD>;
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
        xv = x[i];
        vv = v[i];
      }
      x1[q * G::LDA + c] = xv;
      vs[q * G::LDA + c] = vv;
    }
    __syncthreads();

    // per head: out[p, c] = sum_d attn[c, d] v[p, d], rounded; then its
    // part of project_out, added into x1 over the halo
    const float* attn = p.attn + static_cast<int64_t>(n) * C * HD;
    for (int hh = 0; hh < HEADS; ++hh) {
      gemm<2, 8>(Dense{G::LDA}, vs + hh * HD, PH, attn + hh * HD * HD, HD, HD, HD,
                 Store{att, G::LDH});
      __syncthreads();
      gemm<2, 8>(Dense{G::LDH}, att, PH, p.wp + hh * HD, C, C, HD, AddTo{x1, G::LDA});
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
      ln_store<C, NV>(xv, p.ln_w, p.ln_b, vs + q * G::LDA);
    }
    __syncthreads();

    // the GDFN, 32 hidden channels a pass
    for (int j0 = 0; j0 < hp; j0 += kChunk) {
      if constexpr (FOLD) {
        // the chunk's 64 folded outputs on the tile's own pixels (K = 9C
        // through the implicit im2col of the LN tile), then the gate
        gemm<2, 8>(Taps<C, TW>{G::LDA}, vs, P, p.win + static_cast<int64_t>(2 * j0) * 9 * C,
                   9 * C, 2 * kChunk, 9 * C, Store{ys, G::LDY});
        __syncthreads();
        for (int e = tid; e < P * kChunk; e += kThreads) {
          const int m = e / kChunk, j = e - m * kChunk;
          gs[m * G::LDG + j] = gelu_erf(ys[m * G::LDY + j]) * ys[m * G::LDY + kChunk + j];
        }
        __syncthreads();
      } else {
        gemm<2, 8>(Dense{G::LDA}, vs, PH, p.win + static_cast<int64_t>(2 * j0) * C, C,
                   2 * kChunk, C, StoreMasked{ys, G::LDY, inside});
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
            gs[(r * TW + cc) * G::LDG + j] = gelu_erf(a) * b;
          }
        }
        __syncthreads();
      }
      gemm<2, 8>(Dense{G::LDG}, gs, P, p.wout + j0, hp, C, kChunk, AddInterior<TW>{x1, G::LDA});
      __syncthreads();
    }

    for (int e = tid; e < P * C; e += kThreads) {
      const int px = e / C, c = e - px * C;
      const int r = px / TW, cc = px - r * TW;
      if (h0 + r < H && w0 + cc < W) {
        out[((static_cast<int64_t>(n) * H + h0 + r) * W + w0 + cc) * C + c] =
            x1[((r + 1) * HW2 + cc + 1) * G::LDA + c];
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------- bf16 forms ---
//
// R1 and R2 for bf16 at every width: matmul operands and
// weights in shared memory as bf16, fragments read with ldmatrix, 16 warps
// a block, tiles of TH x TW with a one-pixel halo (see the note at the head
// of this file).

using bf16 = __nv_bfloat16;
constexpr int kThreadsB = 512;
constexpr int kWarpsB = kThreadsB / 32;
constexpr int kPart = 48;  // R1: 1x1 outputs a pass; the width of most warp products

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// until at most N of this thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), v);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }
constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }
constexpr size_t cmin(size_t a, size_t b) { return a < b ? a : b; }

// n-tiles of 8 a warp item for a product over mtiles m-tiles and n columns
// (n % 48 == 0): 6 where that leaves 12 items or more for the 16 warps, else 2
__host__ __device__ constexpr int nt_of(int mtiles, int n) {
  return mtiles * (n / 48) >= 12 ? 6 : 2;
}

// acc[j] += A[m0 .. m0 + 15][0 .. K) B[8 j .. 8 j + 7][0 .. K)^T for j < NT
// (even), on a warp: A and B bf16 in shared memory, rows of K values (row
// strides lda, ldb in elements, odd multiples of 8: ldmatrix reads no two
// rows on one bank); A's rows past M - 1 read row M - 1. K % 16 == 0.
template <int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const bf16* A, int lda, int m0,
                                         int M, const bf16* B, int ldb, int K) {
  static_assert(NT % 2 == 0, "n-tiles in pairs");
  const int lane = threadIdx.x & 31;
  int ar = m0 + (lane & 15);
  ar = ar < M ? ar : M - 1;
  const uint32_t a_addr = smem_u32(A + ar * lda + (lane >> 4) * 8);
  const uint32_t b_addr =
      smem_u32(B + ((lane & 7) + ((lane >> 4) << 3)) * ldb + ((lane >> 3) & 1) * 8);
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, a_addr + 2 * k0);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, b_addr + 2 * (j * 8 * ldb + k0));
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(acc[j], a, b0);
      mma_bf16(acc[j + 1], a, b1);
    }
  }
}

// A B^T for M rows and N columns on the block: items of 16 rows x 8 NT
// columns dealt to the warps in turn; epi(m, n, v0, v1) takes columns n and
// n + 1 of row m < M.
template <int NT, typename Epi>
__device__ __forceinline__ void block_mma(const bf16* A, int lda, int M, const bf16* B, int ldb,
                                          int N, int K, const Epi& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mtiles = (M + 15) / 16, items = mtiles * (N / (8 * NT));
  for (int item = warp; item < items; item += kWarpsB) {
    const int mt = item % mtiles, n0 = (item / mtiles) * 8 * NT;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    warp_mma<NT>(acc, A, lda, 16 * mt, M, B + n0 * ldb, ldb, K);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = 16 * mt + g + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) epi(m, n0 + 8 * j + 2 * t4, acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// A tile of TH x TW output pixels and its one-pixel halo, at width C with
// HEADS heads
template <int C, int HEADS, int TH_, int TW_>
struct GeoB {
  static constexpr int HD = C / HEADS;
  static constexpr int TH = TH_, TW = TW_, HW2 = TW + 2;
  static constexpr int PH = (TH + 2) * HW2;  // halo pixels
  static constexpr int P = TH * TW;          // output pixels
  static constexpr int MT = (PH + 15) / 16;  // m-tiles over the halo
  static constexpr int LDA = C + 8;          // bf16 rows of C
  static constexpr int LDQ = HD + 8;         // bf16 rows of HD
  static_assert(HD % kPart == 0 && C % kPart == 0 && P % 16 == 0, "widths");
  // halo pixel m lies in the image
  __device__ static bool inside(int m, int h0, int w0, int H, int W) {
    const int gh = h0 - 1 + m / HW2, gw = w0 - 1 + m % HW2;
    return gh >= 0 && gh < H && gw >= 0 && gw < W;
  }
};

// every row of ln_rows is normalised
struct AllRows {
  __device__ bool operator()(int) const { return true; }
};

// LayerNorm over C of n rows in shared memory, rounded to bf16, two threads a
// row (each half the channels, 8 a step; summed over the halves by one
// shuffle). Row i is read at src(i) (bf16 or f32) and written at dst + i ldd;
// src(i) may be dst's row. The weight and bias are f32 or bf16. Rows where
// keep(i) is false are written as zeros (the FOLD forms: halo pixels outside
// the image, zeroed after the LayerNorm, not before: LN(0) is the bias).
// F64 (R1's FOLD form, whose rounded LN is the operand of its K = 9C
// product): every step in float64, rounded once through float32 to bf16, so
// the operand is the float64 LN's (restormer_block.r1_mxu_witness_gram's)
// and not a float32 order's. One LN operand that rounds the other way moves
// q and k of its pixel and its neighbours in all 2C channels, far more than
// the order of the K-sum does.
template <int C, bool F64 = false, typename Src, typename Prm, typename Keep = AllRows>
__device__ __forceinline__ void ln_rows(const Src& src, bf16* dst, int ldd, int n,
                                        const Prm* lnw, const Prm* lnb,
                                        const Keep& keep = Keep{}) {
  using Acc = std::conditional_t<F64, double, float>;
  constexpr int HALF = C / 2;
  static_assert(HALF % 8 == 0, "LayerNorm halves");
  for (int base = 0; base < 2 * n; base += kThreadsB) {
    const int item = base + threadIdx.x;
    const bool on = item < 2 * n;
    const int row = on ? item >> 1 : 0, c0 = (item & 1) * HALF;
    const auto s = src(row) + c0;
    float v8[8];
    Acc sum = 0;
    for (int c = 0; c < HALF; c += 8) {
      load8(s + c, v8);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += v8[i];
    }
    const Acc mean = (sum + __shfl_xor_sync(0xffffffffu, sum, 1)) / C;
    Acc d2 = 0;
    for (int c = 0; c < HALF; c += 8) {
      load8(s + c, v8);
#pragma unroll
      for (int i = 0; i < 8; ++i) d2 += (v8[i] - mean) * (v8[i] - mean);
    }
    Acc rstd;
    if constexpr (F64) {
      rstd = 1.0 / sqrt((d2 + __shfl_xor_sync(0xffffffffu, d2, 1)) / C + kLnEps64);
    } else {
      rstd = 1.0f / sqrtf((d2 + __shfl_xor_sync(0xffffffffu, d2, 1)) / C + kLnEps);
    }
    if (!on) continue;
    bf16* d = dst + row * ldd + c0;
    const bool kept = keep(row);
    for (int c = 0; c < HALF; c += 8) {
      load8(s + c, v8);
      uint4 o;
      uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cc = c0 + c + 2 * i;
        ow[i] = bf16x2_bits(static_cast<float>((v8[2 * i] - mean) * rstd * to_f32(lnw[cc]) +
                                               to_f32(lnb[cc])),
                            static_cast<float>((v8[2 * i + 1] - mean) * rstd *
                                                   to_f32(lnw[cc + 1]) +
                                               to_f32(lnb[cc + 1])));
      }
      if (!kept) o = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(d + c) = o;
    }
  }
}

// ---- the FOLD forms' folded product ----
//
// The tap-folded 1x1 -> dw 3x3 is one product with K = 9C: A is the implicit
// im2col of the bf16 LN tile in shared memory (row m, column tap * C + i at
// halo pixel (m / TW + dh, m % TW + dx), channel i; tap = 3 dh + dx), B the
// folded weight, streamed through a ring of stages in shared memory a K-slice
// at a time and read by every warp of the block. A warp item is MI m-tiles
// (16 output pixels each) by NT n-tiles of 8 outputs.

// K-slices of SLICE columns: one dh row of taps (3C) at C = 48, a tap, or
// half a tap at C = 384 (a stage of a whole tap would not fit twice)
template <int C>
struct Fold {
  static constexpr int SLICE = C == 48 ? 3 * C : C >= 384 ? C / 2 : C;
  static constexpr int NSL = 9 * C / SLICE;                   // slices of K
  static constexpr int TPS = SLICE >= C ? SLICE / C : 1;      // taps a slice
  static constexpr int KPT = (SLICE >= C ? C : SLICE) / 16;   // k-steps a tap of a slice
  static constexpr int LDW = SLICE + 8;  // bf16 stage rows: an odd count of 16 bytes
  // R1's q and k sum chains of kChain k-steps (a tap or less), each from
  // zero, added to the f32 sum: 3, 3, 4, 4 at C = 48, 96, 192, 384
  static constexpr int kChain = (C / 16) % 4 == 0 ? 4 : 3;
  static_assert(C % 16 == 0 && KPT % kChain == 0, "chains within a tap of a slice");
};

// acc[i][j] += the KS k-steps of m-tile i and n-tile j: A from a[i] + ao
// (this lane's ldmatrix address of its row of m-tile i, advanced 32 bytes a
// k-step), B from b[j / 2] + bo (its address for n-tiles j and j + 1; an odd
// last n-tile by ldmatrix .x2), each B fragment used by all MI m-tiles
template <int MI, int NT, int KS>
__device__ __forceinline__ void mma_steps(float (&acc)[MI][NT][4], const uint32_t (&a)[MI],
                                          uint32_t ao, const uint32_t (&b)[(NT + 1) / 2],
                                          uint32_t bo) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t af[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) ldsm_x4(af[i], a[i] + ao + 32 * ks);
#pragma unroll
    for (int j = 0; j + 1 < NT; j += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b[j / 2] + bo + 32 * ks);
      const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        mma_bf16(acc[i][j], af[i], b0);
        mma_bf16(acc[i][j + 1], af[i], b1);
      }
    }
    if constexpr (NT % 2 == 1) {
      uint32_t bf[2];
      ldsm_x2(bf, b[NT / 2] + bo + 32 * ks);
#pragma unroll
      for (int i = 0; i < MI; ++i) mma_bf16(acc[i][NT - 1], af[i], bf);
    }
  }
}

// acc += K-slice s of a warp item's folded product: a_row[i] is the lane's
// A address at tap (0, 0), channel 0 of its row of the item's m-tile i (the
// halo tile's row stride LDA, HW2 pixels a halo row), stage the shared
// address of the slice's stage. CHAINED (R1): each chain of kChain k-steps
// is summed from zero and then added to acc.
template <int C, int MI, int NT, bool CHAINED, int HW2, int LDA>
__device__ __forceinline__ void fold_slice(float (&acc)[MI][NT][4], const uint32_t (&a_row)[MI],
                                           const uint32_t (&b)[(NT + 1) / 2], uint32_t stage,
                                           int s) {
  using F = Fold<C>;
#pragma unroll
  for (int tp = 0; tp < F::TPS; ++tp) {
    const int k0 = s * F::SLICE + tp * C;  // the first column, within one tap
    const int tap = k0 / C, i0 = k0 - tap * C;
    const uint32_t ao = 2 * (((tap / 3) * HW2 + tap % 3) * LDA + i0);
    const uint32_t bo = stage + 32 * F::KPT * tp;
    if constexpr (CHAINED) {
#pragma unroll
      for (int c = 0; c < F::KPT / F::kChain; ++c) {
        float part[MI][NT][4] = {};
        mma_steps<MI, NT, F::kChain>(part, a_row, ao + 32 * F::kChain * c, b,
                                     bo + 32 * F::kChain * c);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
      }
    } else {
      mma_steps<MI, NT, F::KPT>(acc, a_row, ao, b, bo);
    }
  }
}

// this lane's A addresses for its rows of m-tiles mt0 .. mt0 + MI - 1
// (output pixel 16 mt + lane % 16 of a TW-wide tile) at tap (0, 0) of the
// halo tile ln
template <int MI, int TW, int LDA>
__device__ __forceinline__ void fold_a_rows(uint32_t (&a)[MI], const bf16* ln, int mt0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int m = 16 * (mt0 + i) + (lane & 15);
    a[i] = smem_u32(ln + ((m / TW) * (TW + 2) + m % TW) * LDA + (lane >> 4) * 8);
  }
}

// this lane's B offsets (bytes into a stage of rows of LDW) for a warp
// item's NT n-tiles, n-tile j at stage row row(j)
template <int NT, int LDW, typename Row>
__device__ __forceinline__ void fold_b(uint32_t (&b)[(NT + 1) / 2], const Row& row) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int pr = 0; pr < (NT + 1) / 2; ++pr) {
    const int j = 2 * pr + 1 < NT ? 2 * pr + (lane >> 4) : 2 * pr;
    b[pr] = 2 * ((row(j) + (lane & 7)) * LDW + ((lane >> 3) & 1) * 8);
  }
}

// ---- R1, bf16 form ----

struct R1BParams {
  const bf16* ln_w;
  const bf16* ln_b;
  const bf16* wqkv;  // (3C, C); FOLD: the tap-folded (heads, 3HD, 9C)
  const float* dw;   // (3C, 9); FOLD: unused
};

// R1's tile: 8 x 16, 4 x 8 at C = 384 (the LN tile and the head's weights
// must fit beside each other); FOLD 8 x 8 at C = 384 (no 1x1 output over
// the halo: the LN tile fits beside three stages of the weight ring)
template <int C, int HEADS, bool FOLD = false>
using R1Geo = GeoB<C, HEADS, C >= 384 && !FOLD ? 4 : 8, C >= 384 ? 8 : 16>;

template <int C, int HEADS, bool FOLD = false>
struct R1BLayout {
  using G = R1Geo<C, HEADS, FOLD>;
  static constexpr int LDY = kPart + 8;                                     // f32 rows
  static constexpr int MTP = G::P / 16;                                     // m-tiles of the tile
  static constexpr size_t ln = 0;                                          // bf16 [PH][LDA]
  static constexpr size_t w = ln + align16(G::PH * G::LDA * 2);            // bf16 [3HD][LDA]
  static constexpr size_t q = w + (FOLD ? 0 : align16(3 * G::HD * G::LDA * 2));  // bf16 [P][LDQ]
  static constexpr size_t k = q + align16(G::P * G::LDQ * 2);              // bf16 [P][LDQ]
  // f32 [PH][LDY]; FOLD: a tile's sums of squares by m-tile, f32 [MTP][2HD]
  static constexpr size_t y = k + align16(G::P * G::LDQ * 2);
  static constexpr size_t taps =
      y + align16(FOLD ? MTP * 2 * G::HD * 4 : G::PH * LDY * 4);           // f32 [3HD][9]
  static constexpr size_t lnp = taps + (FOLD ? 0 : align16(3 * G::HD * 9 * 4));  // f32 [2][C]
  // FOLD: the next tile's x over the halo, bf16 [PH][C], where it fits
  // beside three stages; then the ring of the folded weight's K-slices, a
  // stage a pass of up to 96 of the head's 3HD rows
  static constexpr size_t xs = align16(lnp + 2 * C * 4);
  static constexpr size_t stage = align16(96 * Fold<C>::LDW * 2);         // bf16 [96][LDW]
  static constexpr bool XPREF =
      FOLD && xs + align16(G::PH * C * 2) + 3 * stage <= kMaxSmem;
  static constexpr size_t ring = xs + (XPREF ? align16(G::PH * C * 2) : 0);
  static constexpr int IMAGES = (3 * G::HD + 95) / 96 * Fold<C>::NSL;      // stages a tile
  static constexpr int STAGES =
      static_cast<int>(cmin(cmin(8, IMAGES), ring < kMaxSmem ? (kMaxSmem - ring) / stage : 0));
  static constexpr size_t bytes = FOLD ? ring + STAGES * stage : lnp + 2 * C * 4;
  static_assert(bytes <= kMaxSmem, "R1 (bf16 form) shared memory");
  static_assert(FOLD || 2 * G::HD * G::TW <= G::PH * LDY, "sums scratch in y");
  static_assert(!FOLD || STAGES >= 2, "R1 (FOLD) weight ring");
};

// The per-head gram q_h^T k_h of a block's run, on the tensor cores: warp w <
// ITEMS holds one 16 x 8 NT block of it (rows c0.., columns d0..) in
// registers; a tile's P pixels are summed from zero (ldmatrix.trans reads
// q^T and k from their [pixel][channel] rows) and added to the run's sum.
template <int HD, int LDQ>
struct GramB {
  static constexpr int NT = HD >= 96 ? 6 : 2;
  static constexpr int NG = HD / (8 * NT);
  static constexpr int ITEMS = (HD / 16) * NG;
  static_assert(ITEMS <= kWarpsB && HD % (8 * NT) == 0, "gram items");
  float acc[NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }

  __device__ __forceinline__ void add_tile(const bf16* qs, const bf16* ks, int P) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (warp >= ITEMS) return;
    const int c0 = (warp / NG) * 16, d0 = (warp % NG) * 8 * NT;
    const uint32_t a_addr =
        smem_u32(qs + ((lane & 7) + ((lane >> 4) << 3)) * LDQ + c0 + ((lane >> 3) & 1) * 8);
    const uint32_t b_addr =
        smem_u32(ks + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDQ + d0 + ((lane >> 4) << 3));
    float part[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
#pragma unroll 2
    for (int p0 = 0; p0 < P; p0 += 16) {
      uint32_t a[4];
      ldsm_x4_trans(a, a_addr + 2 * p0 * LDQ);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, b_addr + 2 * (p0 * LDQ + 8 * j));
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_bf16(part[j], a, b0);
        mma_bf16(part[j + 1], a, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
  }

  __device__ __forceinline__ void store(float* gp) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (warp >= ITEMS) return;
    const int g = lane >> 2, t = lane & 3;
    const int r = (warp / NG) * 16 + g, d0 = (warp % NG) * 8 * NT;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = d0 + 8 * j + 2 * t;
      gp[r * HD + col] = acc[j][0];
      gp[r * HD + col + 1] = acc[j][1];
      gp[(r + 8) * HD + col] = acc[j][2];
      gp[(r + 8) * HD + col + 1] = acc[j][3];
    }
  }
};

// grid (splits, heads, images) as r1_kernel; 512 threads. Per tile: x over
// the halo by cp.async, its LayerNorm in place (bf16); per pass of 48 of the
// head's q, k, v channels the 1x1 over the halo (f32, zero outside the
// image) and the taps (a thread two channels of one tile column); q and k
// go to shared memory rounded to bf16 and their squares (unrounded) to the
// thread's sums, v to the image; then the tile's gram.
// FOLD: per tile, the LayerNorm in float64 over the halo (zero outside the
// image); per pass of up to 96 of the head's 3HD folded rows (q_h, k_h, v_h
// in turn) the folded product on the tile's own pixels, its K-slices
// streamed through the ring; q and k (zero outside the image) to shared
// memory rounded to bf16 and their squares (unrounded) summed by m-tile, v to
// the image; then the tile's gram and sums. The next tile's x streams into
// its own buffer during the tile where it fits, else into the LN tile
// between tiles.
template <int C, int HEADS, bool FOLD>
__global__ void __launch_bounds__(kThreadsB, 1)
r1_bf16_kernel(const bf16* __restrict__ x, R1BParams p, bf16* __restrict__ v,
               float* __restrict__ gram_part, float* __restrict__ ss_part, int H, int W,
               int tiles_w, int tiles) {
  using G = R1Geo<C, HEADS, FOLD>;
  using L = R1BLayout<C, HEADS, FOLD>;
  constexpr int HD = G::HD, TH = G::TH, TW = G::TW, HW2 = G::HW2, PH = G::PH, P = G::P;
  constexpr int LDA = G::LDA, LDQ = G::LDQ, LDY = L::LDY;
  constexpr int PARTS = HD / kPart;           // passes a group (q, k or v)
  constexpr int TAPS = kPart / 2 * TW;        // taps items a pass
  constexpr int NT = nt_of(G::MT, kPart);     // the 1x1's n-tiles a warp item
  static_assert(TAPS <= kThreadsB, "one taps item a thread");
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* ln = reinterpret_cast<bf16*>(smem_b + L::ln);
  bf16* ws = reinterpret_cast<bf16*>(smem_b + L::w);
  bf16* qs = reinterpret_cast<bf16*>(smem_b + L::q);
  bf16* ks = reinterpret_cast<bf16*>(smem_b + L::k);
  float* ys = reinterpret_cast<float*>(smem_b + L::y);
  float* taps = reinterpret_cast<float*>(smem_b + L::taps);
  float* lnw = reinterpret_cast<float*>(smem_b + L::lnp);
  float* lnb = lnw + C;

  const int tid = threadIdx.x;
  const int split = blockIdx.x, splits = gridDim.x, hh = blockIdx.y, n = blockIdx.z;
  const int t0 = static_cast<int>(static_cast<int64_t>(split) * tiles / splits);
  const int t1 = static_cast<int>(static_cast<int64_t>(split + 1) * tiles / splits);

  if constexpr (!FOLD) {
    // once: the head's q, k and v rows of the qkv weight and their taps, and
    // norm1's weight and bias; row r of ws is channel r % HD of group r / HD
    for (int e = tid; e < 3 * HD * (C / 8); e += kThreadsB) {
      const int r = e / (C / 8), ch = e - r * (C / 8);
      const int row = (r / HD) * C + hh * HD + r % HD;
      cp_async16(ws + r * LDA + ch * 8, p.wqkv + static_cast<int64_t>(row) * C + ch * 8, true);
    }
    cp_async_commit();
    for (int e = tid; e < 3 * HD * 9; e += kThreadsB) {
      const int r = e / 9;
      taps[e] = p.dw[((r / HD) * C + hh * HD + r % HD) * 9 + e - r * 9];
    }
  }
  for (int c = tid; c < C; c += kThreadsB) {
    lnw[c] = to_f32(p.ln_w[c]);
    lnb[c] = to_f32(p.ln_b[c]);
  }
  GramB<HD, LDQ> gram;
  gram.zero();

  // tile t's x over the halo into dst, rows of ldd (zero outside the image);
  // the caller commits
  const auto load_x = [&](int t, bf16* dst, int ldd) {
    const int h0 = (t / tiles_w) * TH, w0 = (t % tiles_w) * TW;
    for (int e = tid; e < PH * (C / 8); e += kThreadsB) {
      const int m = e / (C / 8), ch = e - m * (C / 8);
      const int gh = h0 - 1 + m / HW2, gw = w0 - 1 + m % HW2;
      const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W;
      const bf16* src = in ? x + ((static_cast<int64_t>(n) * H + gh) * W + gw) * C + ch * 8 : x;
      cp_async16(dst + m * ldd + ch * 8, src, in);
    }
  };

  if constexpr (!FOLD) {
    // the taps item of this thread: channels 2 jp, 2 jp + 1 of a pass, column cc
    const int jp = tid % (kPart / 2), cc = tid / (kPart / 2);
    float ss[2 * PARTS][2];  // its sums of squares: q parts, then k parts
#pragma unroll
    for (int i = 0; i < 2 * PARTS; ++i) ss[i][0] = ss[i][1] = 0.f;

    if (t0 < t1) {
      load_x(t0, ln, LDA);
      cp_async_commit();
    }

    for (int t = t0; t < t1; ++t) {
      const int h0 = (t / tiles_w) * TH, w0 = (t % tiles_w) * TW;
      cp_async_wait_all();
      __syncthreads();
      ln_rows<C>([ln](int i) { return ln + i * LDA; }, ln, LDA, PH, lnw, lnb);
      __syncthreads();

#pragma unroll 1
      for (int part = 0; part < 3 * PARTS; ++part) {
        const int grp = part / PARTS, c0 = (part % PARTS) * kPart;  // group, first channel
        // the 1x1 over the halo, zero outside the image
        block_mma<NT>(ln, LDA, PH, ws + (grp * HD + c0) * LDA, LDA, kPart, C,
                      [&](int m, int col, float a, float b) {
                        const bool in = G::inside(m, h0, w0, H, W);
                        *reinterpret_cast<float2*>(ys + m * LDY + col) =
                            in ? make_float2(a, b) : make_float2(0.f, 0.f);
                      });
        __syncthreads();
        // the last pass has read ln: the next tile's x streams in meanwhile
        if (part == 3 * PARTS - 1 && t + 1 < t1) {
          load_x(t + 1, ln, LDA);
          cp_async_commit();
        }
        // the taps: two channels of one tile column, walking down it with a
        // window of three halo rows
        if (tid < TAPS) {
          const float* tp = taps + (grp * HD + c0 + 2 * jp) * 9;
          float wa[9], wb[9];
#pragma unroll
          for (int i = 0; i < 9; ++i) {
            wa[i] = tp[i];
            wb[i] = tp[9 + i];
          }
          float2 win[3][3];  // [halo row % 3][dx]
          float sa = 0.f, sb = 0.f;
#pragma unroll
          for (int hr = 0; hr < TH + 2; ++hr) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
              win[hr % 3][dx] =
                  *reinterpret_cast<const float2*>(ys + (hr * HW2 + cc + dx) * LDY + 2 * jp);
            if (hr < 2) continue;
            const int r = hr - 2;
            float a = 0.f, b = 0.f;
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
#pragma unroll
              for (int dy = 0; dy < 3; ++dy) {
                a = fmaf(win[(r + dy) % 3][dx].x, wa[dy * 3 + dx], a);
                b = fmaf(win[(r + dy) % 3][dx].y, wb[dy * 3 + dx], b);
              }
            const bool valid = h0 + r < H && w0 + cc < W;
            if (grp < 2) {
              a = valid ? a : 0.f;
              b = valid ? b : 0.f;
              sa = fmaf(a, a, sa);
              sb = fmaf(b, b, sb);
              *reinterpret_cast<uint32_t*>((grp == 0 ? qs : ks) + (r * TW + cc) * LDQ + c0 +
                                           2 * jp) = bf16x2_bits(a, b);
            } else if (valid) {
              *reinterpret_cast<uint32_t*>(
                  v + ((static_cast<int64_t>(n) * H + h0 + r) * W + w0 + cc) * C + hh * HD + c0 +
                  2 * jp) = bf16x2_bits(a, b);
            }
          }
          if (grp < 2) {
#pragma unroll
            for (int i = 0; i < 2 * PARTS; ++i)
              if (i == part) {
                ss[i][0] += sa;
                ss[i][1] += sb;
              }
          }
        }
        __syncthreads();
      }
      // the tile's gram; the next tile's first writes to qs and ks come after
      // two more barriers
      gram.add_tile(qs, ks, P);
    }
    cp_async_wait_all();  // a block with no tiles has not waited for its weights

    // this block's partials: gram_part (images, splits, C, HD), ss_part
    // (images, splits, 2, C); the sums of squares summed over the tile
    // columns in order, through ys
    const int64_t base = static_cast<int64_t>(n) * splits + split;
    gram.store(gram_part + (base * C + hh * HD) * HD);
    if (tid < TAPS) {
#pragma unroll
      for (int i = 0; i < 2 * PARTS; ++i) {
        const int ch = (i / PARTS) * HD + (i % PARTS) * kPart + 2 * jp;  // q channels, then k
        ys[ch * TW + cc] = ss[i][0];
        ys[(ch + 1) * TW + cc] = ss[i][1];
      }
    }
    __syncthreads();
    for (int i = tid; i < 2 * HD; i += kThreadsB) {
      float s = 0.f;
      for (int c = 0; c < TW; ++c) s += ys[i * TW + c];
      ss_part[base * 2 * C + (i / HD) * C + hh * HD + i % HD] = s;
    }
  } else {
    using F = Fold<C>;
    constexpr int MTP = L::MTP, STAGES = L::STAGES, IMAGES = L::IMAGES;
    constexpr int PASSES = (3 * HD + 95) / 96;
    // a warp item: one m-tile by NT96 n-tiles of a pass of 96 rows (16
    // items), by NT48 of v's 48 rows at HD = 48
    constexpr int NT96 = MTP >= 8 ? 6 : 3, NT48 = 3;
    const int lane = tid & 31, warp = tid >> 5;
    bf16* ring = reinterpret_cast<bf16*>(smem_b + L::ring);
    bf16* xs = L::XPREF ? reinterpret_cast<bf16*>(smem_b + L::xs) : ln;
    float* ssc = ys;  // the tile's sums of squares by m-tile, [MTP][2HD]
    const bf16* wh = p.wqkv + static_cast<int64_t>(hh) * 3 * HD * 9 * C;  // the head's rows
    const int images = (t1 - t0) * IMAGES;  // the run's stream: every tile's IMAGES slices
    const auto stage_of = [&](int g) {
      return ring + (g % STAGES) * static_cast<int>(L::stage / 2);
    };
    // image g of the stream: slice s of pass `pass`, its rows x SLICE columns
    const auto load_image = [&](int g) {
      if (g >= images) return;
      const int i = g % IMAGES, pass = i / F::NSL, s = i - pass * F::NSL;
      const int rows = min(96, 3 * HD - 96 * pass);
      bf16* st = stage_of(g);
      const bf16* src = wh + static_cast<int64_t>(96 * pass) * 9 * C + s * F::SLICE;
      for (int e = tid; e < rows * (F::SLICE / 8); e += kThreadsB) {
        const int r = e / (F::SLICE / 8), ch = e - r * (F::SLICE / 8);
        cp_async16(st + r * F::LDW + ch * 8, src + static_cast<int64_t>(r) * 9 * C + ch * 8,
                   true);
      }
    };
    float ss = 0.f;  // tid < 2HD: the run's sum of squares of q (then k) channel tid % HD
    int g = 0, t = t0;
    if (t0 < t1) {
      load_x(t0, xs, L::XPREF ? C : LDA);
      cp_async_commit();
      for (int i = 0; i < STAGES - 1; ++i) {
        load_image(i);
        cp_async_commit();
      }
    }
    // one step of the stream, before image g is read: it has landed, and
    // every warp is past image g - 1, whose stage takes image g + STAGES - 1
    // (one commit group a step); the first step of a tile also sends the
    // next tile's x on its way
    const auto step = [&](bool first) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (L::XPREF && first && t + 1 < t1) load_x(t + 1, xs, C);
      load_image(g + STAGES - 1);
      cp_async_commit();
    };
    // pass `pass` of tile (h0, w0): rows 96 pass .. of the head's 3HD
    const auto run_pass = [&](auto nt, int pass, int h0, int w0) {
      constexpr int NTI = decltype(nt)::value;
      const int np = min(96, 3 * HD - 96 * pass);
      const bool active = warp < MTP * (np / (8 * NTI));
      const int mt = warp % MTP, n0 = (warp / MTP) * 8 * NTI;
      uint32_t a_row[1], b[(NTI + 1) / 2];
      fold_a_rows<1, TW, LDA>(a_row, ln, mt);
      fold_b<NTI, F::LDW>(b, [n0](int j) { return n0 + 8 * j; });
      float accs[1][NTI][4] = {};
      float (&acc)[NTI][4] = accs[0];
      for (int s = 0; s < F::NSL; ++s, ++g) {
        step(pass == 0 && s == 0);
        if (active)
          fold_slice<C, 1, NTI, true, HW2, LDA>(accs, a_row, b, smem_u32(stage_of(g)), s);
      }
      if (!active) return;
      const int gq = lane >> 2, t4 = lane & 3;
      const int row0 = 96 * pass + n0;  // the item's first row: group and channel
      const int grp = row0 / HD, ch0 = row0 - grp * HD;
      if (grp < 2) {
        // q or k, zero outside the image: rounded to shared memory, squared
        // unrounded, summed over the m-tile's 16 pixels (8 lanes a column)
        bf16* dst = grp == 0 ? qs : ks;
        float sq[NTI][2] = {};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = 16 * mt + gq + 8 * half;
          const bool in = h0 + m / TW < H && w0 + m % TW < W;
#pragma unroll
          for (int j = 0; j < NTI; ++j) {
            const float a0 = in ? acc[j][2 * half] : 0.f, a1 = in ? acc[j][2 * half + 1] : 0.f;
            sq[j][0] = fmaf(a0, a0, sq[j][0]);
            sq[j][1] = fmaf(a1, a1, sq[j][1]);
            *reinterpret_cast<uint32_t*>(dst + m * LDQ + ch0 + 8 * j + 2 * t4) =
                bf16x2_bits(a0, a1);
          }
        }
#pragma unroll
        for (int j = 0; j < NTI; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float q = sq[j][e];
            q += __shfl_xor_sync(0xffffffffu, q, 4);
            q += __shfl_xor_sync(0xffffffffu, q, 8);
            q += __shfl_xor_sync(0xffffffffu, q, 16);
            if (gq == 0) ssc[mt * 2 * HD + grp * HD + ch0 + 8 * j + 2 * t4 + e] = q;
          }
      } else {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = 16 * mt + gq + 8 * half;
          const int r = m / TW, cc = m % TW;
          if (h0 + r >= H || w0 + cc >= W) continue;
          bf16* vp = v + ((static_cast<int64_t>(n) * H + h0 + r) * W + w0 + cc) * C + hh * HD +
                     ch0 + 2 * t4;
#pragma unroll
          for (int j = 0; j < NTI; ++j)
            *reinterpret_cast<uint32_t*>(vp + 8 * j) =
                bf16x2_bits(acc[j][2 * half], acc[j][2 * half + 1]);
        }
      }
    };

    for (; t < t1; ++t) {
      const int h0 = (t / tiles_w) * TH, w0 = (t % tiles_w) * TW;
      if (t == t0) {
        cp_async_wait<STAGES - 1>();  // the first tile's x; the stages may be in flight
      } else if constexpr (!L::XPREF) {
        // every warp is past the last tile's product (the barrier before
        // its gram): its x goes into the LN tile
        load_x(t, ln, LDA);
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
      const auto keep = [&](int m) { return G::inside(m, h0, w0, H, W); };
      if constexpr (L::XPREF) {
        ln_rows<C, true>([xs](int i) { return xs + i * C; }, ln, LDA, PH, lnw, lnb, keep);
      } else {
        ln_rows<C, true>([ln](int i) { return ln + i * LDA; }, ln, LDA, PH, lnw, lnb, keep);
      }
      // (the first step's barrier puts the LayerNorm before the product)
      for (int pass = 0; pass < PASSES; ++pass) {
        if (96 * pass + 96 <= 3 * HD) {
          run_pass(std::integral_constant<int, NT96>{}, pass, h0, w0);
        } else {
          run_pass(std::integral_constant<int, NT48>{}, pass, h0, w0);
        }
      }
      __syncthreads();  // the tile's q, k and sums by m-tile are complete
      gram.add_tile(qs, ks, P);
      if (tid < 2 * HD) {
        float sum = 0.f;
        for (int m = 0; m < MTP; ++m) sum += ssc[m * 2 * HD + tid];
        ss += sum;
      }
    }
    cp_async_wait_all();
    // this block's partials, as the default form's
    const int64_t base = static_cast<int64_t>(n) * splits + split;
    gram.store(gram_part + (base * C + hh * HD) * HD);
    if (tid < 2 * HD) ss_part[base * 2 * C + (tid / HD) * C + hh * HD + tid % HD] = ss;
  }
}

// ---- R2, bf16 form ----

struct R2BParams {
  const bf16* attn;  // (B, C, HD)
  const bf16* wp;    // (C, C)
  const bf16* ln_w;
  const bf16* ln_b;
  const bf16* win;   // (2hp, C), chunk-ordered; FOLD: the tap-folded (2hp, 9C)
  const float* dw;   // (2hp, 9), chunk-ordered; FOLD: unused
  const bf16* wout;  // (C, hp)
};

// R2's tile: 8 x 16; 8 x 8 at C = 192 and 4 x 8 at C = 384, where x1 and
// the weights must fit
template <int C, int HEADS>
using R2Geo = GeoB<C, HEADS, C >= 384 ? 4 : 8, C >= 192 ? 8 : 16>;

template <int C, int HEADS, bool FOLD = false>
struct R2BLayout {
  using G = R2Geo<C, HEADS>;
  // FOLD: the chunks of 32 gate pairs a step of the GDFN, two where the
  // tile has 8 m-tiles (warp items of 2 m-tiles by 4 n-tiles)
  static constexpr int CPS = FOLD && G::P >= 128 ? 2 : 1;
  static constexpr int LDX = C + 8;           // f32 x1 rows
  static constexpr int LDY = 2 * kChunk + 8;  // f32 project_in rows (64 outputs)
  // bf16 gate rows, and a step's project_out rows
  static constexpr int LDG = CPS * kChunk + 8;
  // a weight stage of the GDFN: a chunk's project_in rows, project_out
  // columns and taps
  static constexpr size_t s_win = 0;                                   // bf16 [64][LDA]
  static constexpr size_t s_wout = s_win + 2 * kChunk * G::LDA * 2;     // bf16 [C][LDG]
  static constexpr size_t s_taps = s_wout + C * LDG * 2;                // f32 [64][9]
  static constexpr size_t stage = align16(s_taps + 2 * kChunk * 9 * 4);
  // x1 (f32) on the tile's own pixels; the halo ring's x1 lives beside the
  // attention output until LN2 has read it
  static constexpr size_t x1 = 0;                                       // f32 [P][LDX]
  static constexpr size_t a = x1 + align16(G::P * LDX * 4);             // bf16 [PH][LDA]: v, LN2
  static constexpr size_t u = a + align16(G::PH * G::LDA * 2);
  static constexpr size_t att = u;                                      // bf16 [PH][LDQ]
  static constexpr size_t x1r = att + align16(G::PH * G::LDQ * 2);      // f32 [PH - P][LDX]
  static constexpr size_t y = u;                                        // f32 [PH][LDY]
  // bf16 [P][LDG] (FOLD has no project_in output over the halo)
  static constexpr size_t gate = FOLD ? u : y + align16(G::PH * LDY * 4);
  static constexpr size_t wt = cmax(gate + align16(G::P * LDG * 2),
                                    x1r + align16((G::PH - G::P) * LDX * 4));
  // the weight region: attn [C][LDQ] and project_out [C][LDA] of all heads
  // where they fit, else one head's attn [HD][LDQ] and project_out columns
  // [C][LDQ] at a time; then the GDFN's stages, two (a ring, one chunk
  // ahead) where they fit
  static constexpr size_t room = kMaxSmem - wt;
  static constexpr size_t heads_all = align16(C * G::LDQ * 2) + align16(C * G::LDA * 2);
  static constexpr bool ALL_HEADS = heads_all <= room;
  static constexpr int STAGES = 2 * stage <= room ? 2 : 1;
  static constexpr size_t attn = wt;
  static constexpr size_t wp = attn + align16((ALL_HEADS ? C : G::HD) * G::LDQ * 2);
  // FOLD's GDFN region: a step's project_out columns, then the ring of the
  // folded project_in's K-slices, a stage the step's CPS x 64 rows; at most
  // one step's slices deep, so that the project_out columns sent with its
  // first slice have landed by its last
  static constexpr size_t wo = wt;                                      // bf16 [C][LDG]
  static constexpr size_t ring = wo + align16(C * LDG * 2);
  static constexpr size_t fstage = align16(CPS * 2 * kChunk * Fold<C>::LDW * 2);
  static constexpr int FSTAGES = static_cast<int>(
      cmin(cmin(8, Fold<C>::NSL), ring < kMaxSmem ? (kMaxSmem - ring) / fstage : 0));
  static constexpr size_t bytes =
      cmax(wp + align16(C * (ALL_HEADS ? G::LDA : G::LDQ) * 2),
           FOLD ? ring + FSTAGES * fstage : wt + STAGES * stage);
  static_assert(bytes <= kMaxSmem, "R2 (bf16 form) shared memory");
  static_assert(!FOLD || FSTAGES >= 2, "R2 (FOLD) weight ring");

  // x1 of halo pixel m: a tile pixel's in x1 (its row in the tile), a ring
  // pixel's in x1r (the ring's pixels in halo order)
  __device__ static float* x1_row(float* x1s, float* x1rs, int m) {
    const int r = m / G::HW2, c = m % G::HW2;
    if (r >= 1 && r <= G::TH && c >= 1 && c <= G::TW)
      return x1s + ((r - 1) * G::TW + c - 1) * LDX;
    const int before = r < 1 ? 0 : r > G::TH ? G::P : (r - 1) * G::TW + (c < 1 ? 0 : G::TW);
    return x1rs + (m - before) * LDX;
  }
};

// persistent blocks of 512 threads walk the tiles. Per tile: v over the
// halo (and attn and project_out where all heads' fit) by cp.async, x into
// x1 (f32); per head (its weights by cp.async where they come a head at a
// time) attn @ v (rounded) and its project_out added into x1 over the halo;
// LN2 of x1 into the operand buffer; per chunk of 32 hidden channels (its
// weights by cp.async, one chunk ahead where the ring has two stages):
// project_in over the halo (f32, zero outside the image), taps and gate on
// the tile (bf16), project_out summed over the chunks in registers (warp w:
// 16 tile pixels x 48 outputs); out = x1 + that sum on the tile.
// FOLD: LN2 is zero outside the image; per chunk the folded project_in on
// the tile's own pixels, its K-slices streamed through the ring (one
// accumulator), the gate from the warp's own a and b fragments.
template <int C, int HEADS, bool FOLD>
__global__ void __launch_bounds__(kThreadsB, 1)
r2_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ v, R2BParams p,
               bf16* __restrict__ out, int H, int W, int hp, int tiles_w, int tiles_hw,
               int tiles) {
  using G = R2Geo<C, HEADS>;
  using L = R2BLayout<C, HEADS, FOLD>;
  constexpr int HD = G::HD, TH = G::TH, TW = G::TW, HW2 = G::HW2, PH = G::PH, P = G::P;
  constexpr int LDA = G::LDA, LDQ = G::LDQ, LDX = L::LDX, LDY = L::LDY, LDG = L::LDG;
  constexpr int OUT_ITEMS = (P / 16) * (C / kPart);  // project_out: warps holding a block
  constexpr int GATES = kChunk * TW;                 // taps and gate items a chunk
  constexpr int NX = (PH * (C / 8) + kThreadsB - 1) / kThreadsB;
  constexpr int NT_IN = G::MT >= 12 ? 8 : G::MT >= 7 ? 4 : 2;  // project_in's n-tiles an item
  constexpr int LDW = L::ALL_HEADS ? LDA : LDQ;      // project_out's rows in shared memory
  static_assert(OUT_ITEMS <= kWarpsB && GATES <= kThreadsB, "R2 work split");
  extern __shared__ __align__(16) unsigned char smem_b[];
  float* x1 = reinterpret_cast<float*>(smem_b + L::x1);
  float* x1r = reinterpret_cast<float*>(smem_b + L::x1r);
  bf16* as = reinterpret_cast<bf16*>(smem_b + L::a);
  bf16* att = reinterpret_cast<bf16*>(smem_b + L::att);
  float* ys = reinterpret_cast<float*>(smem_b + L::y);
  bf16* gs = reinterpret_cast<bf16*>(smem_b + L::gate);
  bf16* attn_s = reinterpret_cast<bf16*>(smem_b + L::attn);
  bf16* wp_s = reinterpret_cast<bf16*>(smem_b + L::wp);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int chunks = hp / kChunk;

  // heads first .. first + nh - 1 of image n's attn and their columns of
  // project_out
  const auto load_heads = [&](int n, int first, int nh) {
    for (int e = tid; e < nh * HD * (HD / 8); e += kThreadsB) {
      const int r = e / (HD / 8), ch = e - r * (HD / 8);
      cp_async16(attn_s + r * LDQ + ch * 8,
                 p.attn + (static_cast<int64_t>(n) * C + first * HD + r) * HD + ch * 8, true);
    }
    for (int e = tid; e < C * (nh * HD / 8); e += kThreadsB) {
      const int r = e / (nh * HD / 8), ch = e - r * (nh * HD / 8);
      cp_async16(wp_s + r * LDW + ch * 8,
                 p.wp + static_cast<int64_t>(r) * C + first * HD + ch * 8, true);
    }
  };
  // chunk j's weights into its stage
  const auto stage_of = [&](int j) { return smem_b + L::wt + (j % L::STAGES) * L::stage; };
  const auto load_chunk = [&](int j) {
    unsigned char* st = stage_of(j);
    bf16* wi = reinterpret_cast<bf16*>(st + L::s_win);
    bf16* wo = reinterpret_cast<bf16*>(st + L::s_wout);
    float* tp = reinterpret_cast<float*>(st + L::s_taps);
    for (int e = tid; e < 2 * kChunk * (C / 8); e += kThreadsB) {
      const int r = e / (C / 8), ch = e - r * (C / 8);
      cp_async16(wi + r * LDA + ch * 8,
                 p.win + (static_cast<int64_t>(2 * kChunk) * j + r) * C + ch * 8, true);
    }
    for (int e = tid; e < C * (kChunk / 8); e += kThreadsB) {
      const int r = e / (kChunk / 8), ch = e - r * (kChunk / 8);
      cp_async16(wo + r * LDG + ch * 8,
                 p.wout + static_cast<int64_t>(r) * hp + kChunk * j + ch * 8, true);
    }
    for (int e = tid; e < 2 * kChunk * 9 / 4; e += kThreadsB)
      cp_async16(tp + 4 * e, p.dw + static_cast<int64_t>(2 * kChunk * 9) * j + 4 * e, true);
    cp_async_commit();
  };
  // project_in of chunk j over the halo, zero outside the image
  const auto project_in = [&](int j, int h0, int w0) {
    block_mma<NT_IN>(as, LDA, PH, reinterpret_cast<const bf16*>(stage_of(j) + L::s_win), LDA,
                     2 * kChunk, C, [&](int m, int col, float a, float b) {
                       const bool in = G::inside(m, h0, w0, H, W);
                       *reinterpret_cast<float2*>(ys + m * LDY + col) =
                           in ? make_float2(a, b) : make_float2(0.f, 0.f);
                     });
  };
  const int om = (warp % (P / 16)) * 16, on = (warp / (P / 16)) * kPart;  // project_out block

  // FOLD: a step of the GDFN takes CPS chunks of 32 gate pairs; a warp item
  // of the folded project_in is FMI m-tiles of one chunk by FNT n-tiles,
  // half of them a columns and half the b columns of the same gate pairs
  using F = Fold<C>;
  constexpr int MTP = P / 16, CPS = L::CPS;
  constexpr int FMI = CPS, FNT = CPS == 2 ? 4 : 2;
  constexpr int MG = MTP / FMI;                  // m-groups of a chunk
  constexpr int IPC = MG * (8 / FNT);            // warp items a chunk
  constexpr int FITEMS = CPS * IPC;              // 16, or 8 at the 4 x 8 tile
  constexpr int FSTAGES = L::FSTAGES;
  static_assert(!FOLD || FITEMS <= kWarpsB, "R2 (FOLD) warp items");
  bf16* wof = reinterpret_cast<bf16*>(smem_b + L::wo);
  bf16* fring = reinterpret_cast<bf16*>(smem_b + L::ring);
  const auto fstage_of = [&](int i) {
    return fring + (i % FSTAGES) * static_cast<int>(L::fstage / 2);
  };
  // image i of a tile's stream: slice i % NSL of step i / NSL, its CPS x 64
  // rows (chunks in _chunk_order are adjacent)
  const auto load_image = [&](int i) {
    const int j = i / F::NSL, s = i - j * F::NSL;
    bf16* st = fstage_of(i);
    const bf16* src = p.win + static_cast<int64_t>(CPS * 2 * kChunk * j) * 9 * C + s * F::SLICE;
    for (int e = tid; e < CPS * 2 * kChunk * (F::SLICE / 8); e += kThreadsB) {
      const int r = e / (F::SLICE / 8), ch = e - r * (F::SLICE / 8);
      cp_async16(st + r * F::LDW + ch * 8, src + static_cast<int64_t>(r) * 9 * C + ch * 8, true);
    }
  };
  // step j's project_out columns
  const auto load_wo = [&](int j) {
    for (int e = tid; e < C * (CPS * kChunk / 8); e += kThreadsB) {
      const int r = e / (CPS * kChunk / 8), ch = e - r * (CPS * kChunk / 8);
      cp_async16(wof + r * LDG + ch * 8,
                 p.wout + static_cast<int64_t>(r) * hp + CPS * kChunk * j + ch * 8, true);
    }
  };
  // this warp's item: chunk fc of the step, m-tiles fm.., gate pairs fq
  const int fc = warp / IPC, fm = (warp % IPC) % MG * FMI, fq = (warp % IPC) / MG;
  uint32_t a_rows[FMI], b_off[FNT / 2];
  fold_a_rows<FMI, TW, LDA>(a_rows, as, fm);
  fold_b<FNT, F::LDW>(b_off, [&](int j) {
    return 2 * kChunk * fc + (j < FNT / 2 ? 0 : kChunk) + 8 * (FNT / 2) * fq + 8 * (j % (FNT / 2));
  });

  // v of tile `tile` over the halo into as (zero outside the image)
  const auto load_v = [&](int tile) {
    const int n = tile / tiles_hw;
    const int t = tile - n * tiles_hw;
    const int h0 = (t / tiles_w) * TH, w0 = (t % tiles_w) * TW;
    for (int e = tid; e < PH * (C / 8); e += kThreadsB) {
      const int m = e / (C / 8), ch = e - m * (C / 8);
      const int gh = h0 - 1 + m / HW2, gw = w0 - 1 + m % HW2;
      const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W;
      const bf16* src = in ? v + ((static_cast<int64_t>(n) * H + gh) * W + gw) * C + ch * 8 : v;
      cp_async16(as + m * LDA + ch * 8, src, in);
    }
    cp_async_commit();
  };
  if (blockIdx.x < tiles) load_v(blockIdx.x);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n = tile / tiles_hw;
    const int t = tile - n * tiles_hw;
    const int h0 = (t / tiles_w) * TH, w0 = (t % tiles_w) * TW;
    // v came during the last tile; all heads' weights where they fit
    if (L::ALL_HEADS) {
      load_heads(n, 0, HEADS);
      cp_async_commit();
    }
    // x over the halo into x1, f32 (zero outside the image): all loads first
    uint4 xr[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int e = tid + i * kThreadsB;
      const int m = e / (C / 8), ch = e - m * (C / 8);
      const int gh = h0 - 1 + m / HW2, gw = w0 - 1 + m % HW2;
      const bool in = e < PH * (C / 8) && gh >= 0 && gh < H && gw >= 0 && gw < W;
      xr[i] = in ? *reinterpret_cast<const uint4*>(
                       x + ((static_cast<int64_t>(n) * H + gh) * W + gw) * C + ch * 8)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int e = tid + i * kThreadsB;
      if (e >= PH * (C / 8)) continue;
      const int m = e / (C / 8), ch = e - m * (C / 8);
      float f[8];
      unpack8(xr[i], f);
      float* dst = L::x1_row(x1, x1r, m) + ch * 8;
      *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
    }
    cp_async_wait_all();
    __syncthreads();

    // per head: att = v_h attn_h^T (rounded), then x1 += att project_out_h^T
#pragma unroll 1
    for (int hh = 0; hh < HEADS; ++hh) {
      if (!L::ALL_HEADS) {
        load_heads(n, hh, 1);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
      }
      const int hs = L::ALL_HEADS ? hh : 0;  // the head's place in the weight region
      block_mma<nt_of(G::MT, HD)>(as + hh * HD, LDA, PH, attn_s + hs * HD * LDQ, LDQ, HD, HD,
                                  [&](int m, int col, float a, float b) {
                                    *reinterpret_cast<uint32_t*>(att + m * LDQ + col) =
                                        bf16x2_bits(a, b);
                                  });
      __syncthreads();
      block_mma<nt_of(G::MT, C)>(att, LDQ, PH, wp_s + hs * HD, LDW, C, HD,
                                 [&](int m, int col, float a, float b) {
                                   float2* d =
                                       reinterpret_cast<float2*>(L::x1_row(x1, x1r, m) + col);
                                   const float2 o = *d;
                                   *d = make_float2(o.x + a, o.y + b);
                                 });
      __syncthreads();
    }

    float acc_o[kPart / 8][4];
#pragma unroll
    for (int i = 0; i < kPart / 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc_o[i][k] = 0.f;
    if constexpr (!FOLD) {
      // the weight region is free: chunk 0 streams in while LN2 runs
      load_chunk(0);
      ln_rows<C>([&](int i) { return static_cast<const float*>(L::x1_row(x1, x1r, i)); }, as, LDA,
                 PH, p.ln_w, p.ln_b);
      cp_async_wait_all();
      __syncthreads();
      project_in(0, h0, w0);

#pragma unroll 1
      for (int j = 0; j < chunks; ++j) {
        __syncthreads();  // ys of chunk j is complete; with two stages, j + 1's is free
        if (L::STAGES == 2 && j + 1 < chunks) load_chunk(j + 1);
        // the last project_in has read as: the next tile's v streams in meanwhile
        if (j + 1 == chunks && tile + gridDim.x < tiles) load_v(tile + gridDim.x);
        if (tid < GATES) {
          // taps and gate: a thread one gate pair (a_jj, b_jj) of one tile column
          const float* tp = reinterpret_cast<const float*>(stage_of(j) + L::s_taps);
          const int jj = tid % kChunk, cc = tid / kChunk;
          float wa[9], wb[9];
#pragma unroll
          for (int i = 0; i < 9; ++i) {
            wa[i] = tp[jj * 9 + i];
            wb[i] = tp[(kChunk + jj) * 9 + i];
          }
          float ya[3][3], yb[3][3];  // [halo row % 3][dx]
#pragma unroll
          for (int hr = 0; hr < TH + 2; ++hr) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const float* yp = ys + (hr * HW2 + cc + dx) * LDY;
              ya[hr % 3][dx] = yp[jj];
              yb[hr % 3][dx] = yp[kChunk + jj];
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
            gs[(r * TW + cc) * LDG + jj] = __float2bfloat16_rn(gelu_erf(a) * b);
          }
        }
        cp_async_wait_all();
        __syncthreads();  // the gate is complete, ys is free; with two stages j + 1's landed
        if (warp < OUT_ITEMS) {
          const bf16* wo = reinterpret_cast<const bf16*>(stage_of(j) + L::s_wout);
          warp_mma<kPart / 8>(acc_o, gs, LDG, om, P, wo + on * LDG, LDG, kChunk);
        }
        if (j + 1 < chunks) {
          if (L::STAGES == 1) {  // the one stage is free once project_out has read it
            __syncthreads();
            load_chunk(j + 1);
            cp_async_wait_all();
            __syncthreads();
          }
          project_in(j + 1, h0, w0);
        }
      }
    } else {
      // LN2 is zero outside the image (the dw conv's SAME padding); the
      // weight region is free: chunk 0's project_out columns and the first
      // slices stream in while LN2 runs
      const int steps = chunks / CPS, images = steps * F::NSL;
      load_wo(0);
      for (int i = 0; i < FSTAGES - 1; ++i) {
        if (i < images) load_image(i);
        cp_async_commit();
      }
      ln_rows<C>([&](int i) { return static_cast<const float*>(L::x1_row(x1, x1r, i)); }, as,
                 LDA, PH, p.ln_w, p.ln_b,
                 [&](int m) { return G::inside(m, h0, w0, H, W); });
#pragma unroll 1
      for (int j = 0; j < steps; ++j) {
        float acc[FMI][FNT][4] = {};
#pragma unroll 1
        for (int s = 0; s < F::NSL; ++s) {
          // image i has landed and every warp is past image i - 1 (and, at
          // a step's first, past the last step's project_out)
          const int i = j * F::NSL + s;
          cp_async_wait<FSTAGES - 2>();
          __syncthreads();
          if (s == 0 && j > 0) load_wo(j);
          if (i + FSTAGES - 1 < images) load_image(i + FSTAGES - 1);
          cp_async_commit();
          if (warp < FITEMS)
            fold_slice<C, FMI, FNT, false, HW2, LDA>(acc, a_rows, b_off, smem_u32(fstage_of(i)),
                                                     s);
        }
        // the gate: a warp item holds a_jj and b_jj of its gate pairs
        if (warp < FITEMS) {
#pragma unroll
          for (int mi = 0; mi < FMI; ++mi)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int m = 16 * (fm + mi) + g + 8 * half;
#pragma unroll
              for (int jj = 0; jj < FNT / 2; ++jj) {
                const int col = kChunk * fc + 8 * (FNT / 2) * fq + 8 * jj + 2 * t4;
                const float* a = acc[mi][jj] + 2 * half;
                const float* bb = acc[mi][FNT / 2 + jj] + 2 * half;
                *reinterpret_cast<uint32_t*>(gs + m * LDG + col) =
                    bf16x2_bits(gelu_erf(a[0]) * bb[0], gelu_erf(a[1]) * bb[1]);
              }
            }
        }
        __syncthreads();  // the gate is complete; at the last step as is read
        if (j + 1 == steps && tile + gridDim.x < tiles) load_v(tile + gridDim.x);
        if (warp < OUT_ITEMS)
          warp_mma<kPart / 8>(acc_o, gs, LDG, om, P, wof + on * LDG, LDG, CPS * kChunk);
      }
    }

    // out = x1 + the GDFN's project_out on the tile
    if (warp < OUT_ITEMS) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = om + g + 8 * half;
        const int r = m / TW, cc = m % TW;
        if (h0 + r >= H || w0 + cc >= W) continue;
        const float* xp = x1 + m * LDX;
        bf16* op = out + ((static_cast<int64_t>(n) * H + h0 + r) * W + w0 + cc) * C;
#pragma unroll
        for (int i = 0; i < kPart / 8; ++i) {
          const int col = on + 8 * i + 2 * t4;
          *reinterpret_cast<uint32_t*>(op + col) =
              bf16x2_bits(xp[col] + acc_o[i][2 * half], xp[col + 1] + acc_o[i][2 * half + 1]);
        }
      }
    }
    __syncthreads();  // x1 is read; the next tile may load over it
  }
}

// ------------------------------------------------------------ launches ---

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

template <typename F>
cudaError_t set_smem(F kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int TH, int TW>
int64_t tile_count(int h, int w, int* tiles_w) {
  *tiles_w = (w + TW - 1) / TW;
  return static_cast<int64_t>(*tiles_w) * ((h + TH - 1) / TH);
}

template <typename T, int C, int HEADS, bool FOLD>
struct R1 {
  // bf16 takes the bf16 form at every width, FOLD or not (the note at the
  // head of this file); float32 the general form
  static constexpr bool kNew = std::is_same_v<T, bf16>;
  static constexpr int TH = kNew ? R1Geo<C, HEADS, FOLD>::TH : Geo<C, HEADS>::TH;
  static constexpr int TW = kNew ? R1Geo<C, HEADS, FOLD>::TW : Geo<C, HEADS>::TW;

  // r1_kernel or r1_bf16_kernel, its threads and shared memory
  static auto kernel() {
    if constexpr (kNew) {
      return r1_bf16_kernel<C, HEADS, FOLD>;
    } else {
      return r1_kernel<C, HEADS, FOLD>;
    }
  }
  static constexpr int kBlock = kNew ? kThreadsB : kThreads;
  static constexpr size_t bytes() {
    if constexpr (kNew) {
      return R1BLayout<C, HEADS, FOLD>::bytes;
    } else {
      return R1Layout<C, HEADS, FOLD>::bytes;
    }
  }

  // out: the blocks resident on the card at once, and the tile (TH, TW);
  // the wrapper chooses the splits from them (r1_grid)
  static int geometry(int* out) {
    cudaError_t err = set_smem(kernel(), bytes());
    if (err == cudaSuccess) err = resident_blocks(kernel(), kBlock, bytes(), out);
    out[1] = TH;
    out[2] = TW;
    return static_cast<int>(err);
  }

  static int run(const void* x, const void* const* prm, void* v, float* gram_part,
                 float* ss_part, float* gram, float* qss, float* kss, int n, int h, int w,
                 int splits, cudaStream_t st) {
    cudaError_t err = set_smem(kernel(), bytes());
    if (err != cudaSuccess) return static_cast<int>(err);
    int tiles_w = 0;
    const int64_t tiles = tile_count<TH, TW>(h, w, &tiles_w);
    if (tiles > INT32_MAX || n > 65535 || splits > tiles || splits > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(splits, HEADS, n);
    if constexpr (kNew) {
      const R1BParams p{static_cast<const bf16*>(prm[0]), static_cast<const bf16*>(prm[1]),
                        static_cast<const bf16*>(prm[2]),
                        FOLD ? nullptr : static_cast<const float*>(prm[3])};
      r1_bf16_kernel<C, HEADS, FOLD><<<grid, kThreadsB, bytes(), st>>>(
          static_cast<const bf16*>(x), p, static_cast<bf16*>(v), gram_part, ss_part, h, w,
          tiles_w, static_cast<int>(tiles));
    } else {
      const R1Params p{static_cast<const float*>(prm[0]), static_cast<const float*>(prm[1]),
                       static_cast<const float*>(prm[2]),
                       FOLD ? nullptr : static_cast<const float*>(prm[3])};
      r1_kernel<C, HEADS, FOLD><<<grid, kThreads, bytes(), st>>>(
          static_cast<const float*>(x), p, static_cast<float*>(v), gram_part, ss_part, h, w,
          tiles_w, static_cast<int>(tiles));
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t total = static_cast<int64_t>(n) * (C * Geo<C, HEADS>::HD + 2 * C);
    r1_reduce<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        gram_part, ss_part, gram, qss, kss, n, splits, C, Geo<C, HEADS>::HD);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int C, int HEADS, bool FOLD>
struct R2 {
  static constexpr bool kNew = std::is_same_v<T, bf16>;

  static int run(const void* x, const void* v, const void* const* prm, void* out, int n,
                 int h, int w, int hp, cudaStream_t st) {
    if (hp <= 0 || hp % kChunk) return static_cast<int>(cudaErrorInvalidValue);
    if constexpr (kNew) {
      if (hp % (R2BLayout<C, HEADS, FOLD>::CPS * kChunk))
        return static_cast<int>(cudaErrorInvalidValue);
      return launch<R2Geo<C, HEADS>>(r2_bf16_kernel<C, HEADS, FOLD>, kThreadsB,
                                    R2BLayout<C, HEADS, FOLD>::bytes, x, v, prm, out, n, h, w, hp,
                                    st);
    } else {
      return launch<Geo<C, HEADS>>(r2_kernel<C, HEADS, FOLD>, kThreads,
                                   R2Layout<C, HEADS, FOLD>::bytes, x, v, prm, out, n, h, w, hp,
                                   st);
    }
  }

  // persistent blocks: the grid is the resident count, or the tile count
  template <typename G, typename F>
  static int launch(F kernel, int threads, size_t bytes, const void* x, const void* v,
                    const void* const* prm, void* out, int n, int h, int w, int hp,
                    cudaStream_t st) {
    cudaError_t err = set_smem(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int tiles_w = 0;
    const int64_t tiles_hw = tile_count<G::TH, G::TW>(h, w, &tiles_w);
    const int64_t tiles = tiles_hw * n;
    if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    int grid = 0;
    err = resident_blocks(kernel, threads, bytes, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    grid = static_cast<int>(tiles < grid ? tiles : grid);
    // FOLD takes no taps: its params are attn, wp, ln_w, ln_b, win, wout
    if constexpr (kNew) {
      const auto b = [prm](int i) { return static_cast<const bf16*>(prm[i]); };
      const R2BParams p =
          FOLD ? R2BParams{b(0), b(1), b(2), b(3), b(4), nullptr, b(5)}
               : R2BParams{b(0), b(1), b(2), b(3), b(4), static_cast<const float*>(prm[5]), b(6)};
      kernel<<<grid, threads, bytes, st>>>(static_cast<const bf16*>(x),
                                           static_cast<const bf16*>(v), p,
                                           static_cast<bf16*>(out), h, w, hp, tiles_w,
                                           static_cast<int>(tiles_hw), static_cast<int>(tiles));
    } else {
      const auto f = [prm](int i) { return static_cast<const float*>(prm[i]); };
      const R2Params p = FOLD ? R2Params{f(0), f(1), f(2), f(3), f(4), nullptr, f(5)}
                              : R2Params{f(0), f(1), f(2), f(3), f(4), f(5), f(6)};
      kernel<<<grid, threads, bytes, st>>>(static_cast<const float*>(x),
                                           static_cast<const float*>(v), p,
                                           static_cast<float*>(out), h, w, hp, tiles_w,
                                           static_cast<int>(tiles_hw), static_cast<int>(tiles));
    }
    return static_cast<int>(cudaGetLastError());
  }
};

// the (C, heads) pairs of Restormer's levels
#define RESTORMER_WIDTHS(X) X(48, 1) X(96, 1) X(96, 2) X(192, 4) X(384, 8)

template <typename T, bool FOLD>
int r1_geometry(int c, int heads, int* out) {
#define R1_GEOMETRY(CC, HH) \
  if (c == CC && heads == HH) return R1<T, CC, HH, FOLD>::geometry(out);
  RESTORMER_WIDTHS(R1_GEOMETRY)
#undef R1_GEOMETRY
  return static_cast<int>(cudaErrorInvalidValue);
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

// bit 0: R1 (FOLD: R1-mxu) takes its bf16 form at (C, heads), bit 1: R2 does
template <typename T, bool FOLD>
int forms(int c, int heads) {
#define FORMS(CC, HH) \
  if (c == CC && heads == HH) return R1<T, CC, HH, FOLD>::kNew | R2<T, CC, HH, FOLD>::kNew << 1;
  RESTORMER_WIDTHS(FORMS)
#undef FORMS
  return -static_cast<int>(cudaErrorInvalidValue);
}

template <bool FOLD>
int r1_geometry_any(int dtype, int c, int heads, int* out) {
  if (dtype == 0) return r1_geometry<float, FOLD>(c, heads, out);
  if (dtype == 1) return r1_geometry<__nv_bfloat16, FOLD>(c, heads, out);
  return static_cast<int>(cudaErrorInvalidValue);
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

// dtype: 0 = float32, 1 = bfloat16. Bit 0 set: restormer_r1 (fold = 1:
// restormer_r1_mxu) runs its bf16 form at (c, heads) and takes its params in
// bf16 (the taps in f32); bit 1 set: restormer_r2 (restormer_r2_mxu) does.
// Minus a cudaError_t for widths not built.
extern "C" int restormer_forms(int dtype, int c, int heads, int fold) {
  if (dtype == 0) return fold ? forms<float, true>(c, heads) : forms<float, false>(c, heads);
  if (dtype == 1) return fold ? forms<bf16, true>(c, heads) : forms<bf16, false>(c, heads);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16 (x and v). out[3]: the blocks of R1
// (fold = 1: R1 with the taps folded in, restormer_r1_mxu) resident on the
// card at once, and the tile's height and width. Returns a cudaError_t.
extern "C" int restormer_r1_geometry(int dtype, int c, int heads, int fold, int* out) {
  return fold ? r1_geometry_any<true>(dtype, c, heads, out)
              : r1_geometry_any<false>(dtype, c, heads, out);
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
// dw_mxu=True). params: norm1 weight and bias, the folded qkv, row o holding
// W[i, o] k[dh, dx, o] at column (3 dh + dx) C + i: in float32 (3C, 9C), in
// bf16 (the bf16 form) (heads, 3, C / heads, 9C), each head's q, k and v rows
// adjacent. The rest as restormer_r1.
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
// dw_mxu=True). params (in x's dtype, all float32 for the general form):
// attn, project_out, norm2 weight and bias as restormer_r2, the folded
// project_in (2hp, 9C) chunk-ordered, the GDFN's project_out (C, hp).
extern "C" int restormer_r2_mxu(const void* x, const void* v, const void* const* params,
                                void* out, int dtype, int n, int h, int w, int c, int heads,
                                int hp, void* stream) {
  return r2_any<true>(x, v, params, out, dtype, n, h, w, c, heads, hp, stream);
}
