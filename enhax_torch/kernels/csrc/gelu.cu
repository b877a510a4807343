// The exact (erf) GELU as a standalone elementwise pass on Hopper (sm_90a),
// float32: 0.5 x (1 + erf(x / sqrt 2)), with one of two erf forms.
//
// Replaces the Pallas TPU kernel gelu_kernel of run/probe_gelu_kernel.py
// (pallas_call at :83, kernel at :71), which prices the two polynomial erfs
// the TPU kernels chose between (Mosaic has no erf):
//   form 0, A&S 7.1.26 (:49): sign(z) (1 - t P5(t) exp(-z^2)), t = 1 / (1 +
//     0.3275911 |z|): one exp and one divide;
//   form 1, rational (:56): z P5(z^2) / Q4(z^2) on clamp(z, -4, 4): one
//     divide, no exp.
// The coefficients and the order of every operation are the probe's; the
// products and sums are written with __fmul_rn / __fadd_rn so that nvcc does
// not contract them into FMAs (the probe's arithmetic rounds each step), and
// the source builds without fast math (expf and the divide are IEEE-exact to
// a few ulp). The fused RestormerBlock kernel R2 uses erff instead.
//
// Bound: bytes. Each element is read once and written once (8 bytes) for
// ~30 flops: at (15, 256, 256, 128) that is 1.0066 GB, 0.300 ms at
// 3.35 TB/s, against 0.056 ms of f32 work at 67 TFLOP/s (the exp and the
// divide are a few instructions each, still far below). Design: a thread
// takes 16 bytes (float4), one vector a thread over a grid as large as the
// work (a grid-stride loop past 2^31 blocks), so that the card holds as many
// loads in flight as it has threads (16 B on each of 2,048 threads an SM,
// 32 KB, twice what the memory's latency asks for). Loads are evict-first
// (ld.global.cs) and stores streaming (st.global.cs), so the 503 MB output
// does not evict input lines from L2. Two to four float4s a thread, loaded
// before any is computed, were slower on the card, as was a grid of a few
// resident waves walking the array (PERF.md). A tail of n % 4 elements, or
// a pointer not 16-byte aligned, takes the scalar loop.
//
// Plain C interface for ctypes: launches on the stream it is given,
// allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float erf_as(float z) {
  const float a = fabsf(z);
  const float t = __fdiv_rn(1.0f, add(1.0f, mul(0.3275911f, a)));
  float poly = add(-1.453152027f, mul(t, 1.061405429f));
  poly = add(1.421413741f, mul(t, poly));
  poly = add(-0.284496736f, mul(t, poly));
  poly = add(0.254829592f, mul(t, poly));
  poly = mul(t, poly);
  const float sign = static_cast<float>((z > 0.f) - (z < 0.f));
  return mul(sign, add(1.0f, -mul(poly, expf(-mul(a, a)))));
}

__device__ __forceinline__ float erf_rational(float z) {
  z = fminf(fmaxf(z, -4.0f), 4.0f);
  const float s = mul(z, z);
  float p = add(4.541595940311584e-06f, mul(s, -1.2470351406334228e-08f));
  p = add(0.00037391180030277586f, mul(s, p));
  p = add(0.0038262388474131987f, mul(s, p));
  p = add(0.05417170777013625f, mul(s, p));
  p = add(0.18505783362438136f, mul(s, p));
  p = add(1.1283791749554233f, mul(s, p));
  float q = add(0.0012949563768775315f, mul(s, 6.173045363623838e-05f));
  q = add(0.015397154870790184f, mul(s, q));
  q = add(0.11378662606783872f, mul(s, q));
  q = add(0.4973367187815083f, mul(s, q));
  return __fdiv_rn(mul(z, p), add(1.0f, mul(s, q)));
}

template <int FORM>
__device__ __forceinline__ float gelu(float x) {
  const float z = mul(x, 0.7071067811865476f);
  const float e = FORM == 0 ? erf_as(z) : erf_rational(z);
  return mul(mul(0.5f, x), add(1.0f, e));
}

template <int FORM>
__device__ __forceinline__ float4 gelu4(float4 v) {
  return make_float4(gelu<FORM>(v.x), gelu<FORM>(v.y), gelu<FORM>(v.z), gelu<FORM>(v.w));
}

// n4 float4s from the start (0 when the pointers are not 16-byte aligned),
// then the n - 4 n4 scalars after them
template <int FORM>
__global__ void __launch_bounds__(kThreads) gelu_kernel(const float* __restrict__ x,
                                                        float* __restrict__ y, int64_t n,
                                                        int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  for (int64_t i = first; i < n4; i += stride) __stcs(y4 + i, gelu4<FORM>(__ldcs(x4 + i)));
  for (int64_t i = 4 * n4 + first; i < n; i += stride) __stcs(y + i, gelu<FORM>(__ldcs(x + i)));
}

}  // namespace

// y = gelu(x) over n float32 elements; form 0 = A&S erf, 1 = rational erf.
// vec: the caller found both pointers 16-byte aligned.
extern "C" int gelu_apply(const void* x, void* y, int64_t n, int form, int vec, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n4 = vec ? n / 4 : 0;
  const int64_t work = n4 + (n - 4 * n4);
  // a thread a vector: as many loads in flight as the card holds threads
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) blocks = INT32_MAX;
  const float* xi = static_cast<const float*>(x);
  float* yo = static_cast<float*>(y);
  if (form == 0) {
    gelu_kernel<0><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(xi, yo, n, n4);
  } else if (form == 1) {
    gelu_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(xi, yo, n, n4);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
