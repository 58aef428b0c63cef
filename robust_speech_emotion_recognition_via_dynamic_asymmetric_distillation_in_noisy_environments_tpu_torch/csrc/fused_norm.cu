// Fused row LayerNorm (+ residual, + affine, + tanh-GELU) and a row copy,
// written by hand for Hopper (sm_90a). Bound to PyTorch through ctypes by
// ops/fused_norm.py.
//
// fused_ln_fwd replaces the TPU kernel ops/fused_norm.py:_make_kernel of the
// JAX package (reached through _fused_ln_call / fused_layernorm):
//   z = x [+ residual]                      (f32)
//   mu = E[z], var = E[z^2] - mu^2           (f32, flax's fast variance)
//   y = (z - mu) * rsqrt(var + eps) [* scale + bias] [-> tanh-GELU]
// stored in x's type. Rows of C elements, C a multiple of 128 (the JAX
// kernel's lane rule), C <= 2048 here.
//
// copy_rows replaces the TPU copy probe tools/bench_fused_norm.py:copy_kernel:
// the device-memory bandwidth ceiling the LN kernel is judged against.
//
// What bounds them: both are memory-bound. One LN row reads C elements (twice
// that with a residual) and writes C; at (64*199, 768) bf16 with residual
// that is 58.7 MB, 0.018 ms at 3.35 TB/s, and at (64*3199, 512) bf16 with
// GELU 419 MB, 0.125 ms; the copy of the latter moves the same 419 MB. The
// design reads each element once and writes it once: one warp owns one row,
// each lane keeps its C/32 elements in registers (chunks of 4 contiguous
// elements, 8-byte loads for bf16, 16-byte for f32), the two f32 sums are
// reduced with warp shuffles, and the row is normalised and stored from the
// registers. The TPU kernel's ones-matmul reduction trick has no purpose
// here: a warp reduction is five shuffles. The copy is a grid-stride loop of
// 16-byte vectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps = 8 rows per block
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;
constexpr float GELU_C = 0.044715f;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&a);
  t.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_tanh(float a) {
  return 0.5f * a * (1.f + tanhf(SQRT_2_OVER_PI * (a + GELU_C * a * a * a)));
}

// One warp per row; NCHUNK = C / 128 chunks of 4 elements per lane, chunk j
// of lane l covering elements [4 (32 j + l), 4 (32 j + l) + 4).
template <typename T, int NCHUNK>
__global__ void __launch_bounds__(THREADS)
fused_ln_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ scale, const float* __restrict__ bias,
                T* __restrict__ out, int M, int gelu, float eps) {
  constexpr int C = NCHUNK * 128;
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t base = (size_t)row * C;

  float v[NCHUNK][4];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < NCHUNK; ++j) {
    const int c = (j * 32 + lane) * 4;
    load4(x + base + c, v[j]);
    if (res != nullptr) {
      float r[4];
      load4(res + base + c, r);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] += r[e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s1 += v[j][e];
      s2 += v[j][e] * v[j][e];
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float inv_c = 1.f / C;
  const float mu = s1 * inv_c;
  const float var = s2 * inv_c - mu * mu;
  const float inv = rsqrtf(var + eps);

#pragma unroll
  for (int j = 0; j < NCHUNK; ++j) {
    const int c = (j * 32 + lane) * 4;
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float a = (v[j][e] - mu) * inv;
      if (scale != nullptr) a = a * scale[c + e] + bias[c + e];
      y[e] = gelu ? gelu_tanh(a) : a;
    }
    store4(out + base + c, y);
  }
}

template <typename T>
cudaError_t launch_ln(const T* x, const T* res, const float* scale, const float* bias,
                      T* out, int M, int C, int gelu, float eps, cudaStream_t stream) {
  const dim3 grid((M + THREADS / 32 - 1) / (THREADS / 32));
  switch (C / 128) {
#define LN_CASE(N)                                                          \
  case N:                                                                   \
    fused_ln_kernel<T, N><<<grid, THREADS, 0, stream>>>(x, res, scale, bias, \
                                                         out, M, gelu, eps); \
    break;
    LN_CASE(1) LN_CASE(2) LN_CASE(3) LN_CASE(4) LN_CASE(5) LN_CASE(6)
    LN_CASE(7) LN_CASE(8) LN_CASE(9) LN_CASE(10) LN_CASE(11) LN_CASE(12)
    LN_CASE(13) LN_CASE(14) LN_CASE(15) LN_CASE(16)
#undef LN_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

__global__ void copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                            size_t n16, const uint8_t* __restrict__ src_tail,
                            uint8_t* __restrict__ dst_tail, size_t tail) {
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = first; i < n16; i += stride) dst[i] = src[i];
  if (first < tail) dst_tail[first] = src_tail[first];  // the last < 16 bytes
}

}  // namespace

extern "C" {

// x, res (may be null), out: (M, C) contiguous, 16-byte aligned; scale and
// bias: (C,) f32 or both null. dtype: 0 = f32, 1 = bf16.
int fused_ln_fwd(const void* x, const void* res, const void* scale, const void* bias,
                 void* out, int M, int C, int dtype, int gelu, float eps, void* stream) {
  if (M <= 0) return 0;
  if (C <= 0 || C % 128 != 0 || C > 2048) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == 1)
    return (int)launch_ln(static_cast<const __nv_bfloat16*>(x),
                          static_cast<const __nv_bfloat16*>(res), sc, bi,
                          static_cast<__nv_bfloat16*>(out), M, C, gelu, eps, s);
  return (int)launch_ln(static_cast<const float*>(x), static_cast<const float*>(res),
                        sc, bi, static_cast<float*>(out), M, C, gelu, eps, s);
}

// Copies nbytes from src to dst (both 16-byte aligned).
int copy_rows(const void* src, void* dst, size_t nbytes, void* stream) {
  if (nbytes == 0) return 0;
  const size_t n16 = nbytes / 16;
  const size_t tail = nbytes - n16 * 16;
  size_t blocks = (n16 + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride: 16 blocks per SM
  if (blocks == 0) blocks = 1;
  copy_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n16,
      static_cast<const uint8_t*>(src) + n16 * 16, static_cast<uint8_t*>(dst) + n16 * 16,
      tail);
  return (int)cudaGetLastError();
}

}  // extern "C"
