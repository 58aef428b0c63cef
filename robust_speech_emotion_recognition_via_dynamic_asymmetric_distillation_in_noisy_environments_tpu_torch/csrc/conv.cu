// Fused 1-D conv + channel LayerNorm + GELU for the wav2vec2-style conv
// front end, written by hand for Hopper (sm_90a). Bound to PyTorch through
// ctypes by ops/conv.py.
//
// Replaces the TPU kernels ops/conv.py:_kernel, _kernel_db and _kernel_mb of
// the JAX package (one body, _compute_tile, three DMA schedules), reached
// through fused_conv_ln_gelu / pallas_conv_stack:
//   acc[t] = sum_j x[t*s + j] @ W[j]          (VALID, stride s, no bias, f32)
//   y[t]   = GELU(LN(acc[t]) * scale + bias)  (two-pass f32 variance, eps 1e-5)
// GELU is erf-GELU through the JAX kernel's polynomial erf (Abramowitz-Stegun
// 7.1.26, |err| <= 1.5e-7), or tanh-GELU; y is stored in x's type.
// Layouts: x (B, L, C_in), W (k, C_in, C_out), out (B, T_out, C_out), all
// contiguous; scale and bias (C_out,) f32.
//
// The TPU design regroups x as (B, G, s*C) on the host because Mosaic has no
// strided slices. Here the stride is only an index: output row t of tap j
// reads input row t*s + j, so no relayout is needed.
//
// Two paths, chosen by the caller:
// - conv_ln_gelu_wmma (bf16, C_in % 32 == 0, C_out in {128, ..., 512}: conv
//   layers 1-6 of emotion2vec). One block owns TM = 32 output rows across all
//   C_out channels, because the LN needs whole rows. 8 warps; warp w owns
//   C_out/8 columns as 2 x (C_out/128) WMMA 16x16 f32 accumulators. The k
//   taps and the C_in channels stream through shared memory in chunks of 32
//   channels: an A tile of 32 rows x 32 channels and a B tile of 32 x C_out
//   weights. After the last chunk the accumulators go to shared memory (32 x
//   C_out f32) for the LN + GELU epilogue, and each row is stored once.
//   Bound: layers 1-6 at B = 64, 4 s are 1.25e12 FLOP, 1.26 ms at
//   989 TFLOP/s bf16. This first version loads tiles synchronously (no
//   cp.async / TMA, no wgmma) and re-reads the layer's weights (1.5 MB) from
//   L2 in every block.
// - conv_ln_gelu_fma (any C_in, any C_out, bf16 or f32): FMA loops in f32,
//   one thread per output channel over TR output rows held in registers,
//   the input window of the block in shared memory. It serves layer 0
//   (C_in = 1, k = 10, s = 5), which is bytes-bound (839 MB written at
//   B = 64, 4 s: 0.25 ms), and the f32 variant, which stays exact f32
//   (no TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The JAX kernel's polynomial erf (ops/conv.py:_erf), sign(0) = 0.
__device__ __forceinline__ float erf_poly(float x) {
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * ax);
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
       0.254829592f) * t;
  const float r = 1.f - poly * expf(-ax * ax);
  return x > 0.f ? r : (x < 0.f ? -r : 0.f);
}

__device__ __forceinline__ float gelu(float x, int approx) {
  if (approx)
    return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  return x * 0.5f * (1.f + erf_poly(x * 0.7071067811865476f));
}

// LN + affine + GELU of `rows` rows of a (rows x C) f32 tile with row stride
// ld, one warp per row; row r is written to out + r * C.
template <typename T>
__device__ void ln_gelu_rows(const float* tile, int ld, int C, int rows,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias, T* __restrict__ out,
                             int approx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_c = 1.f / C;
  for (int r = warp; r < rows; r += WARPS) {
    const float* v = tile + (size_t)r * ld;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += v[c];
    const float mean = warp_sum(s) * inv_c;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = v[c] - mean;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) * inv_c + LN_EPS);
    T* o = out + (size_t)r * C;
    for (int c = lane; c < C; c += 32)
      o[c] = from_f32<T>(gelu((v[c] - mean) * inv * scale[c] + bias[c], approx));
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16)
// ---------------------------------------------------------------------------
constexpr int TM = 32;       // output rows per block
constexpr int KC = 32;       // input channels per chunk
constexpr int LDA = KC + 8;  // bf16 row strides: skew banks, keep 32 B alignment

template <int NCOL>  // C_out = 128 * NCOL
constexpr int wmma_smem_bytes() {
  constexpr int cout = 128 * NCOL;
  constexpr int tiles = (TM * LDA + KC * (cout + 8)) * 2;
  constexpr int acc = TM * (cout + 4) * 4;
  return tiles > acc ? tiles : acc;
}

template <int NCOL>
__global__ void __launch_bounds__(THREADS)
conv_wmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int L, int C_in, int T_out, int k,
                 int s, int approx) {
  constexpr int C_OUT = 128 * NCOL;
  constexpr int LDB = C_OUT + 8;
  constexpr int LDC = C_OUT + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // TM x LDA
  __nv_bfloat16* Bs = As + TM * LDA;                            // KC x LDB
  float* Cs = reinterpret_cast<float*>(smem);  // TM x LDC, after the K loop

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int warp = threadIdx.x >> 5;
  const __nv_bfloat16* xb = x + (size_t)b * L * C_in;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NCOL];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NCOL; ++n) wmma::fill_fragment(acc[m][n], 0.f);

  for (int j = 0; j < k; ++j) {
    for (int c0 = 0; c0 < C_in; c0 += KC) {
      // A: output row t0 + r reads input row (t0 + r) * s + j; rows past
      // T_out are zero
      for (int i = threadIdx.x; i < TM * (KC / 8); i += THREADS) {
        const int r = i / (KC / 8), v = i % (KC / 8);
        const int t = t0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (t < T_out)
          val = *reinterpret_cast<const uint4*>(xb + ((size_t)t * s + j) * C_in + c0 + v * 8);
        *reinterpret_cast<uint4*>(As + r * LDA + v * 8) = val;
      }
      // B: W[j][c0 : c0 + KC][:]
      const __nv_bfloat16* wj = w + ((size_t)j * C_in + c0) * C_OUT;
      for (int i = threadIdx.x; i < KC * (C_OUT / 8); i += THREADS) {
        const int r = i / (C_OUT / 8), v = i % (C_OUT / 8);
        *reinterpret_cast<uint4*>(Bs + r * LDB + v * 8) =
            *reinterpret_cast<const uint4*>(wj + (size_t)r * C_OUT + v * 8);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0, a1;
        wmma::load_matrix_sync(a0, As + kk, LDA);
        wmma::load_matrix_sync(a1, As + 16 * LDA + kk, LDA);
#pragma unroll
        for (int n = 0; n < NCOL; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, Bs + kk * LDB + (warp * NCOL + n) * 16, LDB);
          wmma::mma_sync(acc[0][n], a0, bf, acc[0][n]);
          wmma::mma_sync(acc[1][n], a1, bf, acc[1][n]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NCOL; ++n)
      wmma::store_matrix_sync(Cs + m * 16 * LDC + (warp * NCOL + n) * 16, acc[m][n], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  const int rows = min(TM, T_out - t0);
  ln_gelu_rows(Cs, LDC, C_OUT, rows, scale, bias, out + ((size_t)b * T_out + t0) * C_OUT,
               approx);
}

template <int NCOL>
cudaError_t launch_wmma(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* scale,
                        const float* bias, __nv_bfloat16* out, int B, int L, int C_in,
                        int T_out, int k, int s, int approx, cudaStream_t stream) {
  constexpr int bytes = wmma_smem_bytes<NCOL>();
  cudaError_t err = cudaFuncSetAttribute(conv_wmma_kernel<NCOL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_out + TM - 1) / TM, B);
  conv_wmma_kernel<NCOL><<<grid, THREADS, bytes, stream>>>(x, w, scale, bias, out, L, C_in,
                                                           T_out, k, s, approx);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// FMA path (any C_in / C_out, bf16 or f32)
// ---------------------------------------------------------------------------
template <int TR>
size_t fma_smem_bytes(int C_in, int C_out, int k, int s) {
  const size_t window = (size_t)((TR - 1) * s + k) * C_in;
  return (window + (size_t)TR * C_out) * sizeof(float);
}

template <typename T, int TR>
__global__ void __launch_bounds__(THREADS)
conv_fma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const float* __restrict__ scale, const float* __restrict__ bias,
                T* __restrict__ out, int L, int C_in, int C_out, int T_out, int k, int s,
                int approx) {
  extern __shared__ __align__(16) float fsmem[];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TR;
  const int rows = min(TR, T_out - t0);
  const int window = (TR - 1) * s + k;        // input rows the block may touch
  const int loaded = (rows - 1) * s + k;      // input rows it needs (<= L - t0*s)
  float* xs = fsmem;                          // window x C_in
  float* tile = fsmem + (size_t)window * C_in;  // TR x C_out

  const T* src = x + ((size_t)b * L + (size_t)t0 * s) * C_in;
  for (int i = threadIdx.x; i < window * C_in; i += THREADS)
    xs[i] = i < loaded * C_in ? to_f32(src[i]) : 0.f;
  __syncthreads();

  for (int c = threadIdx.x; c < C_out; c += THREADS) {
    float acc[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) acc[r] = 0.f;
    for (int j = 0; j < k; ++j) {
      for (int ci = 0; ci < C_in; ++ci) {
        const float wv = to_f32(w[((size_t)j * C_in + ci) * C_out + c]);
        const float* xr = xs + (size_t)j * C_in + ci;
#pragma unroll
        for (int r = 0; r < TR; ++r) acc[r] = fmaf(xr[(size_t)r * s * C_in], wv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < TR; ++r)
      if (r < rows) tile[(size_t)r * C_out + c] = acc[r];
  }
  __syncthreads();
  ln_gelu_rows(tile, C_out, C_out, rows, scale, bias, out + ((size_t)b * T_out + t0) * C_out,
               approx);
}

template <typename T, int TR>
cudaError_t launch_fma(const T* x, const T* w, const float* scale, const float* bias, T* out,
                       int B, int L, int C_in, int C_out, int T_out, int k, int s, int approx,
                       size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv_fma_kernel<T, TR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_out + TR - 1) / TR, B);
  conv_fma_kernel<T, TR><<<grid, THREADS, bytes, stream>>>(x, w, scale, bias, out, L, C_in,
                                                           C_out, T_out, k, s, approx);
  return cudaGetLastError();
}

constexpr size_t MAX_SMEM = 232448;  // 227 KB: the most one block may use

template <typename T>
cudaError_t dispatch_fma(const T* x, const T* w, const float* scale, const float* bias,
                         T* out, int B, int L, int C_in, int C_out, int T_out, int k, int s,
                         int approx, cudaStream_t stream) {
  // the most rows per block whose window and tile fit in shared memory
  size_t bytes = fma_smem_bytes<32>(C_in, C_out, k, s);
  if (bytes <= MAX_SMEM)
    return launch_fma<T, 32>(x, w, scale, bias, out, B, L, C_in, C_out, T_out, k, s, approx,
                             bytes, stream);
  bytes = fma_smem_bytes<8>(C_in, C_out, k, s);
  if (bytes <= MAX_SMEM)
    return launch_fma<T, 8>(x, w, scale, bias, out, B, L, C_in, C_out, T_out, k, s, approx,
                            bytes, stream);
  bytes = fma_smem_bytes<1>(C_in, C_out, k, s);
  if (bytes <= MAX_SMEM)
    return launch_fma<T, 1>(x, w, scale, bias, out, B, L, C_in, C_out, T_out, k, s, approx,
                            bytes, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (B, L, C_in), w (k, C_in, C_out) bf16, 16-byte aligned; C_in % 32 == 0,
// C_out in {128, 256, 384, 512}; scale/bias (C_out,) f32; out (B, T_out, C_out).
int conv_ln_gelu_wmma(const void* x, const void* w, const void* scale, const void* bias,
                      void* out, int B, int L, int C_in, int C_out, int k, int s,
                      int approx, void* stream) {
  const int T_out = (L - k) / s + 1;
  if (B <= 0 || L < k || T_out <= 0) return 0;
  if (C_in % KC != 0) return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C_out) {
    case 128: return (int)launch_wmma<1>(xb, wb, sc, bi, ob, B, L, C_in, T_out, k, s, approx, st);
    case 256: return (int)launch_wmma<2>(xb, wb, sc, bi, ob, B, L, C_in, T_out, k, s, approx, st);
    case 384: return (int)launch_wmma<3>(xb, wb, sc, bi, ob, B, L, C_in, T_out, k, s, approx, st);
    case 512: return (int)launch_wmma<4>(xb, wb, sc, bi, ob, B, L, C_in, T_out, k, s, approx, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same function for any C_in / C_out; dtype 0 = f32, 1 = bf16.
int conv_ln_gelu_fma(const void* x, const void* w, const void* scale, const void* bias,
                     void* out, int B, int L, int C_in, int C_out, int k, int s, int dtype,
                     int approx, void* stream) {
  const int T_out = (L - k) / s + 1;
  if (B <= 0 || L < k || T_out <= 0) return 0;
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch_fma(static_cast<const __nv_bfloat16*>(x),
                             static_cast<const __nv_bfloat16*>(w), sc, bi,
                             static_cast<__nv_bfloat16*>(out), B, L, C_in, C_out, T_out, k, s,
                             approx, st);
  return (int)dispatch_fma(static_cast<const float*>(x), static_cast<const float*>(w), sc, bi,
                           static_cast<float*>(out), B, L, C_in, C_out, T_out, k, s, approx,
                           st);
}

}  // extern "C"
