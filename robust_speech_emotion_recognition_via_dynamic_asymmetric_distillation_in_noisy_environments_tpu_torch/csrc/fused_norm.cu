// Fused row LayerNorm (+ residual, + affine, + tanh-GELU) and a row copy,
// written by hand for Hopper (sm_90a). Bound to PyTorch through ctypes by
// ops/fused_norm.py, which also computes the LN grid (ln_plan there).
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
// What bounds them on an H100: bytes. One LN row reads C elements (twice
// that with a residual) and writes C: at (64*199, 768) bf16 with residual
// 58.7 MB, 0.0175 ms at 3.35 TB/s; at (64*3199, 512) bf16 with GELU 419 MB,
// 0.125 ms. The copy of the latter moves the same 419 MB.
//
// What the design does about it:
// - LN: one warp owns a row. Lane 0 brings the row (x, and the residual
//   row) into the warp's shared memory with 1-D bulk copies (cp.async.bulk,
//   the TMA without a tensor map), completing on an mbarrier; a ring of
//   two stages a warp lets it bring the warp's next row while the lanes
//   reduce, normalise and store this one. Lanes read their chunks from
//   shared memory as 16-byte vectors (8 bf16 or 4 f32; 8-byte vectors of
//   4 bf16 when C is an odd multiple of 128), keep z in registers and store
//   y as the same vectors.
// - The grid gives each warp LN_ROWS_PER_WARP = 2 rows, w and w + W
//   (ops/fused_norm.py::ln_plan), so the second row's copy overlaps the
//   first row's work. A persistent grid (as many blocks as are resident,
//   each warp walking M / W rows through a ring of 2-4 stages) was built and
//   measured first: as fast at 12736 rows of 768, but 1.2x slower at 204736
//   rows of 512 with GELU, whatever the ring's depth (PERF.md). Warps
//   that start together and walk 48 rows each move in step; many
//   short-lived blocks keep the SMs' loads and stores staggered.
// - scale and bias are read once per warp into registers, as 16-byte
//   vectors, not once per row (up to C = 1024; wider rows would spill them,
//   and read them per row from L1, as 16-byte vectors too).
// - The two f32 sums are reduced with warp shuffles (the TPU kernel's
//   ones-matmul trick has no purpose here).
// - tanh-GELU is evaluated as a * sigmoid(2u), the same function as
//   0.5 a (1 + tanh u), with one ex2 and one reciprocal.
// - Copy: one 16-byte vector a thread, a streaming (evict-first) load and
//   store, over a grid that covers the buffer: blocks of 1024 threads, one
//   16 KB tile each, and the last bytes that are not a multiple of 16 by
//   block 0's threads. Two designs closer to the TPU probe's intent were
//   built and measured first and lost (PERF.md): a copy through shared
//   memory with bulk copies (one thread a block streaming 32 KB chunks
//   through a ring of 4 stages completing on mbarriers, one block an SM),
//   and a register copy with 8 independent 16-byte loads in flight a
//   thread over a grid of 32 blocks an SM. Of the grid shapes tried (128 to
//   1024 threads a block, 1 to 16 vectors a thread, capped and full grids),
//   the simplest was the fastest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int LN_WARPS = 4;  // warps per block (ops/fused_norm.py: LN_WARPS)
constexpr int LN_THREADS = LN_WARPS * 32;
constexpr int COPY_THREADS = 1024;  // ops/fused_norm.py: COPY_THREADS
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;
constexpr float GELU_C = 0.044715f;

// ---- mbarriers and bulk copies (PTX) -------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"  // the braces scope the label to this copy of the loop
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// global -> shared, `bytes` a multiple of 16, both addresses 16-byte aligned
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- vectors of VEC elements <-> f32 --------------------------------------

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (std::is_same_v<T, float>) {
    static_assert(VEC == 4, "f32 chunks are 16-byte vectors");
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    uint32_t w[VEC / 2];
    if constexpr (VEC == 8) {
      const uint4 t = *reinterpret_cast<const uint4*>(p);
      w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
    } else {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      w[0] = t.x; w[1] = t.y;
    }
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {  // bf16 -> f32 is a shift
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint32_t w[VEC / 2];
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (VEC == 8)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

template <int VEC>  // VEC f32 of scale or bias, 16 bytes at a time
__device__ __forceinline__ void load_f32(const float* p, float (&v)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; e += 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p + e));
    v[e] = t.x; v[e + 1] = t.y; v[e + 2] = t.z; v[e + 3] = t.w;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 0.5 a (1 + tanh u) = a sigmoid(2u), u = sqrt(2/pi) (a + 0.044715 a^3): one
// ex2 and one reciprocal; the exponent is capped where the result is 0 to
// f32 precision anyway
__device__ __forceinline__ float gelu_tanh(float a) {
  const float u = SQRT_2_OVER_PI * (a + GELU_C * a * a * a);
  return __fdividef(a, 1.f + __expf(fminf(-2.f * u, 80.f)));
}

// ---- LayerNorm -------------------------------------------------------------

template <typename T, int C>
struct LnShape {
  static constexpr int VEC = (sizeof(T) == 2 && C % 256 == 0) ? 8 : 4;  // per lane chunk
  static constexpr int NCHUNK = C / (32 * VEC);
  // chunks of scale and bias a lane keeps in registers: all of them up to
  // C = 1024 (2 x 24 f32 a lane at 768); above, the 2 x C/32 f32 beside the
  // row's C/32 would spill, so wide rows read them per row instead
  static constexpr int KEEP = C <= 1024 ? NCHUNK : 1;
  static constexpr uint32_t ROW_BYTES = C * sizeof(T);
  // two stages of x [+ residual] rows a warp
  static constexpr size_t smem_bytes(bool has_res) {
    return (size_t)LN_WARPS * 2 * (has_res ? 2 : 1) * ROW_BYTES;
  }
};

// Warp w of the grid normalises rows w, w + W, ... (W warps in all).
template <typename T, int C>
__global__ void __launch_bounds__(LN_THREADS)
fused_ln_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ scale, const float* __restrict__ bias,
                T* __restrict__ out, int M, int gelu, float eps) {
  using S = LnShape<T, C>;
  constexpr int VEC = S::VEC, NCHUNK = S::NCHUNK;
  constexpr uint32_t ROW_BYTES = S::ROW_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[LN_WARPS][2];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = blockIdx.x * LN_WARPS + warp;
  const int stride = gridDim.x * LN_WARPS;
  if (first >= M) return;  // no block-wide synchronisation below
  const int streams = res != nullptr ? 2 : 1;
  unsigned char* ring = smem + (size_t)warp * 2 * streams * ROW_BYTES;
  uint64_t* bar = bars[warp];

  if (lane == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init_fence();
  }
  __syncwarp();

  auto row_in = [&](int stage, int stream) {
    return reinterpret_cast<T*>(ring + (stage * streams + stream) * ROW_BYTES);
  };
  auto prefetch = [&](int row, int stage) {  // lane 0
    mbar_expect_tx(&bar[stage], streams * ROW_BYTES);
    bulk_load(row_in(stage, 0), x + (size_t)row * C, ROW_BYTES, &bar[stage]);
    if (res != nullptr) bulk_load(row_in(stage, 1), res + (size_t)row * C, ROW_BYTES, &bar[stage]);
  };
  if (lane == 0) prefetch(first, 0);

  // lane chunk j covers elements [VEC (32 j + lane), VEC (32 j + lane) + VEC)
  float sc[S::KEEP][VEC], bi[S::KEEP][VEC];
  const bool affine = scale != nullptr;
  if (affine && S::KEEP == NCHUNK) {
#pragma unroll
    for (int j = 0; j < S::KEEP; ++j) {
      const int c = (32 * j + lane) * VEC;
      load_f32<VEC>(scale + c, sc[j]);
      load_f32<VEC>(bias + c, bi[j]);
    }
  }
  const float inv_c = 1.f / C;

  int it = 0;
  for (int row = first; row < M; row += stride, ++it) {
    const int stage = it & 1;
    // refill the other stage, which the previous row was read from (every
    // lane is past the __syncwarp that follows those reads)
    if (lane == 0 && row + stride < M) prefetch(row + stride, stage ^ 1);
    mbar_wait(&bar[stage], (it >> 1) & 1);

    float v[NCHUNK][VEC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NCHUNK; ++j) {
      const int c = (32 * j + lane) * VEC;
      load_vec<T, VEC>(row_in(stage, 0) + c, v[j]);
      if (res != nullptr) {
        float r[VEC];
        load_vec<T, VEC>(row_in(stage, 1) + c, r);
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[j][e] += r[e];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s1 += v[j][e];
        s2 += v[j][e] * v[j][e];
      }
    }
    __syncwarp();  // every lane has read this stage: lane 0 may refill it
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float mu = s1 * inv_c;
    const float inv = rsqrtf(s2 * inv_c - mu * mu + eps);

    T* o = out + (size_t)row * C;
#pragma unroll
    for (int j = 0; j < NCHUNK; ++j) {
      float y[VEC], s[VEC], b[VEC];
      if (affine) {
        if constexpr (S::KEEP == NCHUNK) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) s[e] = sc[j][e], b[e] = bi[j][e];
        } else {  // wide rows: from L1, as 16-byte vectors
          load_f32<VEC>(scale + (32 * j + lane) * VEC, s);
          load_f32<VEC>(bias + (32 * j + lane) * VEC, b);
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float a = (v[j][e] - mu) * inv;
        if (affine) a = a * s[e] + b[e];
        y[e] = gelu ? gelu_tanh(a) : a;
      }
      store_vec<T, VEC>(o + (32 * j + lane) * VEC, y);
    }
  }
}

// calls f(std::integral_constant<int, C>) for the C the kernel is built for
template <typename F>
cudaError_t with_features(int C, F&& f) {
  switch (C) {
#define LN_CASE(N) \
  case N * 128:    \
    return f(std::integral_constant<int, N * 128>{});
    LN_CASE(1) LN_CASE(2) LN_CASE(3) LN_CASE(4) LN_CASE(5) LN_CASE(6)
    LN_CASE(7) LN_CASE(8) LN_CASE(9) LN_CASE(10) LN_CASE(11) LN_CASE(12)
    LN_CASE(13) LN_CASE(14) LN_CASE(15) LN_CASE(16)
#undef LN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_ln(const T* x, const T* res, const float* scale, const float* bias, T* out,
                      int M, int C, int gelu, float eps, int blocks, cudaStream_t stream) {
  return with_features(C, [&](auto c) {
    constexpr int CC = decltype(c)::value;
    const size_t smem = LnShape<T, CC>::smem_bytes(res != nullptr);
    // a block may hold more than 48 KB of shared memory (the static
    // barriers included) only on request; the residual case's size covers
    // both cases, and is at most 128 KB (C = 2048, f32)
    constexpr size_t most = LnShape<T, CC>::smem_bytes(true);
    if constexpr (most + 1024 > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fused_ln_kernel<T, CC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
      if (e != cudaSuccess) return e;
    }
    fused_ln_kernel<T, CC><<<blocks, LN_THREADS, smem, stream>>>(x, res, scale, bias, out, M,
                                                                 gelu, eps);
    return cudaGetLastError();
  });
}

// ---- copy ------------------------------------------------------------------

// n16 16-byte vectors, one a thread, then `tail` bytes after them (block
// 0's threads).
__global__ void __launch_bounds__(COPY_THREADS)
copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, size_t n16,
            uint32_t tail) {
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    const size_t at = n16 * 16 + threadIdx.x;
    reinterpret_cast<unsigned char*>(dst)[at] = reinterpret_cast<const unsigned char*>(src)[at];
  }
  const size_t i = (size_t)blockIdx.x * COPY_THREADS + threadIdx.x;
  if (i < n16) __stcs(dst + i, __ldcs(src + i));
}

}  // namespace

extern "C" {

// x, res (may be null), out: (M, C) contiguous, 16-byte aligned; scale and
// bias: (C,) f32, 16-byte aligned, or both null. dtype: 0 = f32, 1 = bf16.
// blocks: the grid, from ops/fused_norm.py::ln_plan.
int fused_ln_fwd(const void* x, const void* res, const void* scale, const void* bias,
                 void* out, int M, int C, int dtype, int gelu, float eps, int blocks,
                 void* stream) {
  if (M <= 0) return 0;
  if (C <= 0 || C % 128 != 0 || C > 2048 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == 1)
    return (int)launch_ln(static_cast<const __nv_bfloat16*>(x),
                          static_cast<const __nv_bfloat16*>(res), sc, bi,
                          static_cast<__nv_bfloat16*>(out), M, C, gelu, eps, blocks, s);
  return (int)launch_ln(static_cast<const float*>(x), static_cast<const float*>(res), sc, bi,
                        static_cast<float*>(out), M, C, gelu, eps, blocks, s);
}

// Copies nbytes from src to dst (both 16-byte aligned).
int copy_rows(const void* src, void* dst, size_t nbytes, void* stream) {
  if (nbytes == 0) return 0;
  const size_t n16 = nbytes / 16;
  const size_t blocks = n16 == 0 ? 1 : (n16 + COPY_THREADS - 1) / COPY_THREADS;
  if (blocks > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  copy_kernel<<<(unsigned)blocks, COPY_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n16, (uint32_t)(nbytes % 16));
  return (int)cudaGetLastError();
}

}  // extern "C"
