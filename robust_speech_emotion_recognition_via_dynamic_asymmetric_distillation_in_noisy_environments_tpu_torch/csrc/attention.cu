// Attention forward for the emotion2vec encoder, written by hand for Hopper
// (sm_90a). Bound to PyTorch through ctypes by ops/attention.py.
//
// Replaces the TPU kernel ops/attention.py:_attn_kernel of the JAX package:
//   out = softmax(q k^T + mask * (-0.7 * FLT_MAX)) v
// per (batch, head), q pre-scaled by 1/sqrt(D), scores and softmax in f32,
// p cast to v's type before the PV product, f32 accumulation. Forward only.
// Layout (B, H, N, D) contiguous, D = 64; mask (B, N) bytes, 1 = padded key.
//
// Why not the TPU design: the TPU kernel keeps all of K and V for one
// (b, h) in VMEM. At the 30 s serving bucket (N = 1499, bf16) that is
// 2 * 1499 * 64 * 2 B = 384 KB, more than the 227 KB of shared memory a
// block may use on an H100. So K/V stream through shared memory in tiles of
// 64 keys with an online softmax (running max and sum in f32).
//
// Masking: a padded key gets s + mask * NEG exactly as on the TPU, so a
// valid row's result is the same; keys past N are excluded (-inf). A key
// tile whose keys are all padded is skipped: it adds exactly 0 to any row
// that has a valid key, and every row of a batch item sees the same keys.
// A batch item whose keys are all padded (the serving path's filler rows)
// thus skips every tile and is written as 0, finite, where the TPU kernel
// writes the mean of v; callers read valid rows only.
//
// What bounds it at the serving shapes (B = 16, H = 12, N = 1499, D = 64):
// 4 * B * H * N^2 * D = 1.1e11 FLOP is 0.11 ms at 989 TFLOP/s bf16 dense;
// q/k/v/o are 147 MB, 0.044 ms at 3.35 TB/s. So it is compute-bound. This
// first version is simple: WMMA bf16 16x16x16 tiles (mma.sync underneath)
// for both products, the softmax through shared memory, no TMA, no wgmma,
// no warp specialisation. The f32 variant (checks, f32 configs) uses FMA
// loops, one query row per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 64;                            // head dim
constexpr float NEG = -0.7f * 3.402823466e38f;  // JAX: -0.7 * f32 max

// Key flag in shared memory: 0 = valid key, 1 = padded key (s + NEG),
// -1 = past N (excluded).
__device__ __forceinline__ float key_flag(const uint8_t* mrow, int j, int N) {
  if (j >= N) return -1.f;
  return (mrow != nullptr && mrow[j]) ? 1.f : 0.f;
}

// ---------------------------------------------------------------------------
// bf16: 4 warps, 64 query rows per block (16 per warp), 64 keys per tile.
// ---------------------------------------------------------------------------
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LDH = D + 8;   // bf16 row stride: skews banks, keeps 32 B fragment alignment
constexpr int LDS = BK + 4;  // f32 row stride of the score / PV scratch

struct SmemBf16 {
  __nv_bfloat16 q[BQ * LDH];
  __nv_bfloat16 k[BK * LDH];
  __nv_bfloat16 v[BK * LDH];
  __nv_bfloat16 p[WARPS][16 * LDH];  // probabilities, 16 rows x 64 keys per warp
  float s[WARPS][16 * LDS];          // scores, then the tile's PV product
  float flag[BK];
};

// Copies a (rows x 64) bf16 tile starting at row r0 of a contiguous (N, 64)
// slab into shared memory with row stride LDH; rows past N are zero.
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int r0, int rows, int N) {
  for (int c = threadIdx.x; c < rows * (D / 8); c += THREADS) {
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + col);
    *reinterpret_cast<uint4*>(dst + r * LDH + col) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
attn_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const uint8_t* __restrict__ mask,
                     __nv_bfloat16* __restrict__ o, int H, int N) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemBf16& sm = *reinterpret_cast<SmemBf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t slab = ((size_t)b * H + h) * (size_t)N * D;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)b * N : nullptr;

  load_tile_bf16(sm.q, q + slab, q0, BQ, N);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], &sm.q[warp * 16 * LDH + kk * 16], LDH);

  // Each lane owns half a row of its warp's 16 rows: row r, columns c0..c0+31
  // of the score tile and of the output (BK == D).
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  float m_run = -INFINITY, l_run = 0.f;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  float* sw = sm.s[warp];
  __nv_bfloat16* pw = sm.p[warp];

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    int valid = 0;
    if (tid < BK) {
      const float f = key_flag(mrow, k0 + tid, N);
      sm.flag[tid] = f;
      valid = f == 0.f;
    }
    if (!__syncthreads_or(valid)) continue;  // every key of the tile is padded
    load_tile_bf16(sm.k, k + slab, k0, BK, N);
    load_tile_bf16(sm.v, v + slab, k0, BK, N);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, &sm.k[n * 16 * LDH + kk * 16], LDH);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(&sw[n * 16], sf, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the tile; the two lanes of a row combine by shuffle
    float sv[32];
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float f = sm.flag[c0 + i];
      const float x = f < 0.f ? -INFINITY : sw[r * LDS + c0 + i] + f * NEG;
      sv[i] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_run, tmax);  // finite: the tile has a key < N
    const float alpha = __expf(m_run - m_new);
    float tsum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = __expf(sv[i] - m_new);
      tsum += p;
      pw[r * LDH + c0 + i] = __float2bfloat16(p);
    }
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
    l_run = l_run * alpha + tsum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha;
    __syncwarp();

    // O_tile = P V (bf16 p, f32 accumulation), through the score scratch
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wmma::load_matrix_sync(pf[kk], &pw[kk * 16], LDH);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, &sm.v[kk * 16 * LDH + n * 16], LDH);
        wmma::mma_sync(of, pf[kk], vf, of);
      }
      wmma::store_matrix_sync(&sw[n * 16], of, LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += sw[r * LDS + c0 + i];
    __syncwarp();
  }

  const int row = q0 + warp * 16 + r;
  if (row < N) {
    const float inv = l_run > 0.f ? 1.f / l_run : 0.f;  // 0: every key padded
    __nv_bfloat16* dst = o + slab + (size_t)row * D + c0;
#pragma unroll
    for (int i = 0; i < 32; i += 8) {
      __align__(16) __nv_bfloat16 pack[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) pack[j] = __float2bfloat16(acc[i + j] * inv);
      *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(pack);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA loops, one query row per thread, 64 rows per block, 32-key tiles.
// ---------------------------------------------------------------------------
constexpr int F_BQ = 64;
constexpr int F_BK = 32;

__global__ void __launch_bounds__(F_BQ)
attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const uint8_t* __restrict__ mask, float* __restrict__ o,
                    int H, int N) {
  __shared__ __align__(16) float ks[F_BK][D];
  __shared__ __align__(16) float vs[F_BK][D];
  __shared__ float flag[F_BK];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * F_BQ + tid;
  const size_t slab = ((size_t)b * H + h) * (size_t)N * D;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)b * N : nullptr;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < N) x = *reinterpret_cast<const float4*>(q + slab + (size_t)row * D + d);
    qr[d] = x.x; qr[d + 1] = x.y; qr[d + 2] = x.z; qr[d + 3] = x.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;

  for (int k0 = 0; k0 < N; k0 += F_BK) {
    __syncthreads();
    int valid = 0;
    if (tid < F_BK) {
      const float f = key_flag(mrow, k0 + tid, N);
      flag[tid] = f;
      valid = f == 0.f;
    }
    if (!__syncthreads_or(valid)) continue;
    for (int c = tid; c < F_BK * (D / 4); c += F_BQ) {
      const int r = c / (D / 4), col = (c % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < N) {
        kx = *reinterpret_cast<const float4*>(k + slab + (size_t)(k0 + r) * D + col);
        vx = *reinterpret_cast<const float4*>(v + slab + (size_t)(k0 + r) * D + col);
      }
      *reinterpret_cast<float4*>(&ks[r][col]) = kx;
      *reinterpret_cast<float4*>(&vs[r][col]) = vx;
    }
    __syncthreads();

    float s[F_BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < F_BK; ++j) {
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) x = fmaf(qr[d], ks[j][d], x);
      const float f = flag[j];
      x = f < 0.f ? -INFINITY : x + f * NEG;
      s[j] = x;
      tmax = fmaxf(tmax, x);
    }
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);
    float tsum = 0.f;
#pragma unroll
    for (int j = 0; j < F_BK; ++j) {
      s[j] = expf(s[j] - m_new);
      tsum += s[j];
    }
    l_run = l_run * alpha + tsum;
    m_run = m_new;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < F_BK; ++j) {
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(s[j], vs[j][d], acc[d]);
    }
  }

  if (row < N) {
    const float inv = l_run > 0.f ? 1.f / l_run : 0.f;
    float* dst = o + slab + (size_t)row * D;
#pragma unroll
    for (int d = 0; d < D; d += 4)
      *reinterpret_cast<float4*>(dst + d) =
          make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
  }
}

}  // namespace

// C entry points: launch on `stream`, return cudaGetLastError() (0 = ok).
extern "C" int attn_fwd_bf16(const void* q, const void* k, const void* v,
                             const void* mask, void* o, int B, int H, int N,
                             void* stream) {
  const int smem = (int)sizeof(SmemBf16);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BQ - 1) / BQ, H, B);
  attn_fwd_bf16_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const uint8_t*)mask, (__nv_bfloat16*)o, H, N);
  return (int)cudaGetLastError();
}

extern "C" int attn_fwd_f32(const void* q, const void* k, const void* v,
                            const void* mask, void* o, int B, int H, int N,
                            void* stream) {
  const dim3 grid((N + F_BQ - 1) / F_BQ, H, B);
  attn_fwd_f32_kernel<<<grid, F_BQ, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const uint8_t*)mask, (float*)o, H, N);
  return (int)cudaGetLastError();
}
