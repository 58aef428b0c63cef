// Fused 1-D conv + channel LayerNorm + GELU for the wav2vec2-style conv
// front end, written by hand for Hopper (sm_90a). Bound to PyTorch through
// ctypes by ops/conv.py, whose conv_plan picks the path and the launch.
//
// Replaces the TPU kernels _kernel, _kernel_db and _kernel_mb of the JAX
// package's ops/conv.py (one body, _compute_tile, three DMA schedules),
// reached through fused_conv_ln_gelu / pallas_conv_stack:
//   acc[t] = sum_j x[t*s + j] @ W[j]          (VALID, stride s, no bias, f32)
//   y[t]   = GELU(LN(acc[t]) * scale + bias)  (two-pass f32 variance, eps 1e-5)
// GELU is erf-GELU through the JAX kernel's polynomial erf (Abramowitz-Stegun
// 7.1.26, |err| <= 1.5e-7), or tanh-GELU; y is stored in x's type.
// Layouts: x (B, L, C_in), W (k, C_in, C_out), out (B, T_out, C_out), all
// contiguous; scale and bias (C_out,) f32.
//
// The TPU design regroups x as (B, G, s*C) on the host because Mosaic has no
// strided slices. Here the stride is an index (row and FMA paths) or the
// traversal stride of a TMA map (tensor-core path): x is never copied.
//
// What bounds emotion2vec's front end on an H100 (B = 64 clips of 4 s, bf16):
// - layer 0 (C_in = 1, k = 10, s = 5, 512 channels, 12799 rows): 839 MB
//   written, 0.25 ms at 3.35 TB/s. Its LN and erf-GELU take about 20 f32
//   instructions an output element, and the conv 10 more as FMAs: about
//   0.38 ms of the CUDA cores' issue rate, so on this card the elementwise
//   work, not the bytes, is the floor. The row path moves the conv to the
//   tensor cores, keeps the LN in registers and writes each output byte
//   once, in 16-byte vectors.
// - layers 1-6 (512 -> 512, k = 3 or 2, s = 2): 1.25e12 FLOP, 1.26 ms at
//   989 TFLOP/s. About 511 FLOP per HBM byte against a ridge of 295:
//   operations, but only 1.7x above the ridge, and every block re-reads the
//   layer's weights from L2. The tensor-core path keeps TMA loads in flight
//   behind wgmma and reads the weights once per 64 output rows.
//
// Three paths:
// - conv_ln_gelu_tc (bf16, C_in % 64 == 0, C_out in {128, 256, 384, 512},
//   s <= 4: layers 1-6). A block owns a tile of 64 output rows of one batch
//   item across all C_out columns (the LN needs whole rows). Two consumer
//   warpgroups each hold 64 x C_out/2 f32 accumulators in registers (wgmma
//   m64n256k16 at C_out = 512: 128 registers a thread); one thread of a
//   third, producer warpgroup keeps a ring of stages full by TMA, and the
//   producer warpgroup gives its registers to the consumers (setmaxnreg:
//   40 and 232 a thread; at 384 threads ptxas caps a thread at 168
//   otherwise, and the epilogue spilled). A stage is one tap j and 64 input
//   channels: the A tile (64 rows x 64 channels, 8 KB; the x map steps over
//   input rows with a traversal stride of s, so the box at row t0*s + j
//   holds rows (t0 + r)*s + j, and rows past L arrive as zeros) and the B
//   tile (rows c0..c0+63 of W[j], every column, MN-major: C_out/64 atoms of
//   64 rows x 128 bytes, 64 KB at C_out = 512). 3 stages at C_out = 512 (216
//   KB), up to 8 at 128. A block thus reads the layer's weights once per 64
//   rows from L2 (24 KB a row; the WMMA design before it read 48 KB a row).
//   Per stage each warpgroup issues 4 wgmma (k16) on the shared A tile and
//   its half of B, keeps one group in flight, and gives the stage before
//   back to the producer through an empty barrier (an arrive per consumer
//   warp). The epilogue stays in registers: row sums, then sums of squared
//   deviations, by quad shuffles and one exchange between the warpgroups
//   through shared memory per pass; then the affine, the GELU and bf16
//   pairs, transposed across each quad by shuffles into 16-byte vectors and
//   stored straight to global memory (rows past T_out are not stored).
//   Blocks walk the tiles grid-stride; ops/conv.py launches one block an SM,
//   so the producer fills the next tile's stages during the epilogue. A
//   cluster of 2 blocks sharing each B tile by TMA multicast was built and
//   dropped: 43-62 % slower (PERF.md).
// - conv_ln_gelu_row (bf16, C_in = 1, C_out in {256, 512}, k <= 16: layer
//   0). A warp per 16 output rows, grid-stride. The taps are one mma.sync
//   m16n8k16 k-step: A holds the 16 rows' k input samples (loaded straight
//   from x, taps past k are 0), B the weights of 8 channels (fragments in
//   shared memory). Three passes over the C_out / 8 column tiles recompute
//   the product (the tensor cores are otherwise idle): row sums, sums of
//   squared deviations, then the affine and GELU, transposed across each
//   quad into 16-byte stores. Designs with the conv as f32 FMAs, a warp per
//   row with the weights in registers and 4 rows a warp with them in
//   shared memory, were slower (PERF.md).
// - conv_ln_gelu_fma (any C_in, any C_out, bf16 or f32): FMA loops in f32,
//   one thread per output channel over `rows` output rows held in
//   registers, the input window of the block in shared memory, the LN +
//   GELU from an f32 tile in shared memory. It serves the f32 variant,
//   which stays exact f32 (no TF32), and every shape the other paths do not
//   take.
// The bf16 paths take exp and reciprocals in the GELU at the hardware's
// approximate rates; their output is rounded to bf16, far coarser.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float LN_EPS = 1e-5f;
constexpr size_t MAX_SMEM = 232448;  // 227 KB: the most one block may use

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

__device__ __forceinline__ float ex2_approx(float x) {  // 2^x
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The same two GELUs at the hardware's approximate rates, for the bf16
// paths, on v = gelu_in() * y (the callers fold gelu_in() into the affine).
// erf-GELU takes v = y sqrt(log2 e / 2), so that z = y / sqrt(2) = v /
// sqrt(log2 e) and exp(-z^2) = 2^(-v^2); tanh-GELU is 0.5 y (1 + tanh(u)) =
// y / (1 + 2^(y (K1 + K2 y^2))) with v = y.
template <bool APPROX>
__host__ __device__ constexpr float gelu_in() {
  return APPROX ? 1.f : 0.8493218002880191f;
}

template <bool APPROX>
__device__ __forceinline__ float gelu_fast(float v) {
  if (APPROX) {
    // K1 = -2 sqrt(2 / pi) log2 e
    constexpr float K1 = -2.f * 0.7978845608028654f * 1.4426950408889634f;
    constexpr float K2 = K1 * 0.044715f;
    return v * rcp_approx(1.f + ex2_approx(v * fmaf(K2, v * v, K1)));
  }
  constexpr float P = 0.3275911f / 1.2011224087864498f;  // p / sqrt(log2 e)
  const float t = rcp_approx(fmaf(P, fabsf(v), 1.f));
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
       0.254829592f) * t;
  const float erf = copysignf(1.f - poly * ex2_approx(-v * v), v);
  const float h = v * (0.5f / gelu_in<false>());  // y / 2
  return fmaf(h, erf, h);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo: the lower 16 bits
  return *reinterpret_cast<const uint32_t*>(&p);
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
// PTX: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of the given parity to complete. A ring that never
// completes it (a fault in this file) traps after about 2 s of clocks, so
// the launch fails instead of holding the card.
constexpr long long WAIT_LIMIT = 1ll << 32;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > WAIT_LIMIT) __trap();
}

// one box of a 3-D map at (c0, c1, c2) into shared memory, completing on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the two consumer warpgroups (named barrier 1; the producer never joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// Shared-memory matrix descriptors of tiles written by TMA with the 128-byte
// swizzle (1024-byte aligned), 8-row groups of 128-byte rows 1024 bytes
// apart (stride byte offset):
// - K-major, 64 K a row (the A tile): the leading byte offset is not used;
// - MN-major, 64 N a row (the B tile): N spans several 64-column atoms of
//   64 K rows each, ATOM_BYTES apart (the leading byte offset).
constexpr int TC_ROWS = 64;                     // output rows a tile: one wgmma M
constexpr int K_STEP = 64;                      // input channels a stage: 128 bytes
constexpr int A_BYTES = TC_ROWS * K_STEP * 2;   // 8 KB
constexpr int ATOM_BYTES = K_STEP * 128;        // 64 K rows x 64 columns, 8 KB

__device__ __forceinline__ uint64_t desc_k_major(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(ATOM_BYTES >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int PENDING>  // waits until at most PENDING committed groups are in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(PENDING) : "memory");
}

// keep the compiler from moving accesses to the accumulators across the
// asynchronous wgmma that owns them
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B, m64nNk16: A K-major and B MN-major (transpose flag) in shared
// memory; acc != 0 adds to d, else overwrites it. A thread's element i =
// 4j + 2r + e sits at row 16 (warp % 4) + lane / 4 + 8r, column 8j + 2
// (lane % 4) + e.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t a, uint64_t b, int acc) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]),
        "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]),
        "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b, int acc) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]),
        "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]),
        "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc));
  }
};

// ---------------------------------------------------------------------------
// Tensor-core path (bf16): TMA ring + wgmma, LN + GELU on the accumulators
// ---------------------------------------------------------------------------
constexpr int CONSUMER_THREADS = 256;                // two warpgroups
constexpr int TC_THREADS = CONSUMER_THREADS + 128;   // + the producer warpgroup
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 <= 65,536
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int TC_MAX_STAGES = 8;
constexpr int TC_MAX_STRIDE = 4;  // a box spans at most 256 rows: 64 rows at stride <= 4

__host__ __device__ constexpr int stage_bytes(int c_out) {
  return A_BYTES + c_out / 64 * ATOM_BYTES;
}
// 1024 to align the base | the ring | affine pairs (float4 a 2 columns) |
// LN exchange (2 passes x 2 warpgroups x 64 rows, f32) | full, empty barriers
__host__ __device__ constexpr int tc_smem_bytes(int c_out, int stages) {
  return 1024 + stages * stage_bytes(c_out) + 8 * c_out + 1024 + 16 * stages;
}

// A quad's 4 x 4 words, transposed: lane q's v[p] becomes lane p's v[q], so
// lane q ends with the 4 pairs (8 columns) of group q, in column order.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    const bool hi = (q & m) != 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (p & m) continue;
      const uint32_t got = __shfl_xor_sync(0xffffffffu, hi ? v[p] : v[p | m], m);
      if (hi)
        v[p] = got;
      else
        v[p | m] = got;
    }
  }
}

// LN + affine + GELU of a warpgroup's 64 x N accumulators (N = C_out / 2
// columns from column wg * N), stored as bf16 to o (the tile's first row,
// column wg * N; rows >= `rows` are not stored). aff: the float4 pairs
// (scale[c], scale[c + 1], bias[c], bias[c + 1]) of the warpgroup's columns,
// times gelu_in().
template <int N, bool APPROX>
__device__ __forceinline__ void tc_epilogue(float (&acc)[N / 2], const float4* aff, float* red,
                                            int wg, int lane, int row0,
                                            __nv_bfloat16* __restrict__ o, int rows) {
  constexpr int J = N / 8;  // 8-column groups
  constexpr float INV_C = 1.f / (2 * N);
  const int q = lane & 3;
  float mean[2], inv[2];  // acc becomes acc - mean in the second pass
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) sum += acc[4 * j + 2 * r] + acc[4 * j + 2 * r + 1];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (q == 0) red[wg * 64 + row0 + 8 * r] = sum;
  }
  consumers_sync();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mean[r] = (red[row0 + 8 * r] + red[64 + row0 + 8 * r]) * INV_C;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      acc[4 * j + 2 * r] -= mean[r];
      acc[4 * j + 2 * r + 1] -= mean[r];
      sq = fmaf(acc[4 * j + 2 * r], acc[4 * j + 2 * r],
                fmaf(acc[4 * j + 2 * r + 1], acc[4 * j + 2 * r + 1], sq));
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    if (q == 0) red[128 + wg * 64 + row0 + 8 * r] = sq;
  }
  consumers_sync();
#pragma unroll
  for (int r = 0; r < 2; ++r)
    inv[r] = rsqrtf((red[128 + row0 + 8 * r] + red[192 + row0 + 8 * r]) * INV_C + LN_EPS);

#pragma unroll
  for (int jj = 0; jj < J / 4; ++jj) {
    uint32_t v[2][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int j = 4 * jj + p;
      const float4 a = aff[4 * j + q];  // columns 8j + 2q, 8j + 2q + 1
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        v[r][p] = pack_bf16(gelu_fast<APPROX>(acc[4 * j + 2 * r] * inv[r] * a.x + a.z),
                            gelu_fast<APPROX>(acc[4 * j + 2 * r + 1] * inv[r] * a.y + a.w));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      quad_transpose(v[r], q);
      const int row = row0 + 8 * r;
      if (row < rows)
        *reinterpret_cast<uint4*>(o + (size_t)row * (2 * N) + 8 * (4 * jj + q)) =
            make_uint4(v[r][0], v[r][1], v[r][2], v[r][3]);
    }
  }
}

// The producer: one thread fills stage `it` of the ring (tap j, channels
// c*64.. of the tile's rows) once the consumers have given it back.
template <int C_OUT>
__device__ __forceinline__ void produce(const CUtensorMap* tx, const CUtensorMap* tw,
                                        unsigned char* ring, uint64_t* full, uint64_t* empty,
                                        int tiles_per_item, int tiles, int n_c, int k, int s,
                                        int stages) {
  constexpr int STAGE = stage_bytes(C_OUT);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_item;
    const int t0 = (tile - b * tiles_per_item) * TC_ROWS;
    for (int j = 0; j < k; ++j)
      for (int c = 0; c < n_c; ++c, ++it) {
        const int st = it % stages, use = it / stages;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        unsigned char* a = ring + (size_t)st * STAGE;
        mbar_expect_tx(&full[st], STAGE);
        tma_load_3d(a, tx, &full[st], c * K_STEP, t0 * s + j, b);
#pragma unroll 1  // the producer runs on PRODUCER_REGS registers
        for (int n = 0; n < C_OUT / 64; ++n)
          tma_load_3d(a + A_BYTES + n * ATOM_BYTES, tw, &full[st], n * 64, c * K_STEP, j);
      }
  }
}

// The consumer warpgroups' loop over the block's tiles: per stage, 4 wgmma
// on the stage's A tile and this warpgroup's half of B; then the epilogue.
template <int C_OUT, bool APPROX>
__device__ __forceinline__ void consume(unsigned char* ring, const float4* affine, float* red,
                                        uint64_t* full, uint64_t* empty,
                                        __nv_bfloat16* __restrict__ out, int T_out,
                                        int tiles_per_item, int tiles, int n_k, int stages) {
  constexpr int N = C_OUT / 2;  // columns a consumer warpgroup
  constexpr int STAGE = stage_bytes(C_OUT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int row0 = 16 * (warp & 3) + (lane >> 2);  // this thread's rows row0, row0 + 8
  const uint32_t ring_addr = smem_u32(ring);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_item;
    const int t0 = (tile - b * tiles_per_item) * TC_ROWS;
    for (int i = 0; i < n_k; ++i, ++it) {
      const int st = it % stages;
      mbar_wait(&full[st], (it / stages) & 1);
      const uint32_t a = ring_addr + st * STAGE;
      const uint64_t da = desc_k_major(a);
      const uint64_t db = desc_mn_major(a + A_BYTES + wg * (N / 64) * ATOM_BYTES);
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < K_STEP / 16; ++kk)  // 32 bytes of A, 16 rows (2 KB) of B
        Wgmma<N>::mma(acc, da + 2 * kk, db + 128 * kk, (i | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();  // the stage before is read: give it back
      pin(acc);
      if (i > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
    }
    wgmma_wait<0>();
    pin(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
    tc_epilogue<N, APPROX>(acc, affine + wg * (N / 2), red, wg, lane, row0,
                           out + ((size_t)b * T_out + t0) * C_OUT + wg * N, T_out - t0);
  }
}

template <int C_OUT, bool APPROX>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv_tc_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
               const float* __restrict__ scale, const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ out, int T_out, int tiles_per_item, int tiles,
               int n_c, int k, int s, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float4* affine = reinterpret_cast<float4*>(ring + (size_t)stages * stage_bytes(C_OUT));
  float* red = reinterpret_cast<float*>(affine + C_OUT / 2);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 256);
  uint64_t* empty = full + stages;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);                         // the producer's expect_tx arrive
      mbar_init(&empty[i], CONSUMER_THREADS / 32);    // an arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  constexpr float G = gelu_in<APPROX>();
  for (int c = threadIdx.x; c < C_OUT / 2; c += TC_THREADS)
    affine[c] = make_float4(G * scale[2 * c], G * scale[2 * c + 1], G * bias[2 * c],
                            G * bias[2 * c + 1]);
  __syncthreads();

  // One branch per role, never rejoined, so that ptxas sees each role's
  // register budget (the producer warpgroup gives its registers away).
  if (threadIdx.x >= CONSUMER_THREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMER_THREADS)
      produce<C_OUT>(&tx, &tw, ring, full, empty, tiles_per_item, tiles, n_c, k, s, stages);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    consume<C_OUT, APPROX>(ring, affine, red, full, empty, out, T_out, tiles_per_item, tiles,
                           k * n_c, stages);
  }
}

// ---------------------------------------------------------------------------
// Row path (bf16, C_in = 1): a warp per 16 output rows, the taps on the
// tensor cores (mma.sync m16n8k16, K = the k <= 16 taps), LN in registers
// ---------------------------------------------------------------------------
constexpr int ROW_WARPS = 8;
constexpr int ROW_MAX_K = 16;  // one k16 step
constexpr int ROW_M = 16;      // output rows a warp computes together: one mma M

// d = A B (f32), A 16 x 16 bf16 row-major, B 16 x 8 bf16 column-major, in
// registers. A thread's a[h] holds row lane/4 + 8h, columns 2q, 2q + 1 (q =
// lane % 4) and a[2 + h] columns 2q + 8, 2q + 9; b.x rows 2q, 2q + 1 and b.y
// rows 2q + 8, 2q + 9 of column lane/4; d[2h + e] row lane/4 + 8h, column
// 2q + e.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y), "f"(0.f));
}

template <int C_OUT, bool APPROX>
__global__ void __launch_bounds__(ROW_WARPS * 32)
conv_row_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ scale, const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, int L, int T_out, int rows, int k, int s) {
  constexpr int NT = C_OUT / 8;  // 8-column tiles
  __shared__ uint2 wb[NT][32];          // lane's B fragment of column tile n (taps >= k: 0)
  __shared__ float4 aff[C_OUT / 2];     // (scale, scale, bias, bias) of column pairs, x gelu_in
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const unsigned short* ws = reinterpret_cast<const unsigned short*>(w);
  for (int i = threadIdx.x; i < NT * 32; i += ROW_WARPS * 32) {
    const int l = i % 32, q = l % 4, col = 8 * (i / 32) + l / 4;
    auto tap = [&](int j) -> uint32_t { return j < k ? ws[(size_t)j * C_OUT + col] : 0u; };
    wb[i / 32][l] = make_uint2(tap(2 * q) | tap(2 * q + 1) << 16,
                               tap(2 * q + 8) | tap(2 * q + 9) << 16);
  }
  constexpr float G = gelu_in<APPROX>();
  for (int c = threadIdx.x; c < C_OUT / 2; c += ROW_WARPS * 32)
    aff[c] = make_float4(G * scale[2 * c], G * scale[2 * c + 1], G * bias[2 * c],
                         G * bias[2 * c + 1]);
  __syncthreads();

  const int lane = threadIdx.x & 31, q = lane & 3;
  const int tiles = (rows + ROW_M - 1) / ROW_M;
  for (int tile = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5); tile < tiles;
       tile += gridDim.x * ROW_WARPS) {
    // this thread's rows g[h] = 16 tile + lane / 4 + 8h and their input taps
    int g[2];
    uint32_t a[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      g[h] = tile * ROW_M + (lane >> 2) + 8 * h;
      const int b = g[h] / T_out, t = g[h] - b * T_out;
      const unsigned short* xr = xs + (size_t)b * L + (size_t)t * s;
      auto tap = [&](int j) -> uint32_t { return g[h] < rows && j < k ? xr[j] : 0u; };
      a[h] = tap(2 * q) | tap(2 * q + 1) << 16;
      a[2 + h] = tap(2 * q + 8) | tap(2 * q + 9) << 16;
    }
    // Three passes over the column tiles, the product recomputed in each
    // (the tensor cores idle otherwise): row sums, sums of squared
    // deviations (two-pass LN), then the output.
    float mean[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
#pragma unroll 8
    for (int n = 0; n < NT; ++n) {
      float d[4];
      mma_16816(d, a, wb[n][lane]);
      mean[0] += d[0] + d[1];
      mean[1] += d[2] + d[3];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] += __shfl_xor_sync(0xffffffffu, mean[h], 1);
      mean[h] += __shfl_xor_sync(0xffffffffu, mean[h], 2);
      mean[h] *= 1.f / C_OUT;
    }
#pragma unroll 8
    for (int n = 0; n < NT; ++n) {
      float d[4];
      mma_16816(d, a, wb[n][lane]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dv = d[e] - mean[e / 2];
        inv[e / 2] = fmaf(dv, dv, inv[e / 2]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      inv[h] += __shfl_xor_sync(0xffffffffu, inv[h], 1);
      inv[h] += __shfl_xor_sync(0xffffffffu, inv[h], 2);
      inv[h] = rsqrtf(inv[h] * (1.f / C_OUT) + LN_EPS);
    }
#pragma unroll 2
    for (int n4 = 0; n4 < NT / 4; ++n4) {
      uint32_t v[2][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int n = 4 * n4 + p;
        float d[4];
        mma_16816(d, a, wb[n][lane]);
        const float4 af = aff[4 * n + q];  // columns 8n + 2q, 8n + 2q + 1
#pragma unroll
        for (int h = 0; h < 2; ++h)
          v[h][p] = pack_bf16(
              gelu_fast<APPROX>((d[2 * h] - mean[h]) * inv[h] * af.x + af.z),
              gelu_fast<APPROX>((d[2 * h + 1] - mean[h]) * inv[h] * af.y + af.w));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        quad_transpose(v[h], q);  // lane q: columns 8 (4 n4 + q) .. + 7
        if (g[h] < rows)
          *reinterpret_cast<uint4*>(out + (size_t)g[h] * C_OUT + 8 * (4 * n4 + q)) =
              make_uint4(v[h][0], v[h][1], v[h][2], v[h][3]);
      }
    }
  }
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
                       int smem, cudaStream_t stream) {
  if ((size_t)smem != fma_smem_bytes<TR>(C_in, C_out, k, s) || (size_t)smem > MAX_SMEM)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv_fma_kernel<T, TR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_out + TR - 1) / TR, B);
  conv_fma_kernel<T, TR><<<grid, THREADS, smem, stream>>>(x, w, scale, bias, out, L, C_in,
                                                          C_out, T_out, k, s, approx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fma(const T* x, const T* w, const float* scale, const float* bias,
                         T* out, int B, int L, int C_in, int C_out, int T_out, int k, int s,
                         int approx, int rows, int smem, cudaStream_t stream) {
  switch (rows) {
    case 32: return launch_fma<T, 32>(x, w, scale, bias, out, B, L, C_in, C_out, T_out, k, s,
                                      approx, smem, stream);
    case 8: return launch_fma<T, 8>(x, w, scale, bias, out, B, L, C_in, C_out, T_out, k, s,
                                    approx, smem, stream);
    case 1: return launch_fma<T, 1>(x, w, scale, bias, out, B, L, C_in, C_out, T_out, k, s,
                                    approx, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and launches
// ---------------------------------------------------------------------------

// Codes the entry points return besides cudaError_t values (all > 0).
constexpr int ERR_NO_ENCODER = -1;     // libcuda has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE_BASE = -1000; // -1000 - CUresult: the encoder refused a map

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, looked up through the runtime, so that the
// library needs no link against libcuda.
EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D bf16 map (d0, d1, d2) with byte strides (s1, s2), boxes of (b0, b1,
// 1) with traversal stride `step` on dimension 1, 128-byte swizzle; elements
// past the map read as 0.
int encode(EncodeTiledFn fn, CUtensorMap* map, const void* base, int d0, int d1, int d2,
           long long s1, long long s2, int b0, int b1, int step) {
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1, (cuuint64_t)s2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t steps[3] = {1, (cuuint32_t)step, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE_BASE - (int)r;
}

// Lets `kernel` take the largest dynamic shared memory, once per device
// (bit d of `done`: device d).
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, std::atomic<uint64_t>& done) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (bit != 0 && (done.load(std::memory_order_relaxed) & bit) != 0) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

template <int C_OUT, bool APPROX>
int launch_tc(const CUtensorMap& tx, const CUtensorMap& tw, const float* scale,
              const float* bias, __nv_bfloat16* out, int T_out, int B, int n_c, int k, int s,
              int stages, int smem, int grid, cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  const cudaError_t e = allow_max_smem(conv_tc_kernel<C_OUT, APPROX>, done);
  if (e != cudaSuccess) return (int)e;
  const int tiles_per_item = (T_out + TC_ROWS - 1) / TC_ROWS;
  conv_tc_kernel<C_OUT, APPROX><<<grid, TC_THREADS, smem, stream>>>(
      tx, tw, scale, bias, out, T_out, tiles_per_item, B * tiles_per_item, n_c, k, s, stages);
  return (int)cudaGetLastError();
}

template <int C_OUT, bool APPROX>
int launch_row(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* scale,
               const float* bias, __nv_bfloat16* out, int L, int T_out, int rows, int k, int s,
               int grid, cudaStream_t stream) {
  conv_row_kernel<C_OUT, APPROX><<<grid, ROW_WARPS * 32, 0, stream>>>(x, w, scale, bias, out,
                                                                      L, T_out, rows, k, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Entry points: 0, a cudaError_t, or one of the ERR_ codes above. ops/conv.py
// checks the tensors (contiguous, 16-byte aligned, 0 < s <= k <= L) and
// passes its plan (conv_plan); a plan the kernel cannot take returns
// cudaErrorInvalidValue.

// bf16 x (B, L, C_in), w (k, C_in, C_out); C_in % 64 == 0, C_out in {128,
// 256, 384, 512}, s <= 4; stages and smem as tc_smem_bytes; any grid >= 1.
int conv_ln_gelu_tc(const void* x, const void* w, const void* scale, const void* bias,
                    void* out, int B, int L, int C_in, int C_out, int k, int s, int approx,
                    int stages, int smem, int grid, void* stream) {
  const int T_out = (L - k) / s + 1;
  if (B <= 0 || L < k || T_out <= 0) return 0;
  if (C_in % K_STEP != 0 || s < 1 || s > TC_MAX_STRIDE || k < s || stages < 2 ||
      stages > TC_MAX_STAGES || grid < 1 ||
      (C_out != 128 && C_out != 256 && C_out != 384 && C_out != 512) ||
      smem != tc_smem_bytes(C_out, stages) || (size_t)smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  CUtensorMap tx, tw;
  int err;
  // x as (C_in, L, B): 64 channels x the 64 rows t0*s + j + r*s of one item
  if ((err = encode(fn, &tx, x, C_in, L, B, (long long)C_in * 2, (long long)L * C_in * 2,
                    K_STEP, TC_ROWS * s, s)) != 0)
    return err;
  // W as (C_out, C_in, k): 64 columns x 64 channels of one tap
  if ((err = encode(fn, &tw, w, C_out, C_in, k, (long long)C_out * 2,
                    (long long)C_in * C_out * 2, 64, K_STEP, 1)) != 0)
    return err;
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_c = C_in / K_STEP;
#define CONV_TC(C, A) launch_tc<C, A>(tx, tw, sc, bi, o, T_out, B, n_c, k, s, stages, smem, grid, st)
  switch (C_out * 2 + (approx != 0)) {
    case 256: return CONV_TC(128, false);
    case 257: return CONV_TC(128, true);
    case 512: return CONV_TC(256, false);
    case 513: return CONV_TC(256, true);
    case 768: return CONV_TC(384, false);
    case 769: return CONV_TC(384, true);
    case 1024: return CONV_TC(512, false);
    default: return CONV_TC(512, true);
  }
#undef CONV_TC
}

// bf16 x (B, L, 1), w (k, 1, C_out); C_out in {256, 512}, k <= 16; any grid >= 1.
int conv_ln_gelu_row(const void* x, const void* w, const void* scale, const void* bias,
                     void* out, int B, int L, int C_in, int C_out, int k, int s, int approx,
                     int grid, void* stream) {
  const int T_out = (L - k) / s + 1;
  if (B <= 0 || L < k || T_out <= 0) return 0;
  if (C_in != 1 || k > ROW_MAX_K || grid < 1 || (long long)B * T_out > 0x7fffffffll ||
      (C_out != 256 && C_out != 512))
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * T_out;
  if (C_out == 256)
    return approx ? launch_row<256, true>(xb, wb, sc, bi, o, L, T_out, rows, k, s, grid, st)
                  : launch_row<256, false>(xb, wb, sc, bi, o, L, T_out, rows, k, s, grid, st);
  return approx ? launch_row<512, true>(xb, wb, sc, bi, o, L, T_out, rows, k, s, grid, st)
                : launch_row<512, false>(xb, wb, sc, bi, o, L, T_out, rows, k, s, grid, st);
}

// Any C_in / C_out; dtype 0 = f32, 1 = bf16; rows in {32, 8, 1} output rows
// a block, smem its window and tile (fma_smem_bytes).
int conv_ln_gelu_fma(const void* x, const void* w, const void* scale, const void* bias,
                     void* out, int B, int L, int C_in, int C_out, int k, int s, int approx,
                     int dtype, int rows, int smem, void* stream) {
  const int T_out = (L - k) / s + 1;
  if (B <= 0 || L < k || T_out <= 0) return 0;
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch_fma(static_cast<const __nv_bfloat16*>(x),
                             static_cast<const __nv_bfloat16*>(w), sc, bi,
                             static_cast<__nv_bfloat16*>(out), B, L, C_in, C_out, T_out, k, s,
                             approx, rows, smem, st);
  return (int)dispatch_fma(static_cast<const float*>(x), static_cast<const float*>(w), sc, bi,
                           static_cast<float*>(out), B, L, C_in, C_out, T_out, k, s, approx,
                           rows, smem, st);
}

}  // extern "C"
