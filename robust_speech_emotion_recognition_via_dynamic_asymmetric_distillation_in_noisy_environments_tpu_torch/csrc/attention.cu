// Attention forward for the emotion2vec encoder, written by hand for Hopper
// (sm_90a). Bound to PyTorch through ctypes by ops/attention.py.
//
// Replaces the TPU kernel ops/attention.py:_attn_kernel of the JAX package:
//   out = softmax(scale * q k^T + mask * (-0.7 * FLT_MAX)) v
// per (batch, head), scores and softmax in f32, p cast to v's type before
// the PV product, f32 accumulation, output in q's type. Forward only, D = 64.
// The JAX function takes q pre-scaled (scale = 1 here); the encoder passes
// the unscaled q and scale = 64^-0.5 = 0.125. The f32 kernel scales q in
// registers, as the JAX encoder does; the bf16 kernel scales the f32 scores,
// which for a power of two gives the same bits as scaling q first.
//
// Operands are (B, H, N, 64) views with unit last stride and any other
// strides that are multiples of 8 elements (ops/attention.py checks them):
// the encoder's q, k, v are read in place from its (B, N, 3, H, 64)
// projection output, and the output is written through its strides (the
// wrapper allocates a (B, N, H, 64) buffer), so no copy surrounds the call.
// mask: (B, N) bytes, 1 = padded key.
//
// Masking: a padded key gets s + NEG exactly as on the TPU, so a valid row's
// result is the same; keys past N are excluded (-inf). A key tile whose keys
// are all padded is skipped: it adds exactly 0 to any row that has a valid
// key, and every row of a batch item sees the same keys. A batch item whose
// keys are all padded (the serving path's filler rows) thus skips every tile
// and is written as 0, finite, where the TPU kernel writes the mean of v;
// callers read valid rows only.
//
// What bounds it on an H100 (bf16, H = 12), counting each query against its
// item's valid keys:
// - the fused step, B = 64, N = 199: q, k, v, out are 78 MB, 0.023 ms at
//   3.35 TB/s; the products are 7.8 GFLOP, 0.008 ms at 989 TFLOP/s. Bytes.
// - serving's 30 s bucket, B = 16, N = 1499: 147 MB, 0.044 ms; up to 1.1e11
//   FLOP, 0.11 ms. Operations; and at D = 64 a 64 x 64 score tile costs as
//   many exponentials (16 a clock an SM) as tensor-core clocks.
// The TPU kernel keeps one (b, h)'s K and V in VMEM; at N = 1499 they are
// 384 KB, more than a block's 227 KB of shared memory, so here they stream.
//
// The bf16 design, one warpgroup (128 threads, 64 query rows) a block,
// q-blocks innermost in the grid so that the blocks of one (b, h) run
// together and find its K and V in L2:
// - TMA: one 4-D tensor map each for q, k and v (64 d x N x H x B, their own
//   strides, 128-byte swizzle), encoded per call on the host and passed as
//   __grid_constant__ parameters. A box is 64 rows x 64 d of one (b, h);
//   rows past N are zero-filled by the copy, so the ragged tile needs no
//   special load.
// - Warp 0 reads the item's mask once and walks only the key tiles with a
//   valid key (tiles whose keys are all padded are neither loaded nor
//   computed). Its lane 0 issues the copies into two rings, K (2 slots) and
//   V (3 slots), completing on mbarriers, two tiles ahead of the one being
//   computed: a slot is refilled as soon as the wgmma that read it is seen
//   complete, so no other barrier is needed.
// - Per key tile i: S_i = Q K_i^T (wgmma m64n64k16, both operands K-major
//   in shared memory) and O += P_{i-1} V_{i-1} (wgmma with P from registers
//   as the A operand, V MN-major in shared memory through the transpose
//   flag) are issued together; the online softmax of S_i runs on the
//   accumulator fragment in registers while the PV product runs (row max
//   across the 4 threads of a quad by shuffles, exp2 with the scale folded
//   into one FFMA, the row sum kept per thread and reduced at the end); O is
//   rescaled by exp(m_old - m_new) in registers once that product is done,
//   and P is rounded to bf16 into the A fragments of the next product (the
//   f32 accumulator layout of a 16-column slice is the A layout of a
//   k-slice). Nothing of S, P or O goes through shared memory.
// - The end: O / l (0 where l = 0), stored from registers as bf16 pairs
//   through the output's strides.
// Designs built and measured against this one (PERF.md): a producer warp
// beside 1, 2 or 3 consumer warpgroups with a 4-stage ring, and two
// warpgroups a block sharing each K/V tile. All were slower at the fused
// step's shape; at N = 1499 the producer warp beside one warpgroup was up
// to 8 % faster, the others slower.
// The f32 variant (checks, f32 configurations) is the first port's FMA
// design: one query row per thread, 32-key tiles through shared memory.
//
// The biased variant (attn_fwd_relbias_*: WavLM's gated relative position
// bias; no TPU kernel, the JAX package has no such model) adds
//   bias[b, h, q, k] = gate[b, h, q] * table[h, k - q + N - 1]
// to the scaled scores before the row max: table is (H, 2N - 1) f32, gate
// (B, H, N) f32 through its own strides. The bias factors into a row's gate
// and a slice of one head's table, so nothing N x N is read or written. A
// 64 x 64 score tile needs 127 entries of table[h]; a thread reads its 18
// through the read-only cache (L1 and L2: a head's table is 12 KB at
// N = 1499) and adds gate * entry to the score in registers, one FMA and one
// multiply an element, beside the exponential that bounds the tile. Masking
// and tile skipping are the unbiased kernel's. Both variants are one body
// The bf16 variant is a copy of the unbiased kernel's body with those lines
// added, under its own __global__ name, so that a device trace tells the two
// apart and the unbiased kernel compiles to the code it had before (its
// SASS, checked with cuobjdump); the f32 variant is one body, a template on
// BIAS, under two names.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int D = 64;                            // head dim
constexpr float NEG = -0.7f * 3.402823466e38f;  // JAX: -0.7 * f32 max

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

// one box of the 4-D map at (d, n, h, b) into shared memory, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int n, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(n), "r"(h), "r"(b)
      : "memory");
}

// Shared-memory matrix descriptor of a tile of rows of 128 bytes written by
// TMA with the 128-byte swizzle (tile 1024-byte aligned): 8-row groups 1024
// bytes apart (stride byte offset); the leading byte offset is not used by
// these shapes (K-major with K = 64 bf16, or MN-major with N = 64).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
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

// keep the compiler from moving accesses to a wgmma operand (accumulator,
// or A fragment) across the asynchronous wgmma that owns it
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, as __expf computes e^x
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

#define WG_D32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT32(d)                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),  \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),       \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),    \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])

// d (+)= A B, m64n64k16, A and B K-major in shared memory; accumulate != 0
// adds to d, else overwrites it
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16, A (bf16 pairs) in registers, B MN-major in shared
// memory (transpose flag)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo: the lower 16 bits
  return *reinterpret_cast<const uint32_t*>(&p);
}

// ---------------------------------------------------------------------------
// bf16 helpers: mask bits of a key tile, the online softmax of a score tile
// ---------------------------------------------------------------------------
constexpr int TILE = 64;  // query rows per warpgroup = keys per tile
constexpr int TILE_BYTES = TILE * D * 2;  // 8 KB

// A warp reads the 64 mask bytes of the key tile at k0: the padded-key bits
// (lo: keys k0 .. k0 + 31, hi: the next 32); true if some key < N is valid.
__device__ __forceinline__ bool tile_bits(const uint8_t* mrow, int k0, int N, int lane,
                                          uint32_t& lo, uint32_t& hi) {
  const int j0 = k0 + lane, j1 = j0 + 32;
  const bool p0 = j0 < N && mrow != nullptr && mrow[j0];
  const bool p1 = j1 < N && mrow != nullptr && mrow[j1];
  lo = __ballot_sync(0xffffffffu, p0);
  hi = __ballot_sync(0xffffffffu, p1);
  return __any_sync(0xffffffffu, (j0 < N && !p0) || (j1 < N && !p1)) != 0;
}

// This thread's dead columns of the tile at k0 (bit 8j + e: a padded key or
// one past N), from the tile's padded-key bits. A padded key's p is 0 here,
// as exp(s + NEG - m) is in f32: a tile in the ring has a valid key, so the
// row max m is finite.
__device__ __forceinline__ uint64_t dead_columns(uint32_t lo, uint32_t hi, int k0, int N,
                                                 int quad) {
  uint64_t dead = (((uint64_t)hi << 32) | lo) >> (2 * quad);
  const int lim = N - k0 - 2 * quad;  // column 8j + e is a key < N iff 8j + e < lim
  if (lim < TILE) dead |= ~0ull << max(lim, 0);
  return dead;
}

// One online-softmax step on a score tile in registers: masks the dead
// columns, takes each row's max across the 4 threads of its quad, turns sc
// into p = exp(scale * s - m) (f32), and updates the running max m_run (log2
// units; c = scale * log2 e) and this thread's share of the running sum
// l_run. alpha = exp(m_old - m_new) rescales O.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], uint64_t dead, float c,
                                             float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2]) {
  if (dead != 0) {
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if ((dead >> (8 * (k / 4) + k % 2)) & 1) sc[k] = -INFINITY;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t[8];  // a tree: the 16 values of the row are independent
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]);
#pragma unroll
    for (int w = 4; w >= 1; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
    float mx = fmaxf(t[0], __shfl_xor_sync(0xffffffffu, t[0], 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[r], mx * c);  // finite: the tile has a valid key
    alpha[r] = ex2(m_run[r] - m_new);
    m_run[r] = m_new;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j + 2 * r] = ex2(fmaf(sc[4 * j + 2 * r], c, -m_new));
      sc[4 * j + 2 * r + 1] = ex2(fmaf(sc[4 * j + 2 * r + 1], c, -m_new));
      t[j] = sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
    }
#pragma unroll
    for (int w = 4; w >= 1; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] += t[j + w];
    l_run[r] = l_run[r] * alpha[r] + t[0];
  }
}

// O *= alpha per row; P (f32 in sc) to bf16 A fragments: k-slice j / 2
// holds columns 16 (j / 2) .. 16 (j / 2) + 15, register (j % 2) * 2 + r.
__device__ __forceinline__ void rescale_and_pack(float (&acc)[32], const float (&sc)[32],
                                                 const float (&alpha)[2],
                                                 uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      acc[4 * j + 2 * r] *= alpha[r];
      acc[4 * j + 2 * r + 1] *= alpha[r];
      pa[j >> 1][(j & 1) * 2 + r] = pack_bf16(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]);
    }
}

// O / l (0 where every key was padded), stored as bf16 pairs: this thread's
// rows row0 and row0 + 8 of its (b, h) slab o_bh, rows osn elements apart.
__device__ __forceinline__ void store_rows(const float (&acc)[32], const float (&l_run)[2],
                                           __nv_bfloat16* o_bh, long long osn, int row0, int N,
                                           int quad) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int row = row0 + 8 * r;
    if (row < N) {
      __nv_bfloat16* dst = o_bh + (size_t)row * osn + 2 * quad;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

constexpr float LOG2E = 1.4426950408889634f;

// The gated relative position bias of a biased launch: table (H, 2N - 1),
// contiguous; gate (B, H, N) with element strides gs (b, h, n).
struct RelBias {
  const float* table;
  const float* gate;
  long long gsb, gsh, gsn;
};

// sc = c * s + g2[r] * table entry, in log2 units (g2 = gate * log2 e).
// Element 4j + 2r + e (row row0 + 8r, key k0 + 8j + 2 quad + e) reads the
// entry base + 8 (j - r) + e, base = k0 + 2 quad - row0 + N - 1. Inside the
// table for a tile whose rows and keys are all below N; in a ragged tile
// (CLAMP) indices are clamped to [0, last]: only a key past N (a dead
// column) or a row past N (never stored) reads a clamped entry. Unclamped,
// the 18 loads are one base address and immediate offsets. Entry m
// (= j - r + 1, 0..8) serves (j = m - 1, r = 0) and (j = m, r = 1).
template <bool CLAMP>
__device__ __forceinline__ void add_bias(float (&sc)[32], const float* __restrict__ tb,
                                         int base, int last, float c, const float (&g2)[2]) {
  const float* tt = CLAMP ? tb : tb + base;  // unclamped: base lies inside the table
#pragma unroll
  for (int m = 0; m < 9; ++m) {
    const int i0 = base + 8 * (m - 1);
    const float t0 = CLAMP ? __ldg(tb + min(max(i0, 0), last)) : __ldg(tt + 8 * (m - 1));
    const float t1 = CLAMP ? __ldg(tb + min(max(i0 + 1, 0), last)) : __ldg(tt + 8 * (m - 1) + 1);
    if (m >= 1) {
      sc[4 * (m - 1)] = fmaf(sc[4 * (m - 1)], c, g2[0] * t0);
      sc[4 * (m - 1) + 1] = fmaf(sc[4 * (m - 1) + 1], c, g2[0] * t1);
    }
    if (m <= 7) {
      sc[4 * m + 2] = fmaf(sc[4 * m + 2], c, g2[1] * t0);
      sc[4 * m + 3] = fmaf(sc[4 * m + 3], c, g2[1] * t1);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, one warpgroup a block, its warp 0 issuing the loads
// (4 blocks an SM: 113 registers a thread, 51 KB of shared memory)
// ---------------------------------------------------------------------------
constexpr int K_STAGES = 2;  // K_i is free once S_i is done
constexpr int V_STAGES = 3;  // V_i is free once the PV product of tile i is done

struct alignas(1024) SmemBf16 {
  __nv_bfloat16 q[TILE * D];  // every tile 1024-byte aligned (128-byte swizzle)
  __nv_bfloat16 k[K_STAGES][TILE * D];
  __nv_bfloat16 v[V_STAGES][TILE * D];
  uint64_t full_k[K_STAGES];  // K of the slot landed; pad and k0 are written
  uint64_t full_v[V_STAGES];  // V of the slot landed
  uint64_t qbar;              // q landed and n_tiles is written
  uint32_t pad[K_STAGES][2];  // padded-key bits of the slot's 64 keys
  int k0[K_STAGES];           // the slot's first key
  int n_tiles;                // key tiles with a valid key: the ring's length
};

__global__ void __launch_bounds__(128, 4)
attn_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                     long long osb, long long osh, long long osn, int N, float scale) {
  extern __shared__ unsigned char smem_raw[];
  SmemBf16& sm = *reinterpret_cast<SmemBf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, quad = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TILE;
  const int tiles = (N + TILE - 1) / TILE;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)b * N : nullptr;

  if (threadIdx.x == 0) {  // q goes first: it needs nothing of the mask
    for (int s = 0; s < K_STAGES; ++s) mbar_init(&sm.full_k[s], 1);
    for (int s = 0; s < V_STAGES; ++s) mbar_init(&sm.full_v[s], 1);
    mbar_init(&sm.qbar, 2);  // the q copy's arrive, and n_tiles written
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(&sm.qbar, TILE_BYTES);
    tma_load(sm.q, &tq, &sm.qbar, q0, h, b);
  }
  __syncthreads();

  // Warp 0 walks the key tiles with a valid key (the ring; a tile whose keys
  // are all padded is neither loaded nor computed) and loads them: K of ring
  // tile i + 2 once S_i is done, V of ring tile i + 2 once the PV product of
  // tile i - 1 is done. Lane 0 issues the copies.
  int cursor = 0;                      // warp 0: the next key tile to look at
  int next_k0 = 0;                     // warp 0: the ring tile whose K goes next
  uint32_t next_lo = 0, next_hi = 0;   //         and its padded-key bits
  auto advance = [&]() {  // warp 0: finds the next ring tile; false if none is left
    while (cursor < tiles) {
      next_k0 = TILE * cursor++;
      if (tile_bits(mrow, next_k0, N, lane, next_lo, next_hi)) return true;
    }
    return false;
  };
  auto load_k = [&](int i) {
    if (lane == 0) {
      const int s = i % K_STAGES;
      sm.pad[s][0] = next_lo;  // released with the slot by the arrive below
      sm.pad[s][1] = next_hi;
      sm.k0[s] = next_k0;
      mbar_expect_tx(&sm.full_k[s], TILE_BYTES);
      tma_load(sm.k[s], &tk, &sm.full_k[s], next_k0, h, b);
    }
  };
  auto load_v = [&](int i) {
    if (lane == 0) {
      const int s = i % V_STAGES;
      mbar_expect_tx(&sm.full_v[s], TILE_BYTES);
      tma_load(sm.v[s], &tv, &sm.full_v[s], next_k0, h, b);
    }
  };
  if (warp == 0) {
    int n = 0;  // ring tiles: the first three are loaded before the rest is counted
    for (; n < 3 && advance(); ++n) {  // K and V of ring tiles 0, 1; V of 2
      if (n < 2) load_k(n);
      load_v(n);
    }
    for (int t = cursor; t < tiles; ++t) {
      uint32_t lo, hi;
      n += tile_bits(mrow, t * TILE, N, lane, lo, hi);
    }
    if (lane == 0) {
      sm.n_tiles = n;
      mbar_arrive(&sm.qbar);  // releases n_tiles
    }
    __syncwarp();
  }

  // A thread's accumulator elements i = 4j + 2r + e (j < 8, r, e < 2) sit at
  // row 16 warp + lane / 4 + 8r, column 8j + 2 (lane % 4) + e.
  const float c = scale * 1.4426950408889634f;  // scores to log2 units
  float acc[32];
  uint32_t pa[4][4];  // P of the tile whose PV product is pending, as A fragments
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    acc[k] = 0.f;
    pa[k / 8][(k / 2) % 4] = 0u;
  }
  // running max (log2 units) and this thread's share of the running sum
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(sm.q);

  mbar_wait(&sm.qbar, 0);
  const int n_tiles = sm.n_tiles;
  // Per ring tile i: S_i = Q K_i^T and O += P_{i-1} V_{i-1} are issued
  // together; the softmax of S_i runs while the PV product is on the tensor
  // cores; O is rescaled once that product is done. For i = 0, P is 0 and
  // the product reads V_0: it adds 0, and keeps the loop free of branches
  // around the wgmmas. A slot is refilled once warp 0 has seen the wgmma
  // that read it complete: a wgmma completes for the whole warpgroup, and
  // every warp reads the slot's pad and k0 before it issues that wgmma.
  for (int i = 0; i < n_tiles; ++i) {
    const int ks = i % K_STAGES, jv = max(i - 1, 0), vs = jv % V_STAGES;
    mbar_wait(&sm.full_k[ks], (i / K_STAGES) & 1);
    const uint64_t dead = dead_columns(sm.pad[ks][0], sm.pad[ks][1], sm.k0[ks], N, quad);
    mbar_wait(&sm.full_v[vs], (jv / V_STAGES) & 1);

    float sc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) sc[k] = 0.f;
    const uint32_t k_addr = smem_u32(sm.k[ks]), v_addr = smem_u32(sm.v[vs]);
    pin(sc);
    pin(acc);
    pin(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // 16 d (32 bytes) a k-slice
      wgmma_ss(sc, sw128_desc(q_addr + 32 * kk), sw128_desc(k_addr + 32 * kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)  // 16 keys (2048 bytes of V) a k-slice
      wgmma_rs(acc, pa[kk], sw128_desc(v_addr + 2048 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // S_i is done; the PV product may still run
    pin(sc);
    if (warp == 0 && i + 2 < n_tiles) {  // K slot ks is free: K of ring tile i + 2
      if (i > 0) advance();  // ring tile 2 was found before the loop
      load_k(i + 2);
    }

    float alpha[2];
    softmax_tile(sc, dead, c, m_run, l_run, alpha);
    wgmma_wait<0>();
    pin(acc);
    pin(pa);
    if (warp == 0 && i > 0 && i + 2 < n_tiles) load_v(i + 2);  // V slot of i - 1 is free
    rescale_and_pack(acc, sc, alpha, pa);
  }
  if (n_tiles > 0) {  // the last tile's PV product
    const int jv = n_tiles - 1, vs = jv % V_STAGES;
    mbar_wait(&sm.full_v[vs], (jv / V_STAGES) & 1);
    const uint32_t v_addr = smem_u32(sm.v[vs]);
    pin(acc);
    pin(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs(acc, pa[kk], sw128_desc(v_addr + 2048 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(pa);
  }

  store_rows(acc, l_run, o + (size_t)b * osb + (size_t)h * osh, osn,
             q0 + warp * 16 + (lane >> 2), N, quad);
}


// The unbiased kernel above with the gated relative position bias: its own
// copy of the body, so that the unbiased one compiles as it did before the
// bias existed. The lines that differ: the rows' gates and the table index
// base before the loop, each tile's first key read with its padded-key bits,
// and add_bias before the online softmax (which then takes log2 units).
__global__ void __launch_bounds__(128, 4)
attn_fwd_relbias_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                             long long osb, long long osh, long long osn, int N, float scale,
                             const RelBias rb) {
  extern __shared__ unsigned char smem_raw[];
  SmemBf16& sm = *reinterpret_cast<SmemBf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, quad = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TILE;
  const int tiles = (N + TILE - 1) / TILE;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)b * N : nullptr;

  if (threadIdx.x == 0) {  // q goes first: it needs nothing of the mask
    for (int s = 0; s < K_STAGES; ++s) mbar_init(&sm.full_k[s], 1);
    for (int s = 0; s < V_STAGES; ++s) mbar_init(&sm.full_v[s], 1);
    mbar_init(&sm.qbar, 2);  // the q copy's arrive, and n_tiles written
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(&sm.qbar, TILE_BYTES);
    tma_load(sm.q, &tq, &sm.qbar, q0, h, b);
  }
  __syncthreads();

  // Warp 0 walks the key tiles with a valid key (the ring; a tile whose keys
  // are all padded is neither loaded nor computed) and loads them: K of ring
  // tile i + 2 once S_i is done, V of ring tile i + 2 once the PV product of
  // tile i - 1 is done. Lane 0 issues the copies.
  int cursor = 0;                      // warp 0: the next key tile to look at
  int next_k0 = 0;                     // warp 0: the ring tile whose K goes next
  uint32_t next_lo = 0, next_hi = 0;   //         and its padded-key bits
  auto advance = [&]() {  // warp 0: finds the next ring tile; false if none is left
    while (cursor < tiles) {
      next_k0 = TILE * cursor++;
      if (tile_bits(mrow, next_k0, N, lane, next_lo, next_hi)) return true;
    }
    return false;
  };
  auto load_k = [&](int i) {
    if (lane == 0) {
      const int s = i % K_STAGES;
      sm.pad[s][0] = next_lo;  // released with the slot by the arrive below
      sm.pad[s][1] = next_hi;
      sm.k0[s] = next_k0;
      mbar_expect_tx(&sm.full_k[s], TILE_BYTES);
      tma_load(sm.k[s], &tk, &sm.full_k[s], next_k0, h, b);
    }
  };
  auto load_v = [&](int i) {
    if (lane == 0) {
      const int s = i % V_STAGES;
      mbar_expect_tx(&sm.full_v[s], TILE_BYTES);
      tma_load(sm.v[s], &tv, &sm.full_v[s], next_k0, h, b);
    }
  };
  if (warp == 0) {
    int n = 0;  // ring tiles: the first three are loaded before the rest is counted
    for (; n < 3 && advance(); ++n) {  // K and V of ring tiles 0, 1; V of 2
      if (n < 2) load_k(n);
      load_v(n);
    }
    for (int t = cursor; t < tiles; ++t) {
      uint32_t lo, hi;
      n += tile_bits(mrow, t * TILE, N, lane, lo, hi);
    }
    if (lane == 0) {
      sm.n_tiles = n;
      mbar_arrive(&sm.qbar);  // releases n_tiles
    }
    __syncwarp();
  }

  // A thread's accumulator elements i = 4j + 2r + e (j < 8, r, e < 2) sit at
  // row 16 warp + lane / 4 + 8r, column 8j + 2 (lane % 4) + e.
  const float c = scale * 1.4426950408889634f;  // scores to log2 units
  // this thread's rows' gates in log2 units, its head's table, and the table
  // index of its first element less the tile's first key
  float g2[2];
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const float* gb = rb.gate + (size_t)b * rb.gsb + (size_t)h * rb.gsh;
#pragma unroll
  for (int r = 0; r < 2; ++r) g2[r] = gb[(size_t)min(row0 + 8 * r, N - 1) * rb.gsn] * LOG2E;
  const float* tb = rb.table + (size_t)h * (2 * N - 1);
  const int rel0 = 2 * quad - row0 + N - 1;
  const bool edge_rows = q0 + TILE > N;  // the last query block: rows past N
  float acc[32];
  uint32_t pa[4][4];  // P of the tile whose PV product is pending, as A fragments
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    acc[k] = 0.f;
    pa[k / 8][(k / 2) % 4] = 0u;
  }
  // running max (log2 units) and this thread's share of the running sum
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(sm.q);

  mbar_wait(&sm.qbar, 0);
  const int n_tiles = sm.n_tiles;
  // Per ring tile i: S_i = Q K_i^T and O += P_{i-1} V_{i-1} are issued
  // together; the softmax of S_i runs while the PV product is on the tensor
  // cores; O is rescaled once that product is done. For i = 0, P is 0 and
  // the product reads V_0: it adds 0, and keeps the loop free of branches
  // around the wgmmas. A slot is refilled once warp 0 has seen the wgmma
  // that read it complete: a wgmma completes for the whole warpgroup, and
  // every warp reads the slot's pad and k0 before it issues that wgmma.
  for (int i = 0; i < n_tiles; ++i) {
    const int ks = i % K_STAGES, jv = max(i - 1, 0), vs = jv % V_STAGES;
    mbar_wait(&sm.full_k[ks], (i / K_STAGES) & 1);
    const uint64_t dead = dead_columns(sm.pad[ks][0], sm.pad[ks][1], sm.k0[ks], N, quad);
    const int kt0 = sm.k0[ks];  // read before warp 0 refills the slot below
    mbar_wait(&sm.full_v[vs], (jv / V_STAGES) & 1);

    float sc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) sc[k] = 0.f;
    const uint32_t k_addr = smem_u32(sm.k[ks]), v_addr = smem_u32(sm.v[vs]);
    pin(sc);
    pin(acc);
    pin(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // 16 d (32 bytes) a k-slice
      wgmma_ss(sc, sw128_desc(q_addr + 32 * kk), sw128_desc(k_addr + 32 * kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)  // 16 keys (2048 bytes of V) a k-slice
      wgmma_rs(acc, pa[kk], sw128_desc(v_addr + 2048 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // S_i is done; the PV product may still run
    pin(sc);
    if (warp == 0 && i + 2 < n_tiles) {  // K slot ks is free: K of ring tile i + 2
      if (i > 0) advance();  // ring tile 2 was found before the loop
      load_k(i + 2);
    }

    float alpha[2];
    if (edge_rows || kt0 + TILE > N)  // a ragged tile: indices clamped
      add_bias<true>(sc, tb, kt0 + rel0, 2 * N - 2, c, g2);
    else
      add_bias<false>(sc, tb, kt0 + rel0, 2 * N - 2, c, g2);
    softmax_tile(sc, dead, 1.f, m_run, l_run, alpha);  // the scores are in log2 units
    wgmma_wait<0>();
    pin(acc);
    pin(pa);
    if (warp == 0 && i > 0 && i + 2 < n_tiles) load_v(i + 2);  // V slot of i - 1 is free
    rescale_and_pack(acc, sc, alpha, pa);
  }
  if (n_tiles > 0) {  // the last tile's PV product
    const int jv = n_tiles - 1, vs = jv % V_STAGES;
    mbar_wait(&sm.full_v[vs], (jv / V_STAGES) & 1);
    const uint32_t v_addr = smem_u32(sm.v[vs]);
    pin(acc);
    pin(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs(acc, pa[kk], sw128_desc(v_addr + 2048 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    pin(pa);
  }

  store_rows(acc, l_run, o + (size_t)b * osb + (size_t)h * osh, osn,
             q0 + warp * 16 + (lane >> 2), N, quad);
}

// ---------------------------------------------------------------------------
// f32: FMA loops, one query row per thread, 64 rows per block, 32-key tiles.
// ---------------------------------------------------------------------------
constexpr int F_BQ = 64;
constexpr int F_BK = 32;
constexpr int F_LOADS = F_BK * (D / 4) / F_BQ;  // float4s of K (and of V) a thread loads a tile

struct Strides {  // element strides (b, h, n) of q, k, v and the output
  long long q[3], k[3], v[3], o[3];
};

// the (b, h) slab of an operand with element strides s
template <typename T>
__device__ __forceinline__ T* slab(T* p, const long long (&s)[3], int b, int h) {
  return p + (size_t)b * s[0] + (size_t)h * s[1];
}

// Key flag in shared memory: 0 = valid key, 1 = padded key (s + NEG),
// -1 = past N (excluded).
__device__ __forceinline__ float key_flag(const uint8_t* mrow, int j, int N) {
  if (j >= N) return -1.f;
  return (mrow != nullptr && mrow[j]) ? 1.f : 0.f;
}

template <bool BIAS>
__device__ __forceinline__ void attn_f32_body(const float* __restrict__ q,
                                              const float* __restrict__ k,
                                              const float* __restrict__ v,
                                              const uint8_t* __restrict__ mask,
                                              float* __restrict__ o, const Strides& st, int N,
                                              float scale, const RelBias& rb) {
  __shared__ __align__(16) float ks[F_BK][D];
  __shared__ __align__(16) float vs[F_BK][D];
  __shared__ float flag[F_BK];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * F_BQ + tid;
  const uint8_t* mrow = mask != nullptr ? mask + (size_t)b * N : nullptr;
  const float* kb = slab(k, st.k, b, h);
  const float* vb = slab(v, st.v, b, h);
  const size_t kn = st.k[2], vn = st.v[2];

  // a row past N reads row N - 1 (unconditional loads, as for K and V
  // below) and is never stored
  const float* qrow = slab(q, st.q, b, h) + (size_t)min(row, N - 1) * st.q[2];
  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(qrow + d);
    // q * scale in f32 first, as the JAX encoder computes it
    qr[d] = x.x * scale; qr[d + 1] = x.y * scale; qr[d + 2] = x.z * scale; qr[d + 3] = x.w * scale;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;
  // biased: the row's gate and the table index of key 0 (clamped at use:
  // a row past N is never stored)
  float gq = 0.f;
  const float* tb = nullptr;
  if constexpr (BIAS) {
    gq = rb.gate[(size_t)b * rb.gsb + (size_t)h * rb.gsh + (size_t)min(row, N - 1) * rb.gsn];
    tb = rb.table + (size_t)h * (2 * N - 1);
  }

  for (int k0 = 0; k0 < N; k0 += F_BK) {
    __syncthreads();
    int valid = 0;
    if (tid < F_BK) {
      const float f = key_flag(mrow, k0 + tid, N);
      flag[tid] = f;
      valid = f == 0.f;
    }
    if (!__syncthreads_or(valid)) continue;  // every key of the tile is padded
    // Every load of the tile is issued before any store, so the tile costs
    // one memory round trip: the loads are unconditional (a row past N
    // reads row N - 1, then is zeroed by a select), since a load under a
    // branch waits for the one before it.
    float4 kx[F_LOADS], vx[F_LOADS];
#pragma unroll
    for (int i = 0; i < F_LOADS; ++i) {
      const int c = tid + i * F_BQ, r = c / (D / 4), col = (c % (D / 4)) * 4;
      const size_t n = min(k0 + r, N - 1);
      kx[i] = *reinterpret_cast<const float4*>(kb + n * kn + col);
      vx[i] = *reinterpret_cast<const float4*>(vb + n * vn + col);
    }
#pragma unroll
    for (int i = 0; i < F_LOADS; ++i) {
      const int c = tid + i * F_BQ, r = c / (D / 4), col = (c % (D / 4)) * 4;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(&ks[r][col]) = k0 + r < N ? kx[i] : zero;
      *reinterpret_cast<float4*>(&vs[r][col]) = k0 + r < N ? vx[i] : zero;
    }
    __syncthreads();

    float s[F_BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < F_BK; ++j) {
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) x = fmaf(qr[d], ks[j][d], x);
      if constexpr (BIAS) x += gq * __ldg(tb + min(max(k0 + j - row + N - 1, 0), 2 * N - 2));
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
    float* dst = slab(o, st.o, b, h) + row * st.o[2];
#pragma unroll
    for (int d = 0; d < D; d += 4)
      *reinterpret_cast<float4*>(dst + d) =
          make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
  }
}

__global__ void __launch_bounds__(F_BQ)
attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const uint8_t* __restrict__ mask,
                    float* __restrict__ o, const Strides st, int N, float scale) {
  attn_f32_body<false>(q, k, v, mask, o, st, N, scale, RelBias{});
}

__global__ void __launch_bounds__(F_BQ)
attn_fwd_relbias_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const uint8_t* __restrict__ mask,
                            float* __restrict__ o, const Strides st, int N, float scale,
                            const RelBias rb) {
  attn_f32_body<true>(q, k, v, mask, o, st, N, scale, rb);
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

// A 4-D map (64 d, N, H, B) of a bf16 operand with element strides (b, h, n):
// boxes of 64 rows x 64 d, 128-byte swizzle, rows past N read as 0.
int encode(EncodeTiledFn fn, CUtensorMap* map, const void* base, int B, int H, int N,
           const long long* s) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s[2] * 2, (cuuint64_t)s[1] * 2,
                                 (cuuint64_t)s[0] * 2};  // bytes, dims 1..3
  const cuuint32_t box[4] = {(cuuint32_t)D, (cuuint32_t)TILE, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE_BASE - (int)r;
}

template <bool BIAS>
int launch_bf16(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                const uint8_t* mask, __nv_bfloat16* o, const long long* os, int B, int H, int N,
                float scale, const RelBias& rb, cudaStream_t stream) {
  const int smem = (int)sizeof(SmemBf16) + 1024;  // + room to align the base
  // the shared-memory attribute is set once per device and kernel (bit d:
  // device d; one set of bits per instantiation)
  static std::atomic<uint64_t> attribute_set{0};
  const void* kernel = BIAS ? reinterpret_cast<const void*>(attn_fwd_relbias_bf16_kernel)
                            : reinterpret_cast<const void*>(attn_fwd_bf16_kernel);
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (bit == 0 || (attribute_set.load(std::memory_order_relaxed) & bit) == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attribute_set.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  if constexpr (BIAS)
    attn_fwd_relbias_bf16_kernel<<<grid, 128, smem, stream>>>(tq, tk, tv, mask, o, os[0], os[1],
                                                              os[2], N, scale, rb);
  else
    attn_fwd_bf16_kernel<<<grid, 128, smem, stream>>>(tq, tk, tv, mask, o, os[0], os[1], os[2],
                                                      N, scale);
  return (int)cudaGetLastError();
}

template <bool BIAS>
int run_bf16(const void* q, const void* k, const void* v, const void* mask, void* o, int B,
             int H, int N, const long long* strides, float scale, const RelBias& rb,
             void* stream) {
  if (B <= 0 || H <= 0 || N <= 0) return 0;
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  CUtensorMap tq, tk, tv;
  int err;
  if ((err = encode(fn, &tq, q, B, H, N, strides)) != 0) return err;
  if ((err = encode(fn, &tk, k, B, H, N, strides + 3)) != 0) return err;
  if ((err = encode(fn, &tv, v, B, H, N, strides + 6)) != 0) return err;
  return launch_bf16<BIAS>(tq, tk, tv, static_cast<const uint8_t*>(mask),
                           static_cast<__nv_bfloat16*>(o), strides + 9, B, H, N, scale, rb,
                           static_cast<cudaStream_t>(stream));
}

template <bool BIAS>
int run_f32(const void* q, const void* k, const void* v, const void* mask, void* o, int B,
            int H, int N, const long long* strides, float scale, const RelBias& rb,
            void* stream) {
  if (B <= 0 || H <= 0 || N <= 0) return 0;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const dim3 grid((N + F_BQ - 1) / F_BQ, H, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if constexpr (BIAS)
    attn_fwd_relbias_f32_kernel<<<grid, F_BQ, 0, s>>>(qf, kf, vf, m, static_cast<float*>(o), st,
                                                      N, scale, rb);
  else
    attn_fwd_f32_kernel<<<grid, F_BQ, 0, s>>>(qf, kf, vf, m, static_cast<float*>(o), st, N,
                                              scale);
  return (int)cudaGetLastError();
}

RelBias rel_bias(const void* table, const void* gate, const long long* gs) {
  return RelBias{static_cast<const float*>(table), static_cast<const float*>(gate), gs[0], gs[1],
                 gs[2]};
}

}  // namespace

extern "C" {

// q, k, v: (B, H, N, 64) with element strides strides[0:3], [3:6], [6:9]
// (b, h, n; unit last stride, each a multiple of 8, bases 16-byte aligned);
// out: strides[9:12]; mask: (B, N) bytes or null. scale multiplies the
// scores (1 when q is pre-scaled; > 0). Returns 0, a cudaError_t, or one of
// the ERR_ codes above.
int attn_fwd_bf16(const void* q, const void* k, const void* v, const void* mask, void* o,
                  int B, int H, int N, const long long* strides, float scale, void* stream) {
  return run_bf16<false>(q, k, v, mask, o, B, H, N, strides, scale, RelBias{}, stream);
}

// The same contract in f32.
int attn_fwd_f32(const void* q, const void* k, const void* v, const void* mask, void* o, int B,
                 int H, int N, const long long* strides, float scale, void* stream) {
  return run_f32<false>(q, k, v, mask, o, B, H, N, strides, scale, RelBias{}, stream);
}

// The same contracts plus the gated relative position bias: table (H, 2N - 1)
// f32, contiguous; gate (B, H, N) f32 with element strides gate_strides
// (b, h, n).
int attn_fwd_relbias_bf16(const void* q, const void* k, const void* v, const void* mask,
                          void* o, int B, int H, int N, const long long* strides, float scale,
                          const void* table, const void* gate, const long long* gate_strides,
                          void* stream) {
  return run_bf16<true>(q, k, v, mask, o, B, H, N, strides, scale,
                        rel_bias(table, gate, gate_strides), stream);
}

int attn_fwd_relbias_f32(const void* q, const void* k, const void* v, const void* mask, void* o,
                         int B, int H, int N, const long long* strides, float scale,
                         const void* table, const void* gate, const long long* gate_strides,
                         void* stream) {
  return run_f32<true>(q, k, v, mask, o, B, H, N, strides, scale,
                       rel_bias(table, gate, gate_strides), stream);
}

}  // extern "C"
