// d2v's optimizer step and EMA update as one multi-tensor pass, written by
// hand for Hopper (sm_90a). Bound to PyTorch through ctypes by
// ops/d2v_update.py, which also plans the launches (update_plan there).
//
// It replaces no TPU kernel: the JAX package leaves optax's update to XLA,
// which fuses it into a few loops. It replaces the port's per-leaf update
// on the card (models/d2v_pretrain.py: D2vOptimizer.update and the EMA of
// optimizer_and_ema_per_leaf), which issues about 24 elementwise kernels a
// leaf over e2v-base's 193 leaves and waits on the device once a leaf.
// That per-leaf code stays as the plain version: the CPU runs it and the
// card tests hold this kernel to it.
//
// Per element of every leaf, in f32 and in the per-leaf code's order, each
// operation rounded on its own (no contraction into FMAs):
//   g   = norm >= max_norm ? (g / norm) * max_norm : g   (0 without a gradient)
//   mu' = (1 - b1) g + round_mu(b1_mu * mu)   b1_mu: b1 rounded to mu's type;
//                                             round_mu: to mu's type (optax's)
//   nu' = (1 - b2) (g g) + b2 nu
//   p'  = p + (-lr) ((mu' / c1) / (sqrt(nu' / c2) + eps) + wd p)
//   e'  = d e + (1 - d) p'                    the teacher's EMA leaves only
// stored as p' and nu' in f32, mu' in mu's type after its unrounded use, e'
// in the EMA's type. norm is the gradients' global norm (given by the
// caller, or taken here). -lr, c1, c2 and d are f32 scalars on the device
// that the caller computes with the per-leaf code's own functions
// (D2vOptimizer.schedule, annealed_decay), so the schedule has one
// definition; the kernels read them in place.
//
// What bounds it on an H100: bytes. A parameter reads g, p, mu, nu and
// writes p', mu', nu' (28 B in f32), an EMA parameter reads and writes its
// copy (8 B more), and the norm reads g once more (4 B). e2v-base's d2v
// state (93,737,600 parameters, 56,702,976 of them in the EMA) moves 3.45 GB
// a step: 1.03 ms at 3.35 TB/s.
//
// What the design does about it:
// - Three kernels on the caller's stream, and no host-device sync:
//   (a) sumsq: a block sums g^2 over its chunk into one f32 partial, in a
//       fixed order (four accumulators a thread, warp shuffles, the warps in
//       order), so two runs from one state agree bit for bit;
//   (b) finalize: one block sums the partials in a fixed order into the
//       norm; (a) and (b) are skipped when the caller passes the norm (the
//       process grid's tensor parallelism);
//   (c) update: one pass over every element, each read and written once.
// - The leaf table (addresses, offsets, sizes) is the kernels' parameter
//   (__grid_constant__, read in place): a launch takes up to MAX_LEAVES
//   leaves, so e2v-base's 193 leaves take 4 launches of (a) and of (c), and
//   nothing is copied to the device for them.
// - A block takes CHUNK elements of one leaf and finds its leaf by binary
//   search over the launch's first-block table; a thread issues the loads
//   of UNROLL elements before their arithmetic. Loads are 4-byte, lanes on
//   neighbouring elements, so a warp's loads coalesce whatever a leaf's
//   offset.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr long long CHUNK = 16384;  // elements a block (ops/d2v_update.py: CHUNK)
constexpr int MAX_LEAVES = 52;      // leaves a launch (ops/d2v_update.py: MAX_LEAVES)
constexpr int LEAF_FIELDS = 8;      // a row of the leaf table (ops/d2v_update.py)
constexpr int FINAL_THREADS = 1024;

// the constants, in ops/d2v_update.py's HYPER order
enum HyperIndex { H_ONE_MINUS_B1, H_B1_MU, H_ONE_MINUS_B2, H_B2, H_EPS, H_WD, H_MAX_NORM, H_COUNT };

struct Hyper {
  float v[H_COUNT];
};

struct Leaves {
  int n;                       // leaves of this launch
  int blocks;                  // its grid
  int partial_base;            // the partial of its first block
  int start[MAX_LEAVES + 1];   // each leaf's first block; start[n] = blocks
  const float* g[MAX_LEAVES];  // null: no gradient, read as zeros
  const float* p[MAX_LEAVES];
  const void* m[MAX_LEAVES];
  const float* v[MAX_LEAVES];
  const void* e[MAX_LEAVES];   // null: not an EMA leaf
  long long off[MAX_LEAVES];   // into the flat p', mu', nu'
  long long eoff[MAX_LEAVES];  // into the flat e'
  long long numel[MAX_LEAVES];
};

// the step's f32 scalars on the device
struct Scalars {
  const float* norm;
  const float* neg_lr;
  const float* c1;
  const float* c2;
  const float* decay;
};

struct Outs {
  float* p;
  void* m;
  float* v;
  void* e;
  Scalars s;
};

static_assert(UNROLL == 4, "sumsq_kernel adds four accumulators");
// a kernel's parameters hold at most 4 KB
static_assert(sizeof(Leaves) + sizeof(Outs) + sizeof(Hyper) <= 4000, "kernel parameters");

__device__ __forceinline__ int leaf_of(const Leaves& t, int b) {
  int lo = 0, hi = t.n - 1;  // the last leaf whose first block is <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.start[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float load(const float* x, long long i) { return x[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}
__device__ __forceinline__ void store(float* x, long long i, float v) { x[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* x, long long i, float v) {
  x[i] = __float2bfloat16_rn(v);
}

// v rounded to T and back
template <typename T> __device__ __forceinline__ float rounded(float v);
template <> __device__ __forceinline__ float rounded<float>(float v) { return v; }
template <> __device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the block's sum, in thread 0, in a fixed order
template <int NT>
__device__ __forceinline__ float block_sum(float x, float* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) s += warp_sums[w];
  return s;
}

__global__ void __launch_bounds__(THREADS)
sumsq_kernel(const __grid_constant__ Leaves t, float* partials) {
  __shared__ float warp_sums[THREADS / 32];
  const int b = blockIdx.x;
  const int l = leaf_of(t, b);
  const float* g = t.g[l];
  float acc[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) acc[u] = 0.f;
  if (g != nullptr) {
    const long long begin = (long long)(b - t.start[l]) * CHUNK;
    const long long end = min(t.numel[l], begin + CHUNK);
    for (long long i0 = begin + threadIdx.x; i0 < end; i0 += THREADS * UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long i = i0 + (long long)u * THREADS;
        if (i < end) {
          const float x = g[i];
          acc[u] = fmaf(x, x, acc[u]);
        }
      }
    }
  }
  const float s = block_sum<THREADS>((acc[0] + acc[1]) + (acc[2] + acc[3]), warp_sums);
  if (threadIdx.x == 0) partials[t.partial_base + b] = s;
}

// The norm: the partials summed in a fixed order.
__global__ void __launch_bounds__(FINAL_THREADS)
finalize_kernel(const float* partials, int n_partials, float* norm) {
  __shared__ float warp_sums[FINAL_THREADS / 32];
  float acc = 0.f;
  for (int i = threadIdx.x; i < n_partials; i += FINAL_THREADS) acc += partials[i];
  const float s = block_sum<FINAL_THREADS>(acc, warp_sums);
  if (threadIdx.x == 0) *norm = __fsqrt_rn(s);
}

template <typename MuT, typename EmaT>
__global__ void __launch_bounds__(THREADS)
update_kernel(const __grid_constant__ Leaves t, const Outs o, const Hyper h) {
  const int b = blockIdx.x;
  const int l = leaf_of(t, b);
  const long long begin = (long long)(b - t.start[l]) * CHUNK;
  const long long end = min(t.numel[l], begin + CHUNK);
  const float* H = h.v;
  const float norm = *o.s.norm, neg_lr = *o.s.neg_lr, c1 = *o.s.c1, c2 = *o.s.c2;
  const float d = *o.s.decay, one_minus_d = __fsub_rn(1.f, d);
  const bool clip = !(norm < H[H_MAX_NORM]);
  const float* gp = t.g[l];
  const float* pp = t.p[l];
  const MuT* mp = static_cast<const MuT*>(t.m[l]);
  const float* vp = t.v[l];
  const EmaT* ep = static_cast<const EmaT*>(t.e[l]);
  float* po = o.p + t.off[l];
  MuT* mo = static_cast<MuT*>(o.m) + t.off[l];
  float* vo = o.v + t.off[l];
  EmaT* eo = ep != nullptr ? static_cast<EmaT*>(o.e) + t.eoff[l] : nullptr;
  for (long long i0 = begin + threadIdx.x; i0 < end; i0 += THREADS * UNROLL) {
    float g[UNROLL], p[UNROLL], m[UNROLL], v[UNROLL], e[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = i0 + (long long)u * THREADS;
      g[u] = p[u] = m[u] = v[u] = e[u] = 0.f;
      if (i < end) {
        if (gp != nullptr) g[u] = gp[i];
        p[u] = pp[i];
        m[u] = load(mp, i);
        v[u] = vp[i];
        if (ep != nullptr) e[u] = load(ep, i);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = i0 + (long long)u * THREADS;
      if (i < end) {
        float gu = g[u];
        if (clip) gu = __fmul_rn(__fdiv_rn(gu, norm), H[H_MAX_NORM]);
        const float mu = __fadd_rn(__fmul_rn(H[H_ONE_MINUS_B1], gu),
                                   rounded<MuT>(__fmul_rn(H[H_B1_MU], m[u])));
        const float nu = __fadd_rn(__fmul_rn(H[H_ONE_MINUS_B2], __fmul_rn(gu, gu)),
                                   __fmul_rn(H[H_B2], v[u]));
        const float adam = __fdiv_rn(__fdiv_rn(mu, c1),
                                     __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, c2)), H[H_EPS]));
        const float pn =
            __fadd_rn(p[u], __fmul_rn(neg_lr, __fadd_rn(adam, __fmul_rn(H[H_WD], p[u]))));
        po[i] = pn;
        store(mo, i, mu);
        vo[i] = nu;
        if (ep != nullptr) store(eo, i, __fadd_rn(__fmul_rn(d, e[u]), __fmul_rn(one_minus_d, pn)));
      }
    }
  }
}

template <typename MuT, typename EmaT>
cudaError_t launch_updates(const std::vector<Leaves>& tables, const Outs& o, const Hyper& h,
                           cudaStream_t s) {
  for (const Leaves& t : tables) {
    if (t.blocks == 0) continue;
    update_kernel<MuT, EmaT><<<t.blocks, THREADS, 0, s>>>(t, o, h);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// leaves: n_leaves rows of LEAF_FIELDS int64: the addresses of g, p, mu, nu
// and the EMA copy (g and the EMA may be 0), the leaf's offset into the flat
// p', mu', nu', its offset into the flat e', and its element count.
// first_block: each leaf's first block within its launch. launches:
// n_launches rows of (first leaf, end leaf, grid, first partial), from
// ops/d2v_update.py::update_plan; a plan that does not match the leaves
// returns cudaErrorInvalidValue before any launch. norm: the gradients'
// global norm, or null to take it here into scratch (n_partials partials,
// the sum of the grids, then the norm). neg_lr, c1, c2, decay: the step's
// scalars. All scalars are f32 on the device. mu_bf16 and ema_bf16: the
// storage types (0 f32, 1 bf16), mu's in and out alike.
int d2v_update(const long long* leaves, int n_leaves, const int* first_block,
               const int* launches, int n_launches, int mu_bf16, int ema_bf16, void* out_p,
               void* out_m, void* out_v, void* out_e, float* scratch, int n_partials,
               const float* norm, const float* neg_lr, const float* c1, const float* c2,
               const float* decay, const float* hyper, int n_hyper, void* stream) {
  if (n_hyper != H_COUNT || n_leaves < 0 || n_launches < 0 || n_partials < 0 ||
      neg_lr == nullptr || c1 == nullptr || c2 == nullptr || decay == nullptr ||
      (norm == nullptr && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Hyper h;
  for (int i = 0; i < H_COUNT; ++i) h.v[i] = hyper[i];

  std::vector<Leaves> tables(n_launches);
  int next_leaf = 0, partials = 0;
  for (int j = 0; j < n_launches; ++j) {
    const int* row = launches + 4 * j;
    const int lo = row[0], hi = row[1];
    if (lo != next_leaf || hi - lo < 1 || hi - lo > MAX_LEAVES || hi > n_leaves || row[2] < 0)
      return (int)cudaErrorInvalidValue;
    Leaves& t = tables[j];
    t.n = hi - lo;
    t.blocks = row[2];
    t.partial_base = row[3];
    if (norm == nullptr && row[3] != partials) return (int)cudaErrorInvalidValue;
    long long blocks = 0;
    for (int i = lo; i < hi; ++i) {
      const long long* f = leaves + (long long)LEAF_FIELDS * i;
      if (f[7] < 0 || first_block[i] != blocks) return (int)cudaErrorInvalidValue;
      const int k = i - lo;
      t.start[k] = first_block[i];
      t.g[k] = reinterpret_cast<const float*>(f[0]);
      t.p[k] = reinterpret_cast<const float*>(f[1]);
      t.m[k] = reinterpret_cast<const void*>(f[2]);
      t.v[k] = reinterpret_cast<const float*>(f[3]);
      t.e[k] = reinterpret_cast<const void*>(f[4]);
      t.off[k] = f[5];
      t.eoff[k] = f[6];
      t.numel[k] = f[7];
      blocks += (f[7] + CHUNK - 1) / CHUNK;
    }
    if (blocks != t.blocks) return (int)cudaErrorInvalidValue;
    t.start[t.n] = t.blocks;
    partials += t.blocks;
    next_leaf = hi;
  }
  if (next_leaf != n_leaves || (norm == nullptr && partials != n_partials))
    return (int)cudaErrorInvalidValue;

  cudaError_t err = cudaSuccess;
  if (norm == nullptr) {
    for (const Leaves& t : tables) {
      if (t.blocks == 0) continue;
      sumsq_kernel<<<t.blocks, THREADS, 0, s>>>(t, scratch);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    finalize_kernel<<<1, FINAL_THREADS, 0, s>>>(scratch, n_partials, scratch + n_partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    norm = scratch + n_partials;
  }

  const Outs o{static_cast<float*>(out_p), out_m, static_cast<float*>(out_v), out_e,
               Scalars{norm, neg_lr, c1, c2, decay}};
  if (mu_bf16 && ema_bf16) err = launch_updates<__nv_bfloat16, __nv_bfloat16>(tables, o, h, s);
  else if (mu_bf16) err = launch_updates<__nv_bfloat16, float>(tables, o, h, s);
  else if (ema_bf16) err = launch_updates<float, __nv_bfloat16>(tables, o, h, s);
  else err = launch_updates<float, float>(tables, o, h, s);
  return (int)err;
}

}  // extern "C"
