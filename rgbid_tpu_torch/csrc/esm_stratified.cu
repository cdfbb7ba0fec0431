// Depth-stratified ESM sums for the motion-consensus vote: the (K, 50) raw
// per-stratum sums of 21 H, 6 b, the valid count, the weighted error and 21
// geometry-Gram entries, in one launch.
//
// Replaces: no Pallas kernel. The JAX package left this reduction to XLA:
// rgbid_tpu/ops/gauss_newton.py:434, stratified_normal_eq, which forms the
// (N, 50) per-pixel matrix and multiplies it by the (K, N) one-hot stratum
// matrix. Written in plain PyTorch that is ~150 small ops per vote on a
// frame whose time is host launch overhead already, so it is a hand kernel:
// the ESM per-pixel math of the IRLS kernel (esm_pixel.cuh, the same float
// order), the stratum from the template's inverse depth against the K+1
// edges it receives as parameters (searchsorted side="right" minus 1,
// clamped to [0, K-1]), and the 50 quantities, times the template mask (the
// one-hot entry), summed per stratum.
//
// Design: one pass over the template for all strata. A warp takes 32
// neighbouring template pixels; each lane finds its pixel's stratum and
// computes its ESM point once. __match_any_sync groups the lanes by
// stratum (depth strata are spatially coherent, so most warps hold one or
// two groups). For each group the warp sums the 50 terms of its lanes
// (other lanes give 0) with a transpose reduction, 31 shuffles per 32
// values, after which lane l holds column l; lane l adds it to the warp's
// own shared row [warp][stratum][50]. The block sums its warps' rows in
// warp order and stores the result, at its rank, into the shared memory of
// rank 0 of its 16-block thread-block cluster (distributed shared memory;
// cudaLaunchAttributeClusterDimension, a non-portable size); after one
// cluster barrier rank 0 sums the 16 rows in rank order. A launch has one cluster
// per 16 x 256 pixels (at most ``partial_rows``; 5 clusters, 80 SMs, at
// the vote layouts' 19.2k pixels); each cluster's rank 0 writes a row of
// partials and the last to arrive sums those few rows in cluster order.
// No float is added atomically and every order is fixed, so a rerun is
// bit-identical.
//
// The design this replaced was a (blocks per stratum, K) grid: six blocks
// covered every pixel, and the last block summed K x 50 columns over 64
// rows each (14 us at the vote layouts; 8.1-8.4 now, on an H100 80GB HBM3
// at 700 W, PERF.md). One 16-block cluster for the whole template, which
// would need no global partials, took 14.6-15.0 us: 16 SMs of 132 are too
// few for the per-pixel work (tools/irls_variants.py).
//
// What bounds it on this card: the bytes (10 template planes of 19.2k
// pixels and the 7-plane current stack at the vote levels L2 and L1,
// 1.3-2.9 MB, 0.4-0.9 us at 3.35 TB/s) are far below the launch, the
// gather's dependent reads (~2.9 us with the per-pixel work) and the tail
// (block sums, the cluster barrier, the arrival and the last rows, ~2.9 us).
//
// Storage types: the points and the current stack are float32 or bfloat16
// each (TrackingConfig.plane_dtype; the vote reads the f32 template
// intensity with the tracker's bf16 points and stack under "bf16"), one
// instantiation per mix and stack depth: 12.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>

#include "esm_pixel.cuh"
#include "irls_common.cuh"

namespace cg = cooperative_groups;

constexpr int kMaxStrata = 16;

// Must match StrataParams in ops/_build.py field by field.
struct StrataParams {
  int k;                          // strata
  float edges[kMaxStrata + 1];    // K+1 ascending inverse-depth edges
};

namespace {

constexpr int kSums = 50;
constexpr int kClusterBlocks = 16;  // above the portable 8: needs the opt-in below
constexpr int kBlockThreads = 256;
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kPixelsPerThread = 1;  // pixels a thread takes before the launch adds a cluster
constexpr int kSmemBytes =
    (kBlockWarps + kClusterBlocks) * kMaxStrata * kSums * static_cast<int>(sizeof(float));

// searchsorted(edges, x, side="right") - 1, clamped to [0, K-1]: the count
// of edges not above x, minus one (a NaN counts as above every edge).
// The loop runs over every slot with constant indices, so the edges stay
// parameters and are not copied to local memory.
__device__ __forceinline__ int stratum_of(float x, const StrataParams& sp) {
  int count = 0;
#pragma unroll
  for (int j = 0; j <= kMaxStrata; ++j) count += (j > sp.k || x < sp.edges[j]) ? 0 : 1;
  return min(max(count - 1, 0), sp.k - 1);
}

// One pixel's 50 terms times its mask value, in STRATIFIED_SUMS order.
__device__ __forceinline__ void pixel_terms(const esm::Point& q, int use_geometric, float m,
                                            float (&t)[kSums]) {
  int j = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int c = a; c < 6; ++c) {
      float s = q.w_i * q.Ji[a] * q.Ji[c];
      if (use_geometric) s = s + q.w_x * q.Jx[a] * q.Jx[c];
      t[j++] = m * s;
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float s = q.w_i * q.Ji[a] * q.r_i;
    if (use_geometric) s = s + q.w_x * q.Jx[a] * q.r_x;
    t[21 + a] = m * s;
  }
  t[27] = m * q.valid;
  float e = q.w_i * q.r_i * q.r_i;
  if (use_geometric) e = e + q.w_x * q.r_x * q.r_x;
  t[28] = m * e;
  j = 29;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int c = a; c < 6; ++c) t[j++] = m * (q.valid * (q.ju[a] * q.ju[c] + q.jv[a] * q.jv[c]));
  }
}

// One round of transpose_sum: each lane keeps the half of v[0, 2S) that
// its bit S selects and adds its partner's copy of that half into v[0, S).
// S is a template parameter so that every index is a constant and ``v``
// stays in registers (a loop over S is not unrolled, and its indices would
// move ``v`` to local memory).
template <int S>
__device__ __forceinline__ void transpose_round(float (&v)[32], int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float lo = v[j];
    const float hi = v[j + S];
    v[j] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, S);
  }
}

// The warp's sum of v[l] arrives in lane l after five rounds (16, 8, 4, 2
// and 1 shuffles). The tree is fixed, so the sums are too.
__device__ __forceinline__ float transpose_sum(float (&v)[32], int lane) {
  transpose_round<16>(v, lane);
  transpose_round<8>(v, lane);
  transpose_round<4>(v, lane);
  transpose_round<2>(v, lane);
  transpose_round<1>(v, lane);
  return v[0];
}

template <int C, typename PtT, typename StackT>
__global__ void __launch_bounds__(kBlockThreads, 1)
esm_stratified_kernel(EsmParams p, StrataParams sp, const float* __restrict__ T,
                      const float* __restrict__ s2i_p, const float* __restrict__ s2x_p,
                      const float* __restrict__ kf_int, const PtT* __restrict__ px,
                      const PtT* __restrict__ py, const PtT* __restrict__ pz,
                      const float* __restrict__ kf_mask, const float* __restrict__ kf_grads,
                      const StackT* __restrict__ cur, const float* __restrict__ xi,
                      float* __restrict__ partials, unsigned int* __restrict__ counter,
                      float* __restrict__ out) {
  // [kBlockWarps][K][kSums] warp rows, then (read in rank 0 only)
  // [kClusterBlocks][K][kSums] block rows.
  extern __shared__ float rows[];
  cg::cluster_group cluster = cg::this_cluster();
  const int row = sp.k * kSums;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < kBlockWarps * row; j += kBlockThreads) rows[j] = 0.f;
  // A block may touch another's shared memory only once that block runs:
  // arrive on the cluster barrier now and wait before the first remote
  // store, so the pixel loop hides the wait.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  __syncthreads();

  const float s2i = *s2i_p;
  const float s2x = *s2x_p;
  float* wrow = rows + warp * row;
  // ``base`` is the same in every lane, so the loop and its shuffles are
  // warp-uniform.
  for (int base = blockIdx.x * kBlockThreads + warp * 32; base < p.n;
       base += gridDim.x * kBlockThreads) {
    const int i = base + lane;
    float m = 0.f;
    int k = -1;  // no stratum: past the end or masked out
    if (i < p.n) {
      m = kf_mask[i];
      if (m != 0.f) k = stratum_of(xi[i], sp);
    }
    unsigned int todo = __ballot_sync(0xffffffffu, k >= 0);
    if (todo == 0u) continue;
    const unsigned int peers = __match_any_sync(0xffffffffu, k);
    esm::Point q = {};
    if (k >= 0) q = esm::point<C>(p, i, T, s2i, s2x, kf_int, px, py, pz, kf_mask, kf_grads, cur);
    while (todo != 0u) {
      const int leader = __ffs(todo) - 1;
      const unsigned int group = __shfl_sync(0xffffffffu, peers, leader);
      const int kk = __shfl_sync(0xffffffffu, k, leader);
      todo &= ~group;
      const bool mine = ((group >> lane) & 1u) != 0u;
      float t[kSums];
      pixel_terms(q, p.use_geometric, m, t);
      float v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = mine ? t[j] : 0.f;
      const float lo = transpose_sum(v, lane);
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = (mine && j + 32 < kSums) ? t[(j + 32) % kSums] : 0.f;
      const float hi = transpose_sum(v, lane);
      float* dst = wrow + kk * kSums;
      dst[lane] += lo;
      if (lane + 32 < kSums) dst[lane + 32] += hi;
    }
  }
  __syncthreads();

  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // The block's sums: its warps' rows in warp order, stored into rank 0's
  // shared memory at this block's rank (distributed shared memory).
  const unsigned int rank = cluster.block_rank();
  float* slot = cluster.map_shared_rank(rows + kBlockWarps * row, 0) + rank * row;
  for (int j = threadIdx.x; j < row; j += kBlockThreads) {
    float s = 0.f;
    for (int w = 0; w < kBlockWarps; ++w) s += rows[w * row + j];
    slot[j] = s;
  }
  cluster.sync();  // the stores are visible to rank 0; the other blocks are done
  if (rank != 0) return;

  // Rank 0: the cluster's block rows in rank order, one row of partials.
  const float* slots = rows + kBlockWarps * row;
  float* dst = partials + (blockIdx.x / kClusterBlocks) * row;
  for (int j = threadIdx.x; j < row; j += kBlockThreads) {
    float s = 0.f;
    for (int b = 0; b < kClusterBlocks; ++b) s += slots[b * row + j];
    dst[j] = s;
  }

  // The last rank-0 block to arrive sums the cluster rows in cluster order
  // (irls_common.cuh's last-block pattern).
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  const unsigned int clusters = gridDim.x / kClusterBlocks;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == clusters - 1u;
  __syncthreads();
  if (!last) return;
  for (int j = threadIdx.x; j < row; j += kBlockThreads) {
    float s = 0.f;
    for (unsigned int c = 0; c < clusters; ++c) s += __ldcg(partials + c * row + j);
    out[j] = s;
  }
  if (threadIdx.x == 0) *counter = 0u;
}

template <int C, typename PtT, typename StackT>
cudaError_t launch(const EsmParams& p, const StrataParams& sp, int partial_rows, const float* T,
                   const float* s2i, const float* s2x, const float* kf_int, const void* px_v,
                   const void* py_v, const void* pz_v, const float* kf_mask,
                   const float* kf_grads, const void* cur_v, const float* xi, float* partials,
                   unsigned int* counter, float* out, cudaStream_t st) {
  auto* kernel = esm_stratified_kernel<C, PtT, StackT>;
  const PtT* px = static_cast<const PtT*>(px_v);
  const PtT* py = static_cast<const PtT*>(py_v);
  const PtT* pz = static_cast<const PtT*>(pz_v);
  const StackT* cur = static_cast<const StackT*>(cur_v);
  const int want = (p.n + kClusterBlocks * kBlockThreads * kPixelsPerThread - 1) /
                   (kClusterBlocks * kBlockThreads * kPixelsPerThread);
  const int clusters = max(1, min(want, partial_rows));
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterBlocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kClusterBlocks);
  cfg.blockDim = dim3(kBlockThreads);
  cfg.dynamicSmemBytes = (kBlockWarps + kClusterBlocks) * sp.k * kSums * sizeof(float);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;

  // Once per card: allow the non-portable cluster size and the shared rows
  // of 16 strata (above the 48 KB default), and make sure one such cluster
  // fits on the card at all.
  static std::atomic<unsigned long long> ready{0ull};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if ((ready.load() & bit) == 0ull) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t most = cfg;
    most.gridDim = dim3(kClusterBlocks);
    most.dynamicSmemBytes = kSmemBytes;
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, kernel, &most);
    if (e != cudaSuccess) return e;
    if (active < 1) return cudaErrorLaunchOutOfResources;
    ready.fetch_or(bit);
  }
  e = cudaLaunchKernelEx(&cfg, kernel, p, sp, T, s2i, s2x, kf_int, px, py, pz, kf_mask, kf_grads,
                         cur, xi, partials, counter, out);
  const cudaError_t last = cudaGetLastError();  // clears what a refused launch left
  return e != cudaSuccess ? e : last;
}

template <typename PtT, typename StackT>
cudaError_t by_channels(int channels, const EsmParams& p, const StrataParams& sp,
                        int partial_rows, const float* T, const float* s2i, const float* s2x,
                        const float* kf_int, const void* px, const void* py, const void* pz,
                        const float* kf_mask, const float* kf_grads, const void* cur,
                        const float* xi, float* partials, unsigned int* counter, float* out,
                        cudaStream_t st) {
  switch (channels) {
    case 3:
      return launch<3, PtT, StackT>(p, sp, partial_rows, T, s2i, s2x, kf_int, px, py, pz,
                                    kf_mask, kf_grads, cur, xi, partials, counter, out, st);
    case 5:
      return launch<5, PtT, StackT>(p, sp, partial_rows, T, s2i, s2x, kf_int, px, py, pz,
                                    kf_mask, kf_grads, cur, xi, partials, counter, out, st);
    case 7:
      return launch<7, PtT, StackT>(p, sp, partial_rows, T, s2i, s2x, kf_int, px, py, pz,
                                    kf_mask, kf_grads, cur, xi, partials, counter, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One vote's reduction: out (K * 50 floats, row-major (K, 50)). ``types``:
// bit 1 the points are bf16, bit 2 the current stack (bit 0, a bf16
// template intensity, has no instantiation). ``partials`` holds
// ``partial_rows`` (>= 1) rows of K * 50 floats, one per cluster;
// ``counter`` is 0 on entry and is 0 again when the launch ends. Returns
// the CUDA status of the launch.
extern "C" int esm_stratified_launch(EsmParams p, StrataParams sp, int channels, int types,
                                     int partial_rows, const float* T, const float* s2i,
                                     const float* s2x, const float* kf_int, const void* px,
                                     const void* py, const void* pz, const float* kf_mask,
                                     const float* kf_grads, const void* cur, const float* xi,
                                     float* partials, unsigned int* counter, float* out,
                                     void* stream) {
  if (sp.k < 1 || sp.k > kMaxStrata || partial_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t e;
  switch (types) {
    case 0:
      e = by_channels<float, float>(channels, p, sp, partial_rows, T, s2i, s2x, kf_int, px, py,
                                    pz, kf_mask, kf_grads, cur, xi, partials, counter, out, st);
      break;
    case 2:
      e = by_channels<bf, float>(channels, p, sp, partial_rows, T, s2i, s2x, kf_int, px, py, pz,
                                 kf_mask, kf_grads, cur, xi, partials, counter, out, st);
      break;
    case 4:
      e = by_channels<float, bf>(channels, p, sp, partial_rows, T, s2i, s2x, kf_int, px, py, pz,
                                 kf_mask, kf_grads, cur, xi, partials, counter, out, st);
      break;
    case 6:
      e = by_channels<bf, bf>(channels, p, sp, partial_rows, T, s2i, s2x, kf_int, px, py, pz,
                              kf_mask, kf_grads, cur, xi, partials, counter, out, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
