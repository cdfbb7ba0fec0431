// Depth-stratified ESM sums for the motion-consensus vote: the (K, 50) raw
// per-stratum sums of 21 H, 6 b, the valid count, the weighted error and 21
// geometry-Gram entries, in one launch.
//
// Replaces: no Pallas kernel. The JAX package left this reduction to XLA:
// rgbid_tpu/ops/gauss_newton.py:434, stratified_normal_eq, which forms the
// (N, 50) per-pixel matrix and multiplies it by the (K, N) one-hot stratum
// matrix. Written in plain PyTorch that is ~150 small ops per vote on a
// frame whose time is host launch overhead already, so it is a hand
// kernel: a thread does the ESM per-pixel math of the IRLS kernel
// (esm_pixel.cuh, the same float order) for each template pixel of its
// stratum, finds the stratum from the template's inverse depth against the
// K+1 edges it receives as parameters (searchsorted side="right" minus 1,
// clamped to [0, K-1]), and adds the 50 quantities, times the template
// mask (the one-hot entry), to its sums.
//
// Design: the grid is (blocks per stratum, K); blockIdx.y is the stratum.
// 50 sums a thread for one stratum fit in registers, where 6 x 50 would
// not. Every block reads the inverse depth and mask of its share of the
// template and does the per-pixel math only for its own stratum's pixels,
// so the math runs once per pixel and the K-fold part is two plane reads
// (L2). A block reduces its 50 sums into one row of partials (block index
// k * blocks + b); the last block to arrive (irls_common.cuh) sums each
// stratum's rows in block-index order and writes the (K, 50) output. No
// float is added atomically, so a rerun is bit-identical.
//
// What bounds it on this card: the bytes (10 template planes of 4.8k-19k
// pixels and the 7-plane current stack at the vote levels L2 and L1,
// 0.7-2.9 MB, 0.2-0.9 us at 3.35 TB/s) are far below the launch latency,
// the gather's dependent reads and the serial cross-block tail, as for the
// IRLS kernels; the design keeps the vote at one launch.

#include <cuda_runtime.h>

#include "esm_pixel.cuh"
#include "irls_common.cuh"

constexpr int kMaxStrata = 16;

// Must match StrataParams in ops/_build.py field by field.
struct StrataParams {
  int k;                          // strata
  float edges[kMaxStrata + 1];    // K+1 ascending inverse-depth edges
};

namespace {

using irls::kThreads;
constexpr int kSums = 50;

// searchsorted(edges, x, side="right") - 1, clamped to [0, K-1]: the count
// of edges not above x, minus one (a NaN counts as above every edge).
__device__ __forceinline__ int stratum_of(float x, const StrataParams& sp) {
  int count = 0;
  for (int j = 0; j <= sp.k; ++j) count += (x < sp.edges[j]) ? 0 : 1;
  return min(max(count - 1, 0), sp.k - 1);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
esm_stratified_kernel(EsmParams p, StrataParams sp, const float* __restrict__ T,
                      const float* __restrict__ s2i_p, const float* __restrict__ s2x_p,
                      const float* __restrict__ kf_int, const float* __restrict__ px,
                      const float* __restrict__ py, const float* __restrict__ pz,
                      const float* __restrict__ kf_mask, const float* __restrict__ kf_grads,
                      const float* __restrict__ cur, const float* __restrict__ xi,
                      float* __restrict__ partials, unsigned int* __restrict__ counter,
                      float* __restrict__ out) {
  const int k = blockIdx.y;
  float acc[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) acc[j] = 0.f;
  const float s2i = *s2i_p;
  const float s2x = *s2x_p;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.n; i += gridDim.x * kThreads) {
    const float m = kf_mask[i];
    if (m == 0.f || stratum_of(xi[i], sp) != k) continue;
    const esm::Point q =
        esm::point<C>(p, i, T, s2i, s2x, kf_int, px, py, pz, kf_mask, kf_grads, cur);
    int t = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int c = a; c < 6; ++c) {
        float s = q.w_i * q.Ji[a] * q.Ji[c];
        if (p.use_geometric) s = s + q.w_x * q.Jx[a] * q.Jx[c];
        acc[t++] += m * s;
      }
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      float s = q.w_i * q.Ji[a] * q.r_i;
      if (p.use_geometric) s = s + q.w_x * q.Jx[a] * q.r_x;
      acc[21 + a] += m * s;
    }
    acc[27] += m * q.valid;
    float e = q.w_i * q.r_i * q.r_i;
    if (p.use_geometric) e = e + q.w_x * q.r_x * q.r_x;
    acc[28] += m * e;
    t = 29;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int c = a; c < 6; ++c) {
        acc[t++] += m * (q.valid * (q.ju[a] * q.ju[c] + q.jv[a] * q.jv[c]));
      }
    }
  }
  irls::block_reduce<kSums>(acc, partials + (k * gridDim.x + blockIdx.x) * kSums);
  if (!irls::last_to_arrive(counter, kSums)) return;

  // The last block: each stratum's rows in block-index order.
  for (int s = threadIdx.x; s < sp.k * kSums; s += kThreads) {
    const int kk = s / kSums;
    const float* rows = partials + kk * gridDim.x * kSums + (s - kk * kSums);
    float tot = 0.f;
    for (int b = 0; b < gridDim.x; ++b) tot += __ldcg(rows + b * kSums);
    out[s] = tot;
  }
  if (threadIdx.x == 0) *counter = 0u;
}

}  // namespace

// One vote's reduction: out (K * 50 floats, row-major (K, 50)). ``partials``
// holds ``partial_rows`` rows of 50 floats; ``counter`` is 0 on entry and is
// 0 again when the launch ends.
extern "C" int esm_stratified_launch(EsmParams p, StrataParams sp, int channels,
                                     int blocks_per_stratum, int partial_rows, const float* T,
                                     const float* s2i, const float* s2x, const float* kf_int,
                                     const float* px, const float* py, const float* pz,
                                     const float* kf_mask, const float* kf_grads,
                                     const float* cur, const float* xi, float* partials,
                                     unsigned int* counter, float* out, void* stream) {
  if (sp.k < 1 || sp.k > kMaxStrata) return static_cast<int>(cudaErrorInvalidValue);
  const int bx = max(1, min((p.n + kThreads - 1) / kThreads, blocks_per_stratum));
  if (bx * sp.k > partial_rows) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(bx, sp.k);
  switch (channels) {
    case 3:
      esm_stratified_kernel<3><<<grid, kThreads, 0, st>>>(
          p, sp, T, s2i, s2x, kf_int, px, py, pz, kf_mask, kf_grads, cur, xi, partials, counter,
          out);
      break;
    case 5:
      esm_stratified_kernel<5><<<grid, kThreads, 0, st>>>(
          p, sp, T, s2i, s2x, kf_int, px, py, pz, kf_mask, kf_grads, cur, xi, partials, counter,
          out);
      break;
    case 7:
      esm_stratified_kernel<7><<<grid, kThreads, 0, st>>>(
          p, sp, T, s2i, s2x, kf_int, px, py, pz, kf_mask, kf_grads, cur, xi, partials, counter,
          out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
