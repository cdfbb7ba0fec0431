// ESM residuals + Student-t weights + 6x6 normal equations + the damped
// solve and pose update: one whole IRLS iteration in one launch.
//
// Replaces: rgbid_tpu/ops/pallas_kernels.py, _esm_kernel (entry
// esm_residuals_and_normal_eq_pallas), and the ic_update that follows it
// in the tracker's loop. On the TPU the warp (transform_project) and the
// 4-corner bilinear gather stayed in XLA and the kernel read pre-gathered
// planes; here a thread does all of it for each template pixel of a
// grid-stride loop: project the template point through T, gather the
// C-channel current stack (C = 3, 5 or 7), form both residuals, the
// occlusion-gated Student-t weights, the warp and exact inverse-depth
// prediction Jacobians with ESM gradient averaging, and add the 32
// per-pixel terms (21 upper-triangle H, 6 b, error, inlier, valid, 2
// lagged-sigma statistics) to its sums. A block reduces them (warp
// shuffles, then shared memory) into one row of (blocks, 32) partials; the
// last block to finish sums the rows in a fixed order, writes the
// per-pixel-normalized result, and one of its threads solves
// (H + damping I) delta = b and writes T' = orthonormalize(T exp(-delta))
// (irls_common.cuh, irls_solve.cuh).
//
// What bounds it on this card: at the tracker's sizes (4.8k-77k template
// pixels, 0.3-6.5 MB read per iteration, about 250 flops a pixel) the
// bytes are 0.1-2 us of bandwidth, so launch latency, the gather's
// dependent reads and the serial tail (cross-block sum, 6x6 solve) bound
// it. The design makes one iteration one launch with nothing else on the
// stream: T, the sigmas and the damping come in through device pointers
// and the params, and T' and the next sigmas go out to device memory, so
// the tracker's loop never runs another op or waits on the host. The grid
// is at most a few blocks per SM (the wrapper's max_blocks), so the last
// block sums a bounded number of rows. Tensor cores and TMA have no part:
// the work per pixel is a projection, a gather and 32 sums.
//
// Determinism: the one atomic counts block arrivals; no float is added
// atomically. Every sum is taken in a fixed order, so the same input on
// the same card gives bit-identical output from run to run.
//
// Float order: the per-pixel arithmetic follows the plain PyTorch version
// (ops/gauss_newton.py) operation by operation and the build disables FMA
// contraction (-fmad=false), so the counts (valid pixels, inliers) equal
// the plain version's exactly and the sums differ only by summation order.
// The per-pixel math is shared with the stratified vote reduction
// (esm_pixel.cuh); the warp, gather, reductions and the end of the
// iteration with the IC kernel (irls_common.cuh).
//
// Storage types: the template intensity, the points and the current stack
// are float32 or bfloat16 (TrackingConfig.plane_dtype; esm_pixel.cuh), one
// instantiation per mix the tracker uses (intensity and points f32/f32,
// bf16/bf16 or f32/bf16, each with an f32 or bf16 stack) and per stack
// depth: 18. A bf16 plane halves that plane's bytes; the math is f32.
//
// Early exit: a launch given the previous iteration's output (``prev``)
// returns at entry, after block 0 copies ``prev`` to ``out``, when that
// iteration's step norm is <= p.tol (irls::converged). The host still
// enqueues every iteration of the budget; a skipped launch costs its
// launch and one read of 6 floats, and leaves the workspace untouched.
//
// Predicate: a launch given a device word ``go`` returns at entry when the
// word is 0, after block 0 copies ``hold`` to ``out`` (irls::held): the
// consensus's masked reruns and the rescue pyramid are always enqueued and
// run only when their vote says so.

#include <cuda_runtime.h>

#include "esm_pixel.cuh"
#include "irls_common.cuh"

namespace {

using irls::kNormalSums;
using irls::kThreads;

// One template pixel's 32 terms, added to acc.
template <int C, typename IntT, typename PtT, typename StackT>
__device__ __forceinline__ void esm_pixel(
    const EsmParams& p, int i, const float* __restrict__ T, float s2i, float s2x,
    const IntT* __restrict__ kf_int, const PtT* __restrict__ px,
    const PtT* __restrict__ py, const PtT* __restrict__ pz,
    const float* __restrict__ kf_mask, const float* __restrict__ kf_grads,
    const StackT* __restrict__ cur, float (&acc)[kNormalSums]) {
  const esm::Point q =
      esm::point<C>(p, i, T, s2i, s2x, kf_int, px, py, pz, kf_mask, kf_grads, cur);
  int t = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int c = a; c < 6; ++c) {
      float s = q.w_i * q.Ji[a] * q.Ji[c];
      if (p.use_geometric) s = s + q.w_x * q.Jx[a] * q.Jx[c];
      acc[t++] += s;
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float s = q.w_i * q.Ji[a] * q.r_i;
    if (p.use_geometric) s = s + q.w_x * q.Jx[a] * q.r_x;
    acc[21 + a] += s;
  }
  float e = q.w_i * q.r_i * q.r_i;
  if (p.use_geometric) e = e + q.w_x * q.r_x * q.r_x;
  acc[27] += e;
  acc[28] += q.valid * ((q.r_i * q.r_i < p.gate2 * s2i) ? 1.f : 0.f);
  acc[29] += q.valid;
  acc[30] += q.valid * q.w0i * q.r_i * q.r_i;
  acc[31] += q.valid * q.w0x * q.r_x * q.r_x;
}

template <int C, typename IntT, typename PtT, typename StackT>
__global__ void __launch_bounds__(kThreads, irls::kMinBlocksPerSm)
esm_kernel(EsmParams p, const float* __restrict__ T, const float* __restrict__ s2i_p,
           const float* __restrict__ s2x_p, const IntT* __restrict__ kf_int,
           const PtT* __restrict__ px, const PtT* __restrict__ py,
           const PtT* __restrict__ pz, const float* __restrict__ kf_mask,
           const float* __restrict__ kf_grads, const StackT* __restrict__ cur,
           float* __restrict__ partials, unsigned int* __restrict__ counter,
           float* __restrict__ out, const float* __restrict__ prev,
           unsigned int* __restrict__ runs, const int* __restrict__ go,
           const float* __restrict__ hold) {
  if (irls::held(go, hold, out)) return;
  if (irls::converged(prev, p.tol, out)) return;
  float acc[kNormalSums];
#pragma unroll
  for (int k = 0; k < kNormalSums; ++k) acc[k] = 0.f;
  const float s2i = *s2i_p;
  const float s2x = *s2x_p;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.n; i += gridDim.x * kThreads) {
    esm_pixel<C>(p, i, T, s2i, s2x, kf_int, px, py, pz, kf_mask, kf_grads, cur, acc);
  }
  irls::block_reduce<kNormalSums>(acc, partials + blockIdx.x * kNormalSums);
  irls::finish_iteration(partials, counter, s2i, s2x, p.use_geometric, /*lagged=*/1, T,
                         p.damping, out, runs);
}

// The launch's pointers, typed at dispatch.
struct EsmArgs {
  const float* T;
  const float* s2i;
  const float* s2x;
  const void* kf_int;
  const void* px;
  const void* py;
  const void* pz;
  const float* kf_mask;
  const float* kf_grads;
  const void* cur;
  float* partials;
  unsigned int* counter;
  float* out;
  const float* prev;
  unsigned int* runs;
  const int* go;
  const float* hold;
};

template <int C, typename IntT, typename PtT, typename StackT>
void launch(const EsmParams& p, int blocks, const EsmArgs& a, cudaStream_t st) {
  esm_kernel<C, IntT, PtT, StackT><<<blocks, kThreads, 0, st>>>(
      p, a.T, a.s2i, a.s2x, static_cast<const IntT*>(a.kf_int),
      static_cast<const PtT*>(a.px), static_cast<const PtT*>(a.py),
      static_cast<const PtT*>(a.pz), a.kf_mask, a.kf_grads, static_cast<const StackT*>(a.cur),
      a.partials, a.counter, a.out, a.prev, a.runs, a.go, a.hold);
}

template <typename IntT, typename PtT, typename StackT>
cudaError_t by_channels(int channels, const EsmParams& p, int blocks, const EsmArgs& a,
                        cudaStream_t st) {
  switch (channels) {
    case 3:
      launch<3, IntT, PtT, StackT>(p, blocks, a, st);
      return cudaSuccess;
    case 5:
      launch<5, IntT, PtT, StackT>(p, blocks, a, st);
      return cudaSuccess;
    case 7:
      launch<7, IntT, PtT, StackT>(p, blocks, a, st);
      return cudaSuccess;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One IRLS iteration: out (irls::kOut floats) = [result (48) | T' (16) |
// delta (6)]. ``types``: bit 0 the template intensity is bf16, bit 1 the
// points, bit 2 the current stack (ops/kernels.py); a bf16 intensity needs
// bf16 points. ``partials`` holds max_blocks rows of 32 floats; ``counter``
// is 0 on entry and is 0 again when the launch ends. ``prev``: the previous
// iteration's out, or nullptr; ``runs``: the level's slot of the count of
// iterations run, or nullptr; ``go``: the launch's predicate word, or
// nullptr, and ``hold`` the kOut floats it copies when the word is 0
// (irls::held).
extern "C" int esm_irls_launch(EsmParams p, int channels, int types, int max_blocks,
                               const float* T, const float* s2i, const float* s2x,
                               const void* kf_int, const void* px, const void* py,
                               const void* pz, const float* kf_mask, const float* kf_grads,
                               const void* cur, float* partials, unsigned int* counter,
                               float* out, const float* prev, unsigned int* runs,
                               const int* go, const float* hold, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = max(1, min((p.n + kThreads - 1) / kThreads, max_blocks));
  const EsmArgs a{T, s2i, s2x, kf_int, px, py, pz, kf_mask, kf_grads, cur, partials, counter,
                  out, prev, runs, go, hold};
  using bf = __nv_bfloat16;
  cudaError_t e;
  switch (types) {
    case 0: e = by_channels<float, float, float>(channels, p, blocks, a, st); break;
    case 2: e = by_channels<float, bf, float>(channels, p, blocks, a, st); break;
    case 3: e = by_channels<bf, bf, float>(channels, p, blocks, a, st); break;
    case 4: e = by_channels<float, float, bf>(channels, p, blocks, a, st); break;
    case 6: e = by_channels<float, bf, bf>(channels, p, blocks, a, st); break;
    case 7: e = by_channels<bf, bf, bf>(channels, p, blocks, a, st); break;
    default: e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
