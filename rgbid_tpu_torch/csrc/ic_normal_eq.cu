// Inverse-compositional (IC) IRLS: one whole IRLS iteration from a stored
// template Jacobian field, with the Student-t scale (sigma) steps of exact
// mode as phases of the same launch; and the sigma step alone.
//
// Replaces: rgbid_tpu/ops/pallas_kernels.py, _sigma_kernel (entry
// sigma_stats) and _normal_kernel (entry normal_eq), both reached through
// residuals_and_normal_eq_pallas, and the ic_update that follows them in
// the tracker's loop. On the TPU the warp (transform_project) and the
// 3-plane bilinear gather stayed in XLA and the kernels read five
// pre-gathered planes; here a thread does all of it for each template
// pixel of its grid-stride loop: project the template point through T,
// gather [I, xi, mask] from the current level, and form valid, r_i, r_x.
//   - sigma phase: valid * w(sigma2) * r^2 per channel and the valid
//     count (3 sums), one row per block; the updated scales are
//     max(s / max(n, 1), 1e-12) (the inverse-depth scale only when that
//     channel is on, else the incoming one);
//   - normal phase: Student-t weights from the scales (no occlusion gate),
//     the 12 stored Jacobian planes, and the 32 per-pixel terms of the ESM
//     kernel's layout (21 upper-triangle H, 6 b, error, inlier, valid, 2
//     lagged-sigma statistics), one row per block; the last block to
//     finish sums the rows, writes the result, solves the damped 6x6
//     system and writes the updated pose (irls_common.cuh,
//     irls_solve.cuh).
// Kernels:
//   - ic_normal_kernel (lagged mode, or the normal phase alone): the
//     normal phase with the incoming scales. One launch is one iteration.
//   - ic_exact_kernel (exact mode), a cooperative launch: max(sigma_iters,
//     1) sigma phases, each ending in a grid-wide barrier whose last block
//     to arrive sums every block's row in a fixed order and publishes the 3
//     sums before it releases the others; every block then forms the same,
//     bit-identical new scales from them, with no second barrier. (Every
//     block summing all rows itself, the other way to get there, measured
//     6 us slower at level 0 on an H100: 300 blocks reading the same rows
//     from L2 at once; PERF.md, tools/irls_variants.py.) Then the normal
//     phase weighted with those scales, and the last-block tail. One launch is one iteration; the result carries
//     the updated scales.
//   - ic_sigma_kernel: one sigma step alone (the counterpart of
//     sigma_stats, used by the checks): the sigma phase, then the last
//     block to arrive writes the raw sums and the updated scales.
// T and every scale are read through device pointers, so the tracker's
// loop never waits on the host and runs no other op.
// Early exit: both IRLS kernels take the previous iteration's output
// (``prev``) and return at entry when its step norm is <= p.tol
// (irls::converged; block 0 copies ``prev`` to ``out``). In the exact
// kernel every block takes that decision from the same floats before its
// first grid barrier, so no block waits on one that has left.
//
// What bounds it on this card: at the tracker's sizes (at most 77k template
// pixels) the normal phase reads 17 template planes and 3 current planes of
// 4 bytes (~8.9 MB at level 0, 2.7 us at 3.35 TB/s), so launch latency, the
// gather's dependent reads and the serial tail (cross-block sum, 6x6
// solve) bound it, with bytes close behind at level 0. A sigma phase
// re-reads 5 template planes and gathers the current planes again (mostly
// from L2) and adds a grid barrier, where the two-launch design it
// replaces paid two more launches per step. The Jacobian field is held as
// float32 carrying bfloat16-rounded values; real bf16 storage would halve
// the largest read.
//
// Determinism: the atomics count block arrivals; no float is added
// atomically. Every sum is taken in a fixed order, so the same input on the
// same card gives bit-identical output from run to run. Float order: the
// per-pixel arithmetic follows the plain PyTorch versions
// (ops/gauss_newton.py: sigma_stats_plain, normal_eq_plain) operation by
// operation and the build disables FMA contraction (-fmad=false), so the
// counts equal the plain versions' exactly.

#include <cuda_runtime.h>

#include "irls_common.cuh"

// Must match IcParams in ops/_build.py field by field.
struct IcParams {
  int n;              // template pixels (row-major template planes)
  int h, w;           // current-level height and width
  int use_geometric;  // inverse-depth channel enters H, b, the error and its scale
  float fx, fy, cx, cy;
  float nu;           // Student-t degrees of freedom
  float nu1;          // nu + 1
  float gate2;        // gate_sigmas^2 (inlier test)
  float umax, vmax;   // w - 1.001, h - 1.001
  float damping;      // Levenberg damping of the 6x6 solve (normal pass)
  float tol;          // early exit: skip once the previous step's norm <= tol
};

namespace {

using irls::kNormalSums;
using irls::kThreads;
constexpr int kSigmaSums = 3;

struct Residuals {
  float valid, r_i, r_x;
};

// Warp one template pixel and gather the current level's [I, xi, mask]
// (the plain versions' _ic_pointwise).
__device__ __forceinline__ Residuals ic_residuals(
    const IcParams& p, int i, const float* __restrict__ T, const float* __restrict__ kf_int,
    const float* __restrict__ px, const float* __restrict__ py, const float* __restrict__ pz,
    const float* __restrict__ kf_mask, const float* __restrict__ cur_int,
    const float* __restrict__ cur_xi, const float* __restrict__ cur_mask) {
  const irls::Projection pr = irls::project(T, px[i], py[i], pz[i], p.fx, p.fy, p.cx, p.cy);
  const irls::Corners cn = irls::corners(pr.up, pr.vp, p.h, p.w, p.umax, p.vmax);
  const float i_s = irls::blend(cur_int, cn);
  const float xi_s = irls::blend(cur_xi, cn);
  const float mask_ok = irls::corner_product(cur_mask, cn);
  Residuals q;
  q.valid = kf_mask[i] * pr.front * cn.inb * mask_ok;
  q.r_i = (i_s - kf_int[i]) * q.valid;
  q.r_x = (xi_s - pr.rho) * q.valid;
  return q;
}

// One template pixel's 3 sigma terms, added to acc.
__device__ __forceinline__ void ic_sigma_pixel(
    const IcParams& p, int i, const float* __restrict__ T, float s2i, float s2x,
    const float* __restrict__ kf_int, const float* __restrict__ px,
    const float* __restrict__ py, const float* __restrict__ pz,
    const float* __restrict__ kf_mask, const float* __restrict__ cur_int,
    const float* __restrict__ cur_xi, const float* __restrict__ cur_mask,
    float (&acc)[kSigmaSums]) {
  const Residuals q =
      ic_residuals(p, i, T, kf_int, px, py, pz, kf_mask, cur_int, cur_xi, cur_mask);
  const float w0i = irls::student_w0(q.r_i, s2i, p.nu, p.nu1);
  const float w0x = irls::student_w0(q.r_x, s2x, p.nu, p.nu1);
  acc[0] += q.valid * w0i * q.r_i * q.r_i;
  acc[1] += q.valid * w0x * q.r_x * q.r_x;
  acc[2] += q.valid;
}

// The sigma phase: this block's pixels of the grid-stride loop, reduced to
// one row of 3 partials at rows + 3 * blockIdx.x.
__device__ __forceinline__ void sigma_phase(
    const IcParams& p, const float* __restrict__ T, float s2i, float s2x,
    const float* __restrict__ kf_int, const float* __restrict__ px,
    const float* __restrict__ py, const float* __restrict__ pz,
    const float* __restrict__ kf_mask, const float* __restrict__ cur_int,
    const float* __restrict__ cur_xi, const float* __restrict__ cur_mask,
    float* __restrict__ rows) {
  float acc[kSigmaSums] = {0.f, 0.f, 0.f};
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.n; i += gridDim.x * kThreads) {
    ic_sigma_pixel(p, i, T, s2i, s2x, kf_int, px, py, pz, kf_mask, cur_int, cur_xi, cur_mask,
                   acc);
  }
  irls::block_reduce<kSigmaSums>(acc, rows + blockIdx.x * kSigmaSums);
}

// The updated scales from the 3 summed terms (sigma_stats_plain's order).
__device__ __forceinline__ void update_scales(const float* sums, int use_geometric, float& s2i,
                                              float& s2x) {
  const float n1 = irls::clamp_min(sums[2], 1.f);
  s2i = irls::clamp_min(sums[0] / n1, 1e-12f);
  if (use_geometric) s2x = irls::clamp_min(sums[1] / n1, 1e-12f);
}

// One sigma step alone. out[0:3] the raw sums (swi, swx, n); out[3],
// out[4] the updated scales.
__global__ void __launch_bounds__(kThreads)
ic_sigma_kernel(IcParams p, const float* __restrict__ T, const float* __restrict__ s2i_p,
                const float* __restrict__ s2x_p, const float* __restrict__ kf_int,
                const float* __restrict__ px, const float* __restrict__ py,
                const float* __restrict__ pz, const float* __restrict__ kf_mask,
                const float* __restrict__ cur_int, const float* __restrict__ cur_xi,
                const float* __restrict__ cur_mask, float* __restrict__ rows,
                unsigned int* __restrict__ counter, float* __restrict__ out) {
  const float s2i_in = *s2i_p;
  const float s2x_in = *s2x_p;
  sigma_phase(p, T, s2i_in, s2x_in, kf_int, px, py, pz, kf_mask, cur_int, cur_xi, cur_mask, rows);
  if (!irls::last_to_arrive(counter, kSigmaSums)) return;
  __shared__ float sums[kSigmaSums];
  irls::sum_rows<kSigmaSums>(rows, gridDim.x, sums);
  float s2i = s2i_in, s2x = s2x_in;
  update_scales(sums, p.use_geometric, s2i, s2x);
  const int t = threadIdx.x;
  if (t < kSigmaSums) out[t] = sums[t];
  if (t == 0) {
    out[3] = s2i;
    out[4] = s2x;
    *counter = 0u;
  }
}

// One template pixel's 32 terms from the stored field, added to acc.
template <bool Geo>
__device__ __forceinline__ void ic_normal_pixel(
    const IcParams& p, int i, const float* __restrict__ T, float s2i, float s2x,
    const float* __restrict__ kf_int, const float* __restrict__ px,
    const float* __restrict__ py, const float* __restrict__ pz,
    const float* __restrict__ kf_mask, const float* __restrict__ jac,
    const float* __restrict__ cur_int, const float* __restrict__ cur_xi,
    const float* __restrict__ cur_mask, float (&acc)[kNormalSums]) {
  constexpr int kPlanes = Geo ? 12 : 6;
  const Residuals q =
      ic_residuals(p, i, T, kf_int, px, py, pz, kf_mask, cur_int, cur_xi, cur_mask);
  const float valid = q.valid, r_i = q.r_i, r_x = q.r_x;
  const float w0i = irls::student_w0(r_i, s2i, p.nu, p.nu1);
  const float w0x = irls::student_w0(r_x, s2x, p.nu, p.nu1);
  const float w_i = w0i * valid / s2i;
  const float w_x = w0x * valid / s2x;
  float J[kPlanes];
#pragma unroll
  for (int k = 0; k < kPlanes; ++k) J[k] = jac[k * p.n + i];

  int t = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int c = a; c < 6; ++c) {
      float s = w_i * J[a] * J[c];
      if (Geo) s = s + w_x * J[(6 + a) % kPlanes] * J[(6 + c) % kPlanes];
      acc[t++] += s;
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float s = w_i * J[a] * r_i;
    if (Geo) s = s + w_x * J[(6 + a) % kPlanes] * r_x;
    acc[21 + a] += s;
  }
  float e = w_i * r_i * r_i;
  if (Geo) e = e + w_x * r_x * r_x;
  acc[27] += e;
  acc[28] += valid * ((r_i * r_i < p.gate2 * s2i) ? 1.f : 0.f);
  acc[29] += valid;
  acc[30] += valid * w0i * r_i * r_i;
  acc[31] += valid * w0x * r_x * r_x;
}

// The normal phase: this block's pixels, reduced to one row of 32 partials.
template <bool Geo>
__device__ __forceinline__ void normal_phase(
    const IcParams& p, const float* __restrict__ T, float s2i, float s2x,
    const float* __restrict__ kf_int, const float* __restrict__ px,
    const float* __restrict__ py, const float* __restrict__ pz,
    const float* __restrict__ kf_mask, const float* __restrict__ jac,
    const float* __restrict__ cur_int, const float* __restrict__ cur_xi,
    const float* __restrict__ cur_mask, float* __restrict__ partials) {
  float acc[kNormalSums];
#pragma unroll
  for (int k = 0; k < kNormalSums; ++k) acc[k] = 0.f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.n; i += gridDim.x * kThreads) {
    ic_normal_pixel<Geo>(p, i, T, s2i, s2x, kf_int, px, py, pz, kf_mask, jac, cur_int, cur_xi,
                         cur_mask, acc);
  }
  irls::block_reduce<kNormalSums>(acc, partials + blockIdx.x * kNormalSums);
}

template <bool Geo>
__global__ void __launch_bounds__(kThreads, irls::kMinBlocksPerSm)
ic_normal_kernel(IcParams p, int lagged, const float* __restrict__ T,
                 const float* __restrict__ s2i_p, const float* __restrict__ s2x_p,
                 const float* __restrict__ kf_int, const float* __restrict__ px,
                 const float* __restrict__ py, const float* __restrict__ pz,
                 const float* __restrict__ kf_mask, const float* __restrict__ jac,
                 const float* __restrict__ cur_int, const float* __restrict__ cur_xi,
                 const float* __restrict__ cur_mask, float* __restrict__ partials,
                 unsigned int* __restrict__ counter, float* __restrict__ out,
                 const float* __restrict__ prev, unsigned int* __restrict__ runs) {
  if (irls::converged(prev, p.tol, out)) return;
  const float s2i = *s2i_p;
  const float s2x = *s2x_p;
  normal_phase<Geo>(p, T, s2i, s2x, kf_int, px, py, pz, kf_mask, jac, cur_int, cur_xi, cur_mask,
                    partials);
  irls::finish_iteration(partials, counter, s2i, s2x, p.use_geometric, lagged, T, p.damping,
                         out, runs);
}

// counter[0]: the last-block arrival count; counter[1], counter[2]: the
// grid barrier's arrivals and generation. ``published``: the 3 sums of the
// current sigma step, written by the barrier's last block.
template <bool Geo>
__global__ void __launch_bounds__(kThreads, irls::kMinBlocksPerSm)
ic_exact_kernel(IcParams p, int sigma_steps, const float* __restrict__ T,
                const float* __restrict__ s2i_p, const float* __restrict__ s2x_p,
                const float* __restrict__ kf_int, const float* __restrict__ px,
                const float* __restrict__ py, const float* __restrict__ pz,
                const float* __restrict__ kf_mask, const float* __restrict__ jac,
                const float* __restrict__ cur_int, const float* __restrict__ cur_xi,
                const float* __restrict__ cur_mask, float* __restrict__ partials,
                float* __restrict__ sigma_rows, float* __restrict__ published,
                unsigned int* __restrict__ counter, float* __restrict__ out,
                const float* __restrict__ prev, unsigned int* __restrict__ runs) {
  // Before the first grid_arrive: every block leaves here, or none does.
  if (irls::converged(prev, p.tol, out)) return;
  float s2i = *s2i_p;
  float s2x = *s2x_p;
  __shared__ float sums[kSigmaSums];
  for (int k = 0; k < sigma_steps; ++k) {
    // One buffer of rows and one of sums serve every step: a block writes
    // step k + 1's row only after the release of step k, and the last
    // block of step k + 1 publishes only after every block, having arrived,
    // has read step k's sums.
    sigma_phase(p, T, s2i, s2x, kf_int, px, py, pz, kf_mask, cur_int, cur_xi, cur_mask,
                sigma_rows);
    bool last;
    const unsigned int seen = irls::grid_arrive(counter + 1, counter + 2, last);
    if (last) {
      irls::sum_rows<kSigmaSums>(sigma_rows, gridDim.x, sums);
      if (threadIdx.x < kSigmaSums) published[threadIdx.x] = sums[threadIdx.x];
      irls::grid_release(counter + 2);
    } else {
      irls::grid_wait(counter + 2, seen);
      if (threadIdx.x < kSigmaSums) sums[threadIdx.x] = __ldcg(published + threadIdx.x);
      __syncthreads();
    }
    update_scales(sums, Geo, s2i, s2x);
  }
  normal_phase<Geo>(p, T, s2i, s2x, kf_int, px, py, pz, kf_mask, jac, cur_int, cur_xi, cur_mask,
                    partials);
  if (irls::finish_iteration(partials, counter, s2i, s2x, Geo, /*lagged=*/0, T, p.damping,
                             out, runs) &&
      threadIdx.x == 0) {
    counter[1] = 0u;  // every block has passed every barrier
  }
}

// The exact-mode grid: every block resident at once (the barrier needs
// it), at most max_blocks, and no more blocks than 256-pixel chunks.
template <bool Geo>
cudaError_t exact_blocks(const IcParams& p, int max_blocks, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ic_exact_kernel<Geo>, kThreads, 0);
  }
  *blocks = max(1, min(min((p.n + kThreads - 1) / kThreads, max_blocks), per_sm * sms));
  return e;
}

}  // namespace

// One sigma step: out (5 floats) = [swi, swx, n, sigma2_int', sigma2_xi'].
// ``rows`` holds max_blocks rows of 3 floats; ``counter`` (counter[0]) is 0
// on entry and is 0 again when the launch ends.
extern "C" int ic_sigma_launch(IcParams p, int max_blocks, const float* T, const float* s2i,
                               const float* s2x, const float* kf_int, const float* px,
                               const float* py, const float* pz, const float* kf_mask,
                               const float* cur_int, const float* cur_xi, const float* cur_mask,
                               float* rows, unsigned int* counter, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = max(1, min((p.n + kThreads - 1) / kThreads, max_blocks));
  ic_sigma_kernel<<<blocks, kThreads, 0, st>>>(p, T, s2i, s2x, kf_int, px, py, pz, kf_mask,
                                               cur_int, cur_xi, cur_mask, rows, counter, out);
  return static_cast<int>(cudaGetLastError());
}

// One IRLS iteration: out (irls::kOut floats) = [result (48) | T' (16) |
// delta (6)]. With sigma_steps > 0 (exact mode), the cooperative launch of
// ic_exact_kernel: that many sigma phases, then the normal phase weighted
// with the updated scales, which the result carries; a refused launch
// returns its error code. Otherwise ic_normal_kernel, the result lagged or
// not. ``partials`` holds max_blocks rows of 32 floats, ``sigma_rows``
// max_blocks + 1 rows of 3 (the last for the published sums); ``counter``
// (3 words) is 0, 0, any on entry and leaves the first two at 0. ``prev``:
// the previous iteration's out, or nullptr; ``runs``: the level's slot of
// the count of iterations run, or nullptr.
extern "C" int ic_irls_launch(IcParams p, int lagged, int sigma_steps, int max_blocks,
                              const float* T, const float* s2i, const float* s2x,
                              const float* kf_int, const float* px, const float* py,
                              const float* pz, const float* kf_mask, const float* jac,
                              const float* cur_int, const float* cur_xi, const float* cur_mask,
                              float* partials, float* sigma_rows, unsigned int* counter,
                              float* out, const float* prev, unsigned int* runs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sigma_steps > 0) {
    float* published = sigma_rows + max_blocks * kSigmaSums;
    void* args[] = {&p,       &sigma_steps, &T,          &s2i,       &s2x,
                    &kf_int,  &px,          &py,         &pz,        &kf_mask,
                    &jac,     &cur_int,     &cur_xi,     &cur_mask,  &partials,
                    &sigma_rows, &published, &counter,   &out,       &prev,
                    &runs};
    int blocks = 0;
    cudaError_t e;
    if (p.use_geometric) {
      e = exact_blocks<true>(p, max_blocks, &blocks);
      if (e == cudaSuccess) {
        e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ic_exact_kernel<true>),
                                        dim3(blocks), dim3(kThreads), args, 0, st);
      }
    } else {
      e = exact_blocks<false>(p, max_blocks, &blocks);
      if (e == cudaSuccess) {
        e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ic_exact_kernel<false>),
                                        dim3(blocks), dim3(kThreads), args, 0, st);
      }
    }
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it: the caller raises on the returned code
      return static_cast<int>(e);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int blocks = max(1, min((p.n + kThreads - 1) / kThreads, max_blocks));
  if (p.use_geometric) {
    ic_normal_kernel<true><<<blocks, kThreads, 0, st>>>(p, lagged, T, s2i, s2x, kf_int, px, py,
                                                         pz, kf_mask, jac, cur_int, cur_xi,
                                                         cur_mask, partials, counter, out, prev,
                                                         runs);
  } else {
    ic_normal_kernel<false><<<blocks, kThreads, 0, st>>>(p, lagged, T, s2i, s2x, kf_int, px, py,
                                                          pz, kf_mask, jac, cur_int, cur_xi,
                                                          cur_mask, partials, counter, out, prev,
                                                         runs);
  }
  return static_cast<int>(cudaGetLastError());
}
