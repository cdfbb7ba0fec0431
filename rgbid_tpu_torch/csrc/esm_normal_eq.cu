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
// The warp, gather, reductions and the end of the iteration are shared
// with the IC kernel (irls_common.cuh).

#include <cuda_runtime.h>

#include "irls_common.cuh"

// Must match EsmParams in ops/_build.py field by field.
struct EsmParams {
  int n;               // template pixels (row-major template planes)
  int h, w;            // current-stack height and width
  int use_geometric;   // inverse-depth channel enters H, b and the error
  int occlusion_gate;  // gate the weights on the inverse-depth residual
  float fx, fy, cx, cy;
  float nu;            // Student-t degrees of freedom
  float nu1;           // nu + 1
  float gate2;         // gate_sigmas^2 (inlier test)
  float occ_a;         // (2 gate_sigmas)^2 (occlusion-gate slope)
  float occ_b;         // 0.05^2 (occlusion-gate floor)
  float cap2;          // squared occlusion-gate cap; 0 = uncapped
  float umax, vmax;    // w - 1.001, h - 1.001
  float damping;       // Levenberg damping of the 6x6 solve
};

namespace {

using irls::clamp_max;
using irls::clamp_min;
using irls::kNormalSums;
using irls::kThreads;

// One template pixel's 32 terms, added to acc.
template <int C>
__device__ __forceinline__ void esm_pixel(
    const EsmParams& p, int i, const float* __restrict__ T, float s2i, float s2x,
    const float* __restrict__ kf_int, const float* __restrict__ px,
    const float* __restrict__ py, const float* __restrict__ pz,
    const float* __restrict__ kf_mask, const float* __restrict__ kf_grads,
    const float* __restrict__ cur, float (&acc)[kNormalSums]) {
  const float Px = px[i], Py = py[i], Pz = pz[i];
  const irls::Projection pr = irls::project(T, Px, Py, Pz, p.fx, p.fy, p.cx, p.cy);
  const float rho = pr.rho;
  const irls::Corners cn = irls::corners(pr.up, pr.vp, p.h, p.w, p.umax, p.vmax);
  const int hw = p.h * p.w;
  float smp[C];
#pragma unroll
  for (int c = 0; c < C; ++c) smp[c] = irls::blend(cur + c * hw, cn);
  const float mask_ok = irls::corner_product(cur + 2 * hw, cn);
  const float valid = kf_mask[i] * pr.front * cn.inb * mask_ok;
  const float r_i = (smp[0] - kf_int[i]) * valid;
  const float r_x = (smp[1] - rho) * valid;

  // Student-t weights; the occlusion gate touches the weights only.
  const float w0i = irls::student_w0(r_i, s2i, p.nu, p.nu1);
  const float w0x = irls::student_w0(r_x, s2x, p.nu, p.nu1);
  float w_i, w_x;
  if (p.occlusion_gate && p.use_geometric) {
    float thresh = p.occ_a * s2x + p.occ_b;
    if (p.cap2 > 0.f) thresh = clamp_max(thresh, p.cap2);
    const float w_gate = (r_x * r_x <= thresh) ? 1.f : 0.f;
    w_i = w0i * valid * w_gate / s2i;
    w_x = w0x * valid * w_gate / s2x;
  } else {
    w_i = w0i * valid / s2i;
    w_x = w0x * valid / s2x;
  }

  // Warp Jacobian at the template point; exact prediction Jacobian.
  const float iz = 1.0f / clamp_min(Pz, 1e-6f);
  const float iz2 = iz * iz;
  const float nfx = -p.fx, nfy = -p.fy;
  const float ju[6] = {p.fx * iz,
                       0.f,
                       nfx * Px * iz2,
                       nfx * Px * Py * iz2,
                       p.fx * (Px * Px * iz2 + 1.0f),
                       nfx * Py * iz};
  const float jv[6] = {0.f,
                       p.fy * iz,
                       nfy * Py * iz2,
                       nfy * (Py * Py * iz2 + 1.0f),
                       p.fy * Px * Py * iz2,
                       p.fy * Px * iz};
  const float r20 = T[8], r21 = T[9], r22 = T[10];
  const float nrho2 = -(rho * rho);
  const float jr[6] = {nrho2 * r20,
                       nrho2 * r21,
                       nrho2 * r22,
                       nrho2 * (Py * r22 - Pz * r21),
                       nrho2 * (Pz * r20 - Px * r22),
                       nrho2 * (Px * r21 - Py * r20)};
  const float* g = kf_grads;
  float gxi, gyi, gxx, gyx;
  if (C >= 7) {
    gxi = (g[i] + smp[3 % C]) * 0.5f;
    gyi = (g[p.n + i] + smp[4 % C]) * 0.5f;
    gxx = (g[2 * p.n + i] + smp[5 % C]) * 0.5f;
    gyx = (g[3 * p.n + i] + smp[6 % C]) * 0.5f;
  } else if (C >= 5) {
    gxi = (g[i] + smp[3 % C]) * 0.5f;
    gyi = (g[p.n + i] + smp[4 % C]) * 0.5f;
    gxx = g[2 * p.n + i];
    gyx = g[3 * p.n + i];
  } else {
    gxi = g[i];
    gyi = g[p.n + i];
    gxx = g[2 * p.n + i];
    gyx = g[3 * p.n + i];
  }
  float Ji[6], Jx[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    Ji[k] = gxi * ju[k] + gyi * jv[k];
    Jx[k] = gxx * ju[k] + gyx * jv[k] - jr[k];
  }

  int t = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int c = a; c < 6; ++c) {
      float s = w_i * Ji[a] * Ji[c];
      if (p.use_geometric) s = s + w_x * Jx[a] * Jx[c];
      acc[t++] += s;
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float s = w_i * Ji[a] * r_i;
    if (p.use_geometric) s = s + w_x * Jx[a] * r_x;
    acc[21 + a] += s;
  }
  float e = w_i * r_i * r_i;
  if (p.use_geometric) e = e + w_x * r_x * r_x;
  acc[27] += e;
  acc[28] += valid * ((r_i * r_i < p.gate2 * s2i) ? 1.f : 0.f);
  acc[29] += valid;
  acc[30] += valid * w0i * r_i * r_i;
  acc[31] += valid * w0x * r_x * r_x;
}

template <int C>
__global__ void __launch_bounds__(kThreads, irls::kMinBlocksPerSm)
esm_kernel(EsmParams p, const float* __restrict__ T, const float* __restrict__ s2i_p,
           const float* __restrict__ s2x_p, const float* __restrict__ kf_int,
           const float* __restrict__ px, const float* __restrict__ py,
           const float* __restrict__ pz, const float* __restrict__ kf_mask,
           const float* __restrict__ kf_grads, const float* __restrict__ cur,
           float* __restrict__ partials, unsigned int* __restrict__ counter,
           float* __restrict__ out) {
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
                         p.damping, out);
}

}  // namespace

// One IRLS iteration: out (irls::kOut floats) = [result (48) | T' (16) |
// delta (6)]. ``partials`` holds max_blocks rows of 32 floats; ``counter``
// is 0 on entry and is 0 again when the launch ends.
extern "C" int esm_irls_launch(EsmParams p, int channels, int max_blocks, const float* T,
                               const float* s2i, const float* s2x, const float* kf_int,
                               const float* px, const float* py, const float* pz,
                               const float* kf_mask, const float* kf_grads, const float* cur,
                               float* partials, unsigned int* counter, float* out,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = max(1, min((p.n + kThreads - 1) / kThreads, max_blocks));
  switch (channels) {
    case 3:
      esm_kernel<3><<<blocks, kThreads, 0, st>>>(p, T, s2i, s2x, kf_int, px, py, pz, kf_mask,
                                                 kf_grads, cur, partials, counter, out);
      break;
    case 5:
      esm_kernel<5><<<blocks, kThreads, 0, st>>>(p, T, s2i, s2x, kf_int, px, py, pz, kf_mask,
                                                 kf_grads, cur, partials, counter, out);
      break;
    case 7:
      esm_kernel<7><<<blocks, kThreads, 0, st>>>(p, T, s2i, s2x, kf_int, px, py, pz, kf_mask,
                                                 kf_grads, cur, partials, counter, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
