// Inverse-compositional (IC) IRLS: the Student-t scale step and the 6x6
// normal equations from a stored template Jacobian field.
//
// Replaces: rgbid_tpu/ops/pallas_kernels.py, _sigma_kernel (entry
// sigma_stats) and _normal_kernel (entry normal_eq), both reached through
// residuals_and_normal_eq_pallas. On the TPU the warp (transform_project)
// and the 3-plane bilinear gather stayed in XLA and the kernels read five
// pre-gathered planes; here each thread does all of it for one template
// pixel: project the template point through T, gather [I, xi, mask] from
// the current level, and form valid, r_i and r_x. Then
//   - ic_sigma_kernel: valid * w(sigma2_old) * r^2 per channel and the
//     valid count (3 sums); its second pass writes the raw sums and the
//     updated scales max(s / max(n, 1), 1e-12) (the inverse-depth scale only
//     when that channel is on, else the incoming one) into a device buffer;
//   - ic_normal_kernel: Student-t weights from the incoming scales (no
//     occlusion gate), the 12 stored Jacobian planes, and the 32 per-pixel
//     terms of the ESM kernel's layout (21 upper-triangle H, 6 b, error,
//     inlier, valid, 2 lagged-sigma statistics); its second pass is the
//     shared normal_finalize, lagged or not.
// A block reduces its terms with warp shuffles and shared memory into one
// row of (n_blocks, N) partials; a one-block second pass sums the rows in a
// fixed order. T and every scale are read through device pointers, so an
// exact-mode chain (sigma pass, k times, then the normal pass) never waits
// on the host.
//
// What bounds it on this card: at the tracker's sizes (at most 77k template
// pixels) the normal pass reads ~17 planes of 4 bytes a pixel (~5 MB at
// level 0, a few microseconds of bandwidth), so the two launches' latency
// and the gather's scattered reads bound it, not bytes or FLOPs. The
// Jacobian field is held as float32 carrying bfloat16-rounded values; real
// bf16 storage would halve the largest read.
//
// Determinism: no atomics. Every sum is taken in a fixed order, so the same
// input gives bit-identical output from run to run. Float order: the
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

__global__ void __launch_bounds__(kThreads)
ic_sigma_kernel(IcParams p, const float* __restrict__ T, const float* __restrict__ s2i_p,
                const float* __restrict__ s2x_p, const float* __restrict__ kf_int,
                const float* __restrict__ px, const float* __restrict__ py,
                const float* __restrict__ pz, const float* __restrict__ kf_mask,
                const float* __restrict__ cur_int, const float* __restrict__ cur_xi,
                const float* __restrict__ cur_mask, float* __restrict__ partials) {
  float acc[kSigmaSums] = {0.f, 0.f, 0.f};
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < p.n) {
    const Residuals q =
        ic_residuals(p, i, T, kf_int, px, py, pz, kf_mask, cur_int, cur_xi, cur_mask);
    const float w0i = irls::student_w0(q.r_i, *s2i_p, p.nu, p.nu1);
    const float w0x = irls::student_w0(q.r_x, *s2x_p, p.nu, p.nu1);
    acc[0] = q.valid * w0i * q.r_i * q.r_i;
    acc[1] = q.valid * w0x * q.r_x * q.r_x;
    acc[2] = q.valid;
  }
  irls::block_reduce<kSigmaSums>(acc, partials + blockIdx.x * kSigmaSums);
}

// out[0:3] the raw sums (swi, swx, n); out[3], out[4] the updated scales.
__global__ void __launch_bounds__(kThreads)
ic_sigma_finalize(const float* __restrict__ partials, int n_blocks,
                  const float* __restrict__ s2x_in, int use_geometric, float* __restrict__ out) {
  __shared__ float sums[kSigmaSums];
  irls::sum_partials<kSigmaSums>(partials, n_blocks, sums);
  const int t = threadIdx.x;
  const float n1 = irls::clamp_min(sums[2], 1.f);
  if (t < kSigmaSums) {
    out[t] = sums[t];
  } else if (t == 3) {
    out[t] = irls::clamp_min(sums[0] / n1, 1e-12f);
  } else if (t == 4) {
    out[t] = use_geometric ? irls::clamp_min(sums[1] / n1, 1e-12f) : *s2x_in;
  }
}

template <bool Geo>
__global__ void __launch_bounds__(kThreads)
ic_normal_kernel(IcParams p, const float* __restrict__ T, const float* __restrict__ s2i_p,
                 const float* __restrict__ s2x_p, const float* __restrict__ kf_int,
                 const float* __restrict__ px, const float* __restrict__ py,
                 const float* __restrict__ pz, const float* __restrict__ kf_mask,
                 const float* __restrict__ jac, const float* __restrict__ cur_int,
                 const float* __restrict__ cur_xi, const float* __restrict__ cur_mask,
                 float* __restrict__ partials) {
  constexpr int kPlanes = Geo ? 12 : 6;
  float acc[kNormalSums];
#pragma unroll
  for (int k = 0; k < kNormalSums; ++k) acc[k] = 0.f;

  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < p.n) {
    const Residuals q =
        ic_residuals(p, i, T, kf_int, px, py, pz, kf_mask, cur_int, cur_xi, cur_mask);
    const float valid = q.valid, r_i = q.r_i, r_x = q.r_x;
    const float s2i = *s2i_p;
    const float s2x = *s2x_p;
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
        acc[t++] = s;
      }
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      float s = w_i * J[a] * r_i;
      if (Geo) s = s + w_x * J[(6 + a) % kPlanes] * r_x;
      acc[21 + a] = s;
    }
    float e = w_i * r_i * r_i;
    if (Geo) e = e + w_x * r_x * r_x;
    acc[27] = e;
    acc[28] = valid * ((r_i * r_i < p.gate2 * s2i) ? 1.f : 0.f);
    acc[29] = valid;
    acc[30] = valid * w0i * r_i * r_i;
    acc[31] = valid * w0x * r_x * r_x;
  }
  irls::block_reduce<kNormalSums>(acc, partials + blockIdx.x * kNormalSums);
}

}  // namespace

// One sigma step: out (5 floats) = [swi, swx, n, sigma2_int', sigma2_xi'].
extern "C" int ic_sigma_launch(IcParams p, const float* T, const float* s2i, const float* s2x,
                               const float* kf_int, const float* px, const float* py,
                               const float* pz, const float* kf_mask, const float* cur_int,
                               const float* cur_xi, const float* cur_mask, float* partials,
                               float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (p.n + kThreads - 1) / kThreads;
  if (n_blocks > 0) {
    ic_sigma_kernel<<<n_blocks, kThreads, 0, st>>>(p, T, s2i, s2x, kf_int, px, py, pz,
                                                   kf_mask, cur_int, cur_xi, cur_mask,
                                                   partials);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ic_sigma_finalize<<<1, kThreads, 0, st>>>(partials, n_blocks, s2x, p.use_geometric, out);
  return static_cast<int>(cudaGetLastError());
}

// One normal-equation pass: out (48 floats) in normal_finalize's layout.
extern "C" int ic_normal_launch(IcParams p, int lagged, const float* T, const float* s2i,
                                const float* s2x, const float* kf_int, const float* px,
                                const float* py, const float* pz, const float* kf_mask,
                                const float* jac, const float* cur_int, const float* cur_xi,
                                const float* cur_mask, float* partials, float* out,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (p.n + kThreads - 1) / kThreads;
  if (n_blocks > 0) {
    if (p.use_geometric) {
      ic_normal_kernel<true><<<n_blocks, kThreads, 0, st>>>(
          p, T, s2i, s2x, kf_int, px, py, pz, kf_mask, jac, cur_int, cur_xi, cur_mask, partials);
    } else {
      ic_normal_kernel<false><<<n_blocks, kThreads, 0, st>>>(
          p, T, s2i, s2x, kf_int, px, py, pz, kf_mask, jac, cur_int, cur_xi, cur_mask, partials);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  irls::normal_finalize<<<1, kThreads, 0, st>>>(partials, n_blocks, s2i, s2x, p.use_geometric,
                                                lagged, out);
  return static_cast<int>(cudaGetLastError());
}
