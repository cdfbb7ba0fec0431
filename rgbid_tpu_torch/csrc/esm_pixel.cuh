// The ESM per-pixel math shared by the ESM IRLS kernel (esm_normal_eq.cu)
// and the stratified vote reduction (esm_stratified.cu): project the
// template point through T, gather the C-channel current stack (C = 3, 5
// or 7), form both residuals, the occlusion-gated Student-t weights, the
// warp Jacobian and the exact inverse-depth prediction Jacobian, with ESM
// gradient averaging. One implementation, so that the vote evaluates the
// same model as the tracker.
//
// Float order: operation by operation as ops/gauss_newton.py::_esm_pointwise
// (built with -fmad=false), so every per-pixel value rounds like the plain
// version's.
//
// Storage types (TrackingConfig.plane_dtype): the template intensity
// (IntT), the three backprojected point planes (PtT) and the current stack
// (StackT) are each float or __nv_bfloat16, chosen independently, because
// the tracker's call sites mix them (the IRLS loop bf16 / bf16 / bf16 under
// "bf16", the vote and the rescue's evidence f32 intensity with bf16 points
// and stack). A bf16 value is widened to f32 at its load; everything after
// it is the f32 math above. The mask and the template gradients are f32.

#pragma once

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
  float tol;           // early exit: skip once the previous step's norm <= tol
};

namespace esm {
namespace {

// One template pixel's ESM quantities.
struct Point {
  float Ji[6], Jx[6];  // intensity and inverse-depth channel Jacobians
  float ju[6], jv[6];  // warp Jacobian rows
  float w_i, w_x;      // gated Student-t weights, 1/sigma^2 included
  float w0i, w0x;      // ungated weights without 1/sigma^2 (scale statistics)
  float r_i, r_x, valid;
};

template <int C, typename IntT, typename PtT, typename StackT>
__device__ __forceinline__ Point point(
    const EsmParams& p, int i, const float* __restrict__ T, float s2i, float s2x,
    const IntT* __restrict__ kf_int, const PtT* __restrict__ px,
    const PtT* __restrict__ py, const PtT* __restrict__ pz,
    const float* __restrict__ kf_mask, const float* __restrict__ kf_grads,
    const StackT* __restrict__ cur) {
  using irls::clamp_max;
  using irls::clamp_min;
  using irls::to_f32;
  Point q;
  const float Px = to_f32(px[i]), Py = to_f32(py[i]), Pz = to_f32(pz[i]);
  const irls::Projection pr = irls::project(T, Px, Py, Pz, p.fx, p.fy, p.cx, p.cy);
  const float rho = pr.rho;
  const irls::Corners cn = irls::corners(pr.up, pr.vp, p.h, p.w, p.umax, p.vmax);
  const int hw = p.h * p.w;
  float smp[C];
#pragma unroll
  for (int c = 0; c < C; ++c) smp[c] = irls::blend(cur + c * hw, cn);
  const float mask_ok = irls::corner_product(cur + 2 * hw, cn);
  q.valid = kf_mask[i] * pr.front * cn.inb * mask_ok;
  q.r_i = (smp[0] - to_f32(kf_int[i])) * q.valid;
  q.r_x = (smp[1] - rho) * q.valid;

  // Student-t weights; the occlusion gate touches the weights only.
  q.w0i = irls::student_w0(q.r_i, s2i, p.nu, p.nu1);
  q.w0x = irls::student_w0(q.r_x, s2x, p.nu, p.nu1);
  if (p.occlusion_gate && p.use_geometric) {
    float thresh = p.occ_a * s2x + p.occ_b;
    if (p.cap2 > 0.f) thresh = clamp_max(thresh, p.cap2);
    const float w_gate = (q.r_x * q.r_x <= thresh) ? 1.f : 0.f;
    q.w_i = q.w0i * q.valid * w_gate / s2i;
    q.w_x = q.w0x * q.valid * w_gate / s2x;
  } else {
    q.w_i = q.w0i * q.valid / s2i;
    q.w_x = q.w0x * q.valid / s2x;
  }

  // Warp Jacobian at the template point; exact prediction Jacobian.
  const float iz = 1.0f / clamp_min(Pz, 1e-6f);
  const float iz2 = iz * iz;
  const float nfx = -p.fx, nfy = -p.fy;
  q.ju[0] = p.fx * iz;
  q.ju[1] = 0.f;
  q.ju[2] = nfx * Px * iz2;
  q.ju[3] = nfx * Px * Py * iz2;
  q.ju[4] = p.fx * (Px * Px * iz2 + 1.0f);
  q.ju[5] = nfx * Py * iz;
  q.jv[0] = 0.f;
  q.jv[1] = p.fy * iz;
  q.jv[2] = nfy * Py * iz2;
  q.jv[3] = nfy * (Py * Py * iz2 + 1.0f);
  q.jv[4] = p.fy * Px * Py * iz2;
  q.jv[5] = p.fy * Px * iz;
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
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    q.Ji[k] = gxi * q.ju[k] + gyi * q.jv[k];
    q.Jx[k] = gxx * q.ju[k] + gyx * q.jv[k] - jr[k];
  }
  return q;
}

}  // namespace
}  // namespace esm
