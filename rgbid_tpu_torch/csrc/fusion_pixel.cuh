// The fusion kernel's per-pixel work (csrc/fusion.cu), as host and device
// code: the hole guess from the keyframe's coarse levels, the warp of the
// depth hypothesis into the current frame, the corner gather, the
// observation re-expressed in keyframe coordinates, the variance
// propagation, the gate and Kalman update, the claim of a hole pixel, and
// the hit count and mask update. The host build is what
// tests/test_torch_fusion.py holds to the plain PyTorch version over whole
// planes.
//
// Float order: every step follows the plain version (mapping/fusion.py:
// hole_guess, _rigid_inverse, fuse_core_plain, _grow) operation by
// operation; the card's build disables FMA contraction (-fmad=false) and
// the host test's (-ffp-contract=off), so masks, hits and counts round
// exactly like the plain version's.

#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define FUSION_HD __host__ __device__ __forceinline__
#else
#define FUSION_HD inline
#endif

namespace fusion {

// Coarse levels the hole guess reads (pyramids of up to 8 levels).
constexpr int kMaxCoarse = 7;

}  // namespace fusion

// Must match FusionParams in ops/_build.py field by field.
struct FusionParams {
  int h, w;              // level-0 plane size
  int grow;              // validity growth on: the hole guess is formed and claims are made
  int n_coarse;          // coarse levels read for the guess (levels 1..n_coarse)
  int cov_rs, cov_cs;    // the covariance's row and column strides, in elements
  float fx, fy, cx, cy;  // level-0 camera
  float inv_fx, inv_fy;  // 1/fx, 1/fy
  float umax, vmax;      // w - 1.001, h - 1.001
  float sensor_var;      // sensor_sigma_xi^2
  float gate_k2;         // gate_k^2
  float min_var, max_var;
  float claim_tol;
  float claim_infl;      // claim_var_inflation
  float trans_var;       // pose_trans_sigma^2: the floor on the covariance's translation diagonal
  float rot_var;         // pose_rot_sigma^2: the floor on its rotation diagonal
  int ch[fusion::kMaxCoarse], cw[fusion::kMaxCoarse];  // coarse level l+1: height, width
  const float* coarse[fusion::kMaxCoarse];             // coarse level l+1: inverse depth
};

namespace fusion {

// A read of a plane no thread writes in the launch: the read-only path on
// the card.
FUSION_HD float ro(const float* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

FUSION_HD float clamp_min(float x, float lo) { return x < lo ? lo : x; }
FUSION_HD float clamp_max(float x, float hi) { return x > hi ? hi : x; }
FUSION_HD int imin(int a, int b) { return a < b ? a : b; }
FUSION_HD int imax(int a, int b) { return a > b ? a : b; }

// The pose terms every pixel reads: T_ck (rows 0-2), T_kc = its rigid
// inverse (rows 0-2), and the covariance's [z, wx, wy] block with the
// pose-noise floor added to its diagonal.
struct Pose {
  float ck[12];
  float kc[12];
  float c[9];  // C[2+a][2+b] at 3a+b
};

// T is row-major 4x4; cov is 6x6 with the strides in p.
FUSION_HD void load_pose(const FusionParams& p, const float* T, const float* cov, Pose& q) {
  for (int k = 0; k < 12; ++k) q.ck[k] = T[k];
  const float t0 = T[3], t1 = T[7], t2 = T[11];
  for (int r = 0; r < 3; ++r) {
    // Rotation transposed; translation -(R^T t), summed in row order.
    q.kc[4 * r + 0] = T[r];
    q.kc[4 * r + 1] = T[4 + r];
    q.kc[4 * r + 2] = T[8 + r];
    q.kc[4 * r + 3] = -(T[r] * t0 + T[4 + r] * t1 + T[8 + r] * t2);
  }
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b) {
      float floor_ab = 0.f;
      if (a == b) floor_ab = a == 0 ? p.trans_var : p.rot_var;
      q.c[3 * a + b] = cov[(2 + a) * p.cov_rs + (2 + b) * p.cov_cs] + floor_ab;
    }
  }
}

// hole_guess: the first coarse level, finest first, whose inverse depth
// at (v >> l, u >> l) exceeds 1e-6 gives the guess; gmask is 1 where any
// does. An index past a level's edge reads 0 (the plain version's crop
// and zero pad of the nearest-neighbour upsample).
FUSION_HD void hole_guess(const FusionParams& p, int u, int v, float& guess, float& gmask) {
  guess = 0.f;
  gmask = 0.f;
#pragma unroll
  for (int l = 0; l < kMaxCoarse; ++l) {
    if (l < p.n_coarse) {
      const int ul = u >> (l + 1), vl = v >> (l + 1);
      const float x = (ul < p.cw[l] && vl < p.ch[l]) ? ro(p.coarse[l] + vl * p.cw[l] + ul) : 0.f;
      const float um = x > 1e-6f ? 1.f : 0.f;
      if (gmask < 0.5f && um > 0.5f) guess = x;
      gmask = um > gmask ? um : gmask;
    }
  }
}

struct Out {
  float xi, var, mask, hits, fuse;
};

// The next pixel of a row-major walk.
FUSION_HD void next(const FusionParams& p, int& iu, int& iv) {
  if (++iu == p.w) {
    iu = 0;
    ++iv;
  }
}

// One level-0 keyframe pixel at column iu, row iv: its estimate kx,
// variance kv, full mask kfm and hit count hits in; the fused estimate,
// variance, mask and hit count out, and whether it fused (0 or 1).
FUSION_HD Out pixel(const FusionParams& p, const Pose& q, int iu, int iv, float kx, float kv,
                    float kfm, float hits, const float* cur_xi, const float* cur_mask) {
  float xi_eff = kx, mask_eff = kfm, gs = 0.f, gm = 0.f;
  if (p.grow) {
    hole_guess(p, iu, iv, gs, gm);
    xi_eff = kfm > 0.f ? kx : gs;
    mask_eff = gm > kfm ? gm : kfm;
  }
  // warp_points (ops/warp.py): backproject the hypothesis, move it by T_ck.
  const float u = static_cast<float>(iu);
  const float v = static_cast<float>(iv);
  const float z = 1.0f / clamp_min(xi_eff, 1e-8f);
  const float x = (u - p.cx) * p.inv_fx * z;
  const float y = (v - p.cy) * p.inv_fy * z;
  const float* T = q.ck;
  const float xp = T[0] * x + T[1] * y + T[2] * z + T[3];
  const float yp = T[4] * x + T[5] * y + T[6] * z + T[7];
  const float zp = T[8] * x + T[9] * y + T[10] * z + T[11];
  const float front = zp > 1e-6f ? 1.f : 0.f;
  const float rho = 1.0f / clamp_min(zp, 1e-6f);
  const float up = p.fx * xp * rho + p.cx;
  const float vp = p.fy * yp * rho + p.cy;
  const float valid0 = mask_eff * front;

  // Corner gather of [cur_xi, cur_mask] (sample_tracker_planes).
  const float inb = (up >= 0.f && up <= p.umax && vp >= 0.f && vp <= p.vmax) ? 1.f : 0.f;
  const float uc = clamp_max(clamp_min(up, 0.f), p.umax);
  const float vc = clamp_max(clamp_min(vp, 0.f), p.vmax);
  // A NaN coordinate converts to 0; the clamp keeps every read in range.
  const int u0 = imin(imax(static_cast<int>(floorf(uc)), 0), p.w - 1);
  const int v0 = imin(imax(static_cast<int>(floorf(vc)), 0), p.h - 1);
  const float fu = uc - static_cast<float>(u0);
  const float fv = vc - static_cast<float>(v0);
  const int u1 = imin(u0 + 1, p.w - 1);
  const int v1 = imin(v0 + 1, p.h - 1);
  const int i00 = v0 * p.w + u0, i01 = v0 * p.w + u1;
  const int i10 = v1 * p.w + u0, i11 = v1 * p.w + u1;
  const float w00 = (1.f - fu) * (1.f - fv);
  const float w01 = fu * (1.f - fv);
  const float w10 = (1.f - fu) * fv;
  const float w11 = fu * fv;
  const float xi_obs_cur = ro(cur_xi + i00) * w00 + ro(cur_xi + i01) * w01 +
                           ro(cur_xi + i10) * w10 + ro(cur_xi + i11) * w11;
  const float mask_ok =
      ro(cur_mask + i00) * ro(cur_mask + i01) * ro(cur_mask + i10) * ro(cur_mask + i11);
  float valid = valid0 * inb * mask_ok * (xi_obs_cur > 1e-6f ? 1.f : 0.f);

  // Observation in keyframe coordinates.
  const float* K = q.kc;
  const float zc = 1.0f / clamp_min(xi_obs_cur, 1e-6f);
  const float dir_x = (up - p.cx) * p.inv_fx;
  const float dir_y = (vp - p.cy) * p.inv_fy;
  const float Xk = (K[0] * dir_x + K[1] * dir_y + K[2]) * zc + K[3];
  const float Yk = (K[4] * dir_x + K[5] * dir_y + K[6]) * zc + K[7];
  const float Zk = (K[8] * dir_x + K[9] * dir_y + K[10]) * zc + K[11];
  valid = valid * (Zk > 1e-6f ? 1.f : 0.f);
  const float zk = clamp_min(Zk, 1e-6f);
  const float xi_obs_kf = valid > 0.f ? 1.0f / zk : 0.f;

  // K9a: sensor noise through the frame change.
  const float r3dir = K[8] * dir_x + K[9] * dir_y + K[10];
  const float xc = clamp_min(xi_obs_cur, 1e-6f);
  const float dxi = r3dir / (zk * zk * (xc * xc));
  const float var_sensor = dxi * dxi * p.sensor_var;
  // K9b: pose covariance through J = -xi^2 [0, 0, 1, Yk, -Xk, 0].
  const float xi2 = xi_obs_kf * xi_obs_kf;
  const float j2 = -xi2;
  const float j3 = j2 * Yk;
  const float j4 = xi2 * Xk;
  const float* C = q.c;
  const float var_pose = j2 * (C[0] * j2 + C[1] * j3 + C[2] * j4) +
                         j3 * (C[3] * j2 + C[4] * j3 + C[5] * j4) +
                         j4 * (C[6] * j2 + C[7] * j3 + C[8] * j4);
  const float var_obs = clamp_min(var_sensor + var_pose, p.min_var);

  // K8: gate + Kalman update.
  const float resid = xi_obs_kf - kx;
  const float gate = (resid * resid <= (kv + var_obs) * p.gate_k2) ? 1.f : 0.f;
  const float fuse = valid * kfm * gate;
  const float k_gain = kv / clamp_min(kv + var_obs, 1e-12f);
  float xi_new = fuse > 0.f ? kx + k_gain * resid : kx;
  float var_new = fuse > 0.f ? (1.f - k_gain) * kv : kv;
  var_new = clamp_max(clamp_min(var_new, p.min_var), p.max_var);

  // Validity growth: a hole pixel claims a guess-consistent observation.
  float claim = 0.f;
  if (p.grow) {
    const float consistent = fabsf(xi_obs_kf - gs) <= p.claim_tol ? 1.f : 0.f;
    claim = (kfm < 0.5f ? 1.f : 0.f) * gm * valid * consistent;
    if (claim > 0.f) {
      xi_new = xi_obs_kf;
      var_new = clamp_max(clamp_min(var_obs * p.claim_infl, p.min_var), p.max_var);
    }
  }
  Out o;
  o.xi = xi_new;
  o.var = var_new;
  o.mask = claim > kfm ? claim : kfm;
  o.hits = claim > 0.f ? 1.f : hits + fuse;
  o.fuse = fuse;
  return o;
}

}  // namespace fusion
