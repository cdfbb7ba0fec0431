// Inverse-depth fusion with uncertainty propagation and validity growth
// (K8 + K9), one thread per level-0 keyframe pixel.
//
// Replaces: rgbid_tpu/ops/pallas_kernels.py, _fusion_kernel (entry
// fusion_pallas). On the TPU the hypothesis choice, warp_points and the
// corner gather of the current frame stayed in XLA (mapping/fusion.py)
// and the kernel read five pre-gathered planes; here each thread picks its
// depth hypothesis (the fused estimate, or the coarse-pyramid guess for a
// hole pixel), warps it into the current frame, gathers the current
// inverse depth and validity, re-expresses the observation in keyframe
// coordinates, propagates sensor variance and the pose covariance (in the
// [z, wx, wy] subspace), gates on gate_k, runs the Kalman update, claims
// guess-consistent hole pixels, and writes xi', var', the fuse mask and the
// claim mask. A block sums its fuse mask into one partial; a one-block
// second pass adds the partials in a fixed order into n_fused.
//
// What bounds it on this card: at VGA it reads 7-9 planes and writes 4
// (about 15 MB), a few microseconds of bandwidth, once per fused frame, so
// launch latency bounds it. The design keeps the whole pipeline in one
// pass with no intermediate planes in device memory, and reads the pose,
// its inverse and the covariance from device memory (no host read).
//
// Determinism: no atomics; the count is summed in a fixed order.
//
// Float order: the per-pixel arithmetic follows the plain PyTorch version
// (mapping/fusion.py) operation by operation and the build disables FMA
// contraction (-fmad=false), so the masks and n_fused equal the plain
// version's exactly.

#include <cuda_runtime.h>

// Must match FusionParams in ops/_build.py field by field.
struct FusionParams {
  int h, w;             // level-0 plane size
  int grow;             // validity growth on (guess/gmask are read)
  float fx, fy, cx, cy;
  float inv_fx, inv_fy; // 1/fx, 1/fy
  float umax, vmax;     // w - 1.001, h - 1.001
  float sensor_var;     // sensor_sigma_xi^2
  float gate_k2;        // gate_k^2
  float min_var, max_var;
  float claim_tol;
  float claim_infl;     // claim_var_inflation
};

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

__global__ void __launch_bounds__(kThreads)
fusion_kernel(FusionParams p, const float* __restrict__ Tck, const float* __restrict__ Tkc,
              const float* __restrict__ cov, const float* __restrict__ kf_xi,
              const float* __restrict__ kf_var, const float* __restrict__ kf_mask,
              const float* __restrict__ cur_xi, const float* __restrict__ cur_mask,
              const float* __restrict__ guess, const float* __restrict__ gmask,
              float* __restrict__ xi_out, float* __restrict__ var_out,
              float* __restrict__ fuse_out, float* __restrict__ claim_out,
              float* __restrict__ partials) {
  __shared__ float red[kThreads];
  const int n = p.h * p.w;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float fuse = 0.f;
  if (i < n) {
    const float kfm = kf_mask[i];
    const float kx = kf_xi[i];
    const float kv = kf_var[i];
    float xi_eff = kx, mask_eff = kfm, gs = 0.f, gm = 0.f;
    if (p.grow) {
      gs = guess[i];
      gm = gmask[i];
      xi_eff = kfm > 0.f ? kx : gs;
      mask_eff = fmaxf(kfm, gm);
    }
    // warp_points (ops/warp.py): backproject the hypothesis, move it by T_ck.
    const float u = static_cast<float>(i % p.w);
    const float v = static_cast<float>(i / p.w);
    const float z = 1.0f / clamp_min(xi_eff, 1e-8f);
    const float x = (u - p.cx) * p.inv_fx * z;
    const float y = (v - p.cy) * p.inv_fy * z;
    const float xp = Tck[0] * x + Tck[1] * y + Tck[2] * z + Tck[3];
    const float yp = Tck[4] * x + Tck[5] * y + Tck[6] * z + Tck[7];
    const float zp = Tck[8] * x + Tck[9] * y + Tck[10] * z + Tck[11];
    const float front = zp > 1e-6f ? 1.f : 0.f;
    const float rho = 1.0f / clamp_min(zp, 1e-6f);
    const float up = p.fx * xp * rho + p.cx;
    const float vp = p.fy * yp * rho + p.cy;
    const float valid0 = mask_eff * front;

    // Corner gather of [cur_xi, cur_mask] (sample_tracker_planes).
    const float inb = (up >= 0.f && up <= p.umax && vp >= 0.f && vp <= p.vmax) ? 1.f : 0.f;
    const float uc = clamp_max(clamp_min(up, 0.f), p.umax);
    const float vc = clamp_max(clamp_min(vp, 0.f), p.vmax);
    const int u0 = min(max(static_cast<int>(floorf(uc)), 0), p.w - 1);
    const int v0 = min(max(static_cast<int>(floorf(vc)), 0), p.h - 1);
    const float fu = uc - static_cast<float>(u0);
    const float fv = vc - static_cast<float>(v0);
    const int u1 = min(u0 + 1, p.w - 1);
    const int v1 = min(v0 + 1, p.h - 1);
    const int i00 = v0 * p.w + u0, i01 = v0 * p.w + u1;
    const int i10 = v1 * p.w + u0, i11 = v1 * p.w + u1;
    const float w00 = (1.f - fu) * (1.f - fv);
    const float w01 = fu * (1.f - fv);
    const float w10 = (1.f - fu) * fv;
    const float w11 = fu * fv;
    const float xi_obs_cur =
        cur_xi[i00] * w00 + cur_xi[i01] * w01 + cur_xi[i10] * w10 + cur_xi[i11] * w11;
    const float mask_ok = cur_mask[i00] * cur_mask[i01] * cur_mask[i10] * cur_mask[i11];
    float valid = valid0 * inb * mask_ok * (xi_obs_cur > 1e-6f ? 1.f : 0.f);

    // Observation in keyframe coordinates (T_kc = inverse of T_ck).
    const float zc = 1.0f / clamp_min(xi_obs_cur, 1e-6f);
    const float dir_x = (up - p.cx) * p.inv_fx;
    const float dir_y = (vp - p.cy) * p.inv_fy;
    const float Xk = (Tkc[0] * dir_x + Tkc[1] * dir_y + Tkc[2]) * zc + Tkc[3];
    const float Yk = (Tkc[4] * dir_x + Tkc[5] * dir_y + Tkc[6]) * zc + Tkc[7];
    const float Zk = (Tkc[8] * dir_x + Tkc[9] * dir_y + Tkc[10]) * zc + Tkc[11];
    valid = valid * (Zk > 1e-6f ? 1.f : 0.f);
    const float zk = clamp_min(Zk, 1e-6f);
    const float xi_obs_kf = valid > 0.f ? 1.0f / zk : 0.f;

    // K9a: sensor noise through the frame change.
    const float r3dir = Tkc[8] * dir_x + Tkc[9] * dir_y + Tkc[10];
    const float xc = clamp_min(xi_obs_cur, 1e-6f);
    const float dxi = r3dir / (zk * zk * (xc * xc));
    const float var_sensor = dxi * dxi * p.sensor_var;
    // K9b: pose covariance through J = -xi^2 [0, 0, 1, Yk, -Xk, 0].
    const float xi2 = xi_obs_kf * xi_obs_kf;
    const float j2 = -xi2;
    const float j3 = j2 * Yk;
    const float j4 = xi2 * Xk;
    const float var_pose = j2 * (cov[14] * j2 + cov[15] * j3 + cov[16] * j4) +
                           j3 * (cov[20] * j2 + cov[21] * j3 + cov[22] * j4) +
                           j4 * (cov[26] * j2 + cov[27] * j3 + cov[28] * j4);
    const float var_obs = clamp_min(var_sensor + var_pose, p.min_var);

    // K8: gate + Kalman update.
    const float resid = xi_obs_kf - kx;
    const float gate = (resid * resid <= (kv + var_obs) * p.gate_k2) ? 1.f : 0.f;
    fuse = valid * kfm * gate;
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
    xi_out[i] = xi_new;
    var_out[i] = var_new;
    fuse_out[i] = fuse;
    claim_out[i] = claim;
  }
  red[threadIdx.x] = fuse;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = red[0];
}

__global__ void __launch_bounds__(kThreads)
sum_partials(const float* __restrict__ partials, int n_blocks, float* __restrict__ out) {
  __shared__ float red[kThreads];
  float s = 0.f;
  for (int b = threadIdx.x; b < n_blocks; b += kThreads) s += partials[b];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int k = kThreads / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) red[threadIdx.x] += red[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = red[0];
}

}  // namespace

extern "C" int fusion_launch(FusionParams p, const float* Tck, const float* Tkc,
                             const float* cov, const float* kf_xi, const float* kf_var,
                             const float* kf_mask, const float* cur_xi,
                             const float* cur_mask, const float* guess, const float* gmask,
                             float* xi_out, float* var_out, float* fuse_out,
                             float* claim_out, float* partials, float* n_fused,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (p.h * p.w + kThreads - 1) / kThreads;
  if (n_blocks > 0) {
    fusion_kernel<<<n_blocks, kThreads, 0, st>>>(p, Tck, Tkc, cov, kf_xi, kf_var, kf_mask,
                                                 cur_xi, cur_mask, guess, gmask, xi_out,
                                                 var_out, fuse_out, claim_out, partials);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sum_partials<<<1, kThreads, 0, st>>>(partials, n_blocks, n_fused);
  return static_cast<int>(cudaGetLastError());
}
