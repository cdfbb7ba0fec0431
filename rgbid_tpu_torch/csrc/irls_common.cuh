// Device code shared by the IRLS kernels (esm_normal_eq.cu, ic_normal_eq.cu):
// the per-pixel warp and 4-corner gather, the fixed-order block and
// second-pass reductions, and the normal-equation finalize.
//
// Float order: every function follows the plain PyTorch versions
// (ops/warp.py, ops/gauss_newton.py) operation by operation; the build
// disables FMA contraction (-fmad=false), so per-pixel values round exactly
// like the plain versions'.

#pragma once

#include <cuda_runtime.h>

// Internal linkage: each .cu file that includes this gets its own copy.
namespace irls {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNormalSums = 32;  // 21 H, 6 b, error, inliers, valid, 2 sigma statistics

// torch.clamp semantics: NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

struct Projection {
  float rho, front, up, vp;
};

// transform_project (ops/warp.py): the template point through T (row-major
// 4x4 in device memory), inverse depth, in-front flag, pixel coordinates.
__device__ __forceinline__ Projection project(const float* __restrict__ T, float Px, float Py,
                                              float Pz, float fx, float fy, float cx, float cy) {
  const float xp = T[0] * Px + T[1] * Py + T[2] * Pz + T[3];
  const float yp = T[4] * Px + T[5] * Py + T[6] * Pz + T[7];
  const float zp = T[8] * Px + T[9] * Py + T[10] * Pz + T[11];
  Projection pr;
  pr.front = zp > 1e-6f ? 1.f : 0.f;
  pr.rho = 1.0f / clamp_min(zp, 1e-6f);
  pr.up = fx * xp * pr.rho + cx;
  pr.vp = fy * yp * pr.rho + cy;
  return pr;
}

struct Corners {
  int i00, i01, i10, i11;
  float w00, w01, w10, w11;
  float inb;
};

// _corner_weights (ops/warp.py): clip to [0, w - 1.001], floor, bilinear
// weights, and the in-bounds flag.
__device__ __forceinline__ Corners corners(float up, float vp, int h, int w, float umax,
                                           float vmax) {
  Corners c;
  c.inb = (up >= 0.f && up <= umax && vp >= 0.f && vp <= vmax) ? 1.f : 0.f;
  const float uc = clamp_max(clamp_min(up, 0.f), umax);
  const float vc = clamp_max(clamp_min(vp, 0.f), vmax);
  // A NaN coordinate converts to 0; the clamp keeps every read in range.
  const int u0 = min(max(static_cast<int>(floorf(uc)), 0), w - 1);
  const int v0 = min(max(static_cast<int>(floorf(vc)), 0), h - 1);
  const float fu = uc - static_cast<float>(u0);
  const float fv = vc - static_cast<float>(v0);
  const int u1 = min(u0 + 1, w - 1);
  const int v1 = min(v0 + 1, h - 1);
  c.i00 = v0 * w + u0;
  c.i01 = v0 * w + u1;
  c.i10 = v1 * w + u0;
  c.i11 = v1 * w + u1;
  c.w00 = (1.f - fu) * (1.f - fv);
  c.w01 = fu * (1.f - fv);
  c.w10 = (1.f - fu) * fv;
  c.w11 = fu * fv;
  return c;
}

// Bilinear blend of one plane, in sample_stack7's order.
__device__ __forceinline__ float blend(const float* __restrict__ pl, const Corners& c) {
  return pl[c.i00] * c.w00 + pl[c.i01] * c.w01 + pl[c.i10] * c.w10 + pl[c.i11] * c.w11;
}

// The {0, 1} mask sampled as the product of all four corners.
__device__ __forceinline__ float corner_product(const float* __restrict__ pl, const Corners& c) {
  return pl[c.i00] * pl[c.i01] * pl[c.i10] * pl[c.i11];
}

// Student-t weight without the 1/sigma^2 factor: (nu + 1) / (nu + r^2 / s2),
// in PyTorch's order for a Python scalar over a tensor: reciprocal, then
// multiply.
__device__ __forceinline__ float student_w0(float r, float s2, float nu, float nu1) {
  return (1.0f / (r * r / s2 + nu)) * nu1;
}

// One block's N per-thread values -> one row of N partials: warp shuffles,
// then the warps' sums in shared memory in a fixed order. Every thread of
// the block must call it.
template <int N>
__device__ __forceinline__ void block_reduce(const float (&v)[N], float* __restrict__ out_row) {
  __shared__ float smem[kWarps * N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) smem[warp * N + k] = x;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
    for (int i = 0; i < kWarps; ++i) s += smem[i * N + threadIdx.x];
    out_row[threadIdx.x] = s;
  }
}

// Second pass, one block: sums[k] = the (n_blocks, N) partials' column k,
// in a fixed order. Every thread of the block must call it; on return
// ``sums`` (shared, N floats) is complete.
template <int N>
__device__ __forceinline__ void sum_partials(const float* __restrict__ partials, int n_blocks,
                                             float* sums) {
  static_assert(N <= 32, "one lane per sum");
  __shared__ float part[kWarps][32];
  const int k = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  float s = 0.f;
  if (k < N) {
    for (int b = g; b < n_blocks; b += kWarps) s += partials[b * N + k];
  }
  part[g][k] = s;
  __syncthreads();
  if (threadIdx.x < N) {
    float tot = 0.f;
    for (int j = 0; j < kWarps; ++j) tot += part[j][threadIdx.x];
    sums[threadIdx.x] = tot;
  }
  __syncthreads();
}

// Sums the (n_blocks, 32) normal-equation partials and writes out[0:36] H
// (6x6, per valid pixel), out[36:42] b, out[42] sigma2_int, out[43]
// sigma2_xi, out[44] error, out[45] n_valid, out[46] inlier_frac. With
// ``lagged`` the scales are the updated ones for the next iteration (a
// disabled geometric channel keeps its incoming scale); without it they are
// the scales the pass weighted with.
__global__ void __launch_bounds__(kThreads)
normal_finalize(const float* __restrict__ partials, int n_blocks,
                const float* __restrict__ s2i_in, const float* __restrict__ s2x_in,
                int use_geometric, int lagged, float* __restrict__ out) {
  __shared__ float sums[kNormalSums];
  sum_partials<kNormalSums>(partials, n_blocks, sums);
  const float n_valid = sums[29];
  const float inv_n = 1.0f / clamp_min(n_valid, 1.f);
  const int t = threadIdx.x;
  if (t < 36) {
    const int a = min(t / 6, t % 6), c = max(t / 6, t % 6);
    out[t] = sums[a * 6 - a * (a - 1) / 2 + (c - a)] * inv_n;
  } else if (t < 42) {
    out[t] = sums[21 + (t - 36)] * inv_n;
  } else if (t == 42) {
    out[t] = lagged ? clamp_min(sums[30] * inv_n, 1e-12f) : *s2i_in;
  } else if (t == 43) {
    out[t] = (lagged && use_geometric) ? clamp_min(sums[31] * inv_n, 1e-12f) : *s2x_in;
  } else if (t == 44) {
    out[t] = sums[27] * inv_n;
  } else if (t == 45) {
    out[t] = n_valid;
  } else if (t == 46) {
    out[t] = sums[28] * inv_n;
  } else if (t == 47) {
    out[t] = 0.f;
  }
}

}  // namespace
}  // namespace irls
