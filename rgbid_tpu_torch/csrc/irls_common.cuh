// Device code shared by the hand kernels (esm_normal_eq.cu, esm_stratified.cu,
// ic_normal_eq.cu, fusion.cu): the per-pixel warp and 4-corner gather (of
// float32 or bfloat16 planes), the fixed-order block reduction, the
// last-block pattern (an arrival counter, then the cross-block sum in
// block-index order), a grid-wide barrier for cooperative launches, the
// early-exit test of an IRLS launch, and the end of an IRLS iteration in
// the last block to finish (the normal-equation finalize, the 6x6 solve
// and the pose update of irls_solve.cuh).
//
// Float order: every function follows the plain PyTorch versions
// (ops/warp.py, ops/gauss_newton.py) operation by operation; the build
// disables FMA contraction (-fmad=false), so per-pixel values round exactly
// like the plain versions'.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "irls_solve.cuh"

// Internal linkage: each .cu file that includes this gets its own copy.
namespace irls {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNormalSums = 32;  // 21 H, 6 b, error, inliers, valid, 2 sigma statistics
// The fused IRLS kernels' registers are capped so that this many blocks fit
// on an SM: at level 0 (300 blocks of 256) the whole grid is then resident
// at once on the 132 SMs of an H100. ops/kernels.py sizes the grid and the
// partials buffer to the same number of blocks per SM.
constexpr int kMinBlocksPerSm = 3;

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

// A stored plane value as float32: bfloat16 widens exactly, and every
// operation after the load is float32 (the plain versions widen too).
// Loads are one element each: at an odd width (641x481) a bfloat16 plane's
// start is not 4-byte aligned, so paired loads would need a check.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Bilinear blend of one plane, in sample_stack7's order.
template <typename P>
__device__ __forceinline__ float blend(const P* __restrict__ pl, const Corners& c) {
  return to_f32(pl[c.i00]) * c.w00 + to_f32(pl[c.i01]) * c.w01 + to_f32(pl[c.i10]) * c.w10 +
         to_f32(pl[c.i11]) * c.w11;
}

// The {0, 1} mask sampled as the product of all four corners.
template <typename P>
__device__ __forceinline__ float corner_product(const P* __restrict__ pl, const Corners& c) {
  return to_f32(pl[c.i00]) * to_f32(pl[c.i01]) * to_f32(pl[c.i10]) * to_f32(pl[c.i11]);
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

// Sums the (n_rows, N) partials column by column in a fixed order:
// sums[k] = the rows' column k. Every thread of the block must call it; on
// return ``sums`` (shared, N floats) is complete. The rows are read through
// L2 (__ldcg): other blocks of the same launch wrote them.
template <int N>
__device__ __forceinline__ void sum_partials(const float* __restrict__ partials, int n_rows,
                                             float* sums) {
  static_assert(N <= 32, "one lane per sum");
  __shared__ float part[kWarps][32];
  const int k = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  float s = 0.f;
  if (k < N) {
#pragma unroll 8
    for (int b = g; b < n_rows; b += kWarps) s += __ldcg(partials + b * N + k);
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

// Every thread of the block calls it once the block's row of partials is
// written (by threads < row_threads); the grid may be 2-D. The block counts
// its arrival on ``counter``; true in every thread of the last block to
// arrive, which then sees every block's row. The writers make their row
// visible to the whole card before the block counts, so the count is the
// only atomic and the rows are summed in block-index order whichever block
// arrives last. The caller's last block sets ``counter`` back to 0 before
// the launch ends.
__device__ __forceinline__ bool last_to_arrive(unsigned int* __restrict__ counter,
                                               int row_threads) {
  __shared__ bool last;
  if (threadIdx.x < row_threads) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  return last;
}

// Sums short (n_rows, N) rows (N <= 3: the sigma and fusion kernels) with
// every thread of the block: thread t adds rows t, t + kThreads, ... (its
// loads all in flight at once, read through L2), then the block's
// fixed-order reduction. sum_partials would leave all but N lanes of each
// warp idle and pay one L2 round trip per few rows. Every thread must call
// it; on return ``sums`` (shared, N floats) is complete. The order is fixed,
// so the sums are the same from run to run.
template <int N>
__device__ __forceinline__ void sum_rows(const float* __restrict__ rows, int n_rows,
                                         float* sums) {
  float v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = 0.f;
  for (int b = threadIdx.x; b < n_rows; b += kThreads) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __ldcg(rows + b * N + k);
  }
  __syncthreads();  // an earlier block_reduce<N> of this block is done with its shared memory
  block_reduce<N>(v, sums);
  __syncthreads();
}

// A grid-wide barrier in which the last block to arrive does work before
// the others go on, for a cooperative launch (cudaLaunchCooperativeKernel,
// so that every block is resident). Written by hand rather than with
// cooperative_groups::this_grid().sync(): its state is two words of the
// kernels' own workspace (``arrived``, which counts arrivals over the
// launch and is 0 between launches, and ``generation``, which counts
// barriers and is never reset), its memory ordering is last_to_arrive's
// fence-then-count, the release is one atomic, the last block's work needs
// no second barrier, and the build needs no separate compilation (-rdc).
// Every thread of every block calls grid_arrive once the block's writes
// are done: it returns the generation read before arriving, and
// ``last`` is true in the last block. The last block reads what every block
// wrote (through L2, __ldcg), does its work and calls grid_release; every
// other block calls grid_wait with the returned generation, after which it
// sees what the last block wrote (read it with __ldcg).
__device__ __forceinline__ unsigned int grid_arrive(unsigned int* __restrict__ arrived,
                                                    unsigned int* __restrict__ generation,
                                                    bool& last) {
  __shared__ bool s_last;
  __shared__ unsigned int s_seen;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    // Read before arriving: the generation cannot move until this block
    // has arrived too.
    s_seen = *static_cast<volatile unsigned int*>(generation);
    s_last = (atomicAdd(arrived, 1u) + 1u) % gridDim.x == 0u;
  }
  __syncthreads();
  last = s_last;
  return s_seen;
}

__device__ __forceinline__ void grid_release(unsigned int* __restrict__ generation) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(generation, 1u);
}

__device__ __forceinline__ void grid_wait(unsigned int* __restrict__ generation,
                                          unsigned int seen) {
  if (threadIdx.x == 0) {
    while (*static_cast<volatile unsigned int*>(generation) == seen) __nanosleep(20);
    __threadfence();
  }
  __syncthreads();
}

// Result layout of one IRLS launch (ops/kernels.py reads it):
// [0:36] H (6x6, per valid pixel), [36:42] b, [42] sigma2_int,
// [43] sigma2_xi, [44] error, [45] n_valid, [46] inlier_frac, [47] 0,
// [48:64] the updated pose T' (4x4 row-major), [64:70] the applied delta.
constexpr int kResult = 48;
constexpr int kOut = kResult + 16 + 6;
// Level slots of the device's count of IRLS iterations run (ops/kernels.py
// MAX_SLOTS).
constexpr int kMaxSlots = 8;

// The early exit (TrackingConfig.early_exit_tol, conv_skip_tol): a level
// stops changing once the previous iteration's applied step has norm <=
// tol. Every thread of every block calls it at entry with the previous
// launch's output ``prev`` (nullptr for a level's first iteration, or with
// the exit off): it reads prev's delta (prev[64:70]), takes the norm in
// ops/gauss_newton.py::step_norm's order, and returns true when
// !(norm > tol) — the same in every block, since all read the same floats.
// Block 0 has then copied prev's kOut floats to ``out`` (the carry goes
// on unchanged, the pose, the scales and the result included), and the
// caller returns before it touches its partials, rows or counter words.
__device__ __forceinline__ bool converged(const float* __restrict__ prev, float tol,
                                          float* __restrict__ out) {
  if (prev == nullptr) return false;
  const float* d = prev + kResult + 16;
  float s = d[0] * d[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) s = s + d[k] * d[k];
  if (sqrtf(s) > tol) return false;
  if (blockIdx.x == 0 && threadIdx.x < kOut) out[threadIdx.x] = prev[threadIdx.x];
  return true;
}

// The predicate of a launch (the device word ``go``, nullptr: always runs).
// A masked rerun or a rescue pyramid is always enqueued; its launches run
// only when the word the consensus vote wrote is 1 (the counterpart of the
// JAX package's lax.cond). With go == 0 every block returns at entry,
// after block 0 has copied ``hold`` (kOut floats: the carry the chain
// would otherwise have, the pose, scales and result included) to ``out``;
// like a converged launch, it touches no partials, rows or counter words
// and adds nothing to ``runs``. With go == 1 (or nullptr) the launch is
// the one it would be without the word.
__device__ __forceinline__ bool held(const int* __restrict__ go, const float* __restrict__ hold,
                                     float* __restrict__ out) {
  if (go == nullptr || *go != 0) return false;
  if (blockIdx.x == 0 && threadIdx.x < kOut) out[threadIdx.x] = hold[threadIdx.x];
  return true;
}

// The end of one IRLS iteration. Every thread of every block calls it once
// its block's row of normal-equation partials is written. The last block
// to arrive (last_to_arrive) sums every block's row in block-index order,
// writes the result (with ``lagged`` the scales are the updated ones for
// the next iteration, a disabled geometric channel keeping ``s2x``;
// without it, ``s2i`` and ``s2x``, the scales the pass weighted with),
// then one thread solves the 6x6 system and updates the pose, and adds one
// to ``runs`` (a level slot of the count of iterations run; nullptr: not
// counted). Returns true in the last block.
__device__ __forceinline__ bool finish_iteration(
    const float* __restrict__ partials, unsigned int* __restrict__ counter, float s2i,
    float s2x, int use_geometric, int lagged, const float* __restrict__ T, float damping,
    float* __restrict__ out, unsigned int* __restrict__ runs) {
  if (!last_to_arrive(counter, kNormalSums)) return false;

  __shared__ float sums[kNormalSums];
  __shared__ float res[kResult];
  sum_partials<kNormalSums>(partials, gridDim.x, sums);
  const float n_valid = sums[29];
  const float inv_n = 1.0f / clamp_min(n_valid, 1.f);
  const int t = threadIdx.x;
  if (t < 36) {
    const int a = min(t / 6, t % 6), c = max(t / 6, t % 6);
    res[t] = sums[a * 6 - a * (a - 1) / 2 + (c - a)] * inv_n;
  } else if (t < 42) {
    res[t] = sums[21 + (t - 36)] * inv_n;
  } else if (t == 42) {
    res[t] = lagged ? clamp_min(sums[30] * inv_n, 1e-12f) : s2i;
  } else if (t == 43) {
    res[t] = (lagged && use_geometric) ? clamp_min(sums[31] * inv_n, 1e-12f) : s2x;
  } else if (t == 44) {
    res[t] = sums[27] * inv_n;
  } else if (t == 45) {
    res[t] = n_valid;
  } else if (t == 46) {
    res[t] = sums[28] * inv_n;
  } else if (t == 47) {
    res[t] = 0.f;
  }
  __syncthreads();
  if (t < kResult) out[t] = res[t];
  if (t == 0) {
    solve_update(res, res + 36, damping, res[45], T, out + kResult, out + kResult + 16);
    *counter = 0u;
    if (runs != nullptr) *runs += 1u;
  }
  return true;
}

}  // namespace
}  // namespace irls
