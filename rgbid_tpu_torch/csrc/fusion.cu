// Inverse-depth fusion of one frame into the keyframe (K8 + K9), with the
// hole guess, validity growth, hit counts and mask update, in one launch.
//
// Replaces: rgbid_tpu/ops/pallas_kernels.py, _fusion_kernel (entry
// fusion_pallas), and what the JAX package ran around it in XLA
// (rgbid_tpu/mapping/fusion.py: hole_guess, the hypothesis choice,
// warp_points, the corner gather, _rigid_inverse, and fuse_and_grow's hit
// and mask update; rgbid_tpu/tracking/step.py: the pose-noise floor added
// to the tracker's covariance). Each thread takes four consecutive
// level-0 pixels and runs fusion::pixel (fusion_pixel.cuh) on each; it
// writes xi', var', mask' = max(mask, claim) and hits' = claim ? 1 :
// hits + fuse. Every block counts its fused pixels into one partial; the
// last block to arrive sums the partials in block-index order into
// n_fused (irls::sum_rows). No fuse or claim plane reaches device memory.
//
// What bounds it on this card: bytes. At VGA a fused frame reads six
// level-0 planes (estimate, variance, mask, hits, and the current frame's
// inverse depth and mask) plus the coarse inverse-depth levels, and writes
// four planes: 12.7 MB, 3.8 us at 3.35 TB/s, once per fused frame. The
// design moves the level-0 planes as 16-byte loads and stores (four pixels
// a thread; (u, v) come from the flat index, so an odd width needs no row
// alignment, and the last n % 4 pixels take a scalar tail), reads the
// gathered and coarse planes through the read-only path, runs a
// grid-stride loop over at most irls::kMinBlocksPerSm blocks per SM, and
// makes one launch where the two-launch design before it also wrote and
// read fuse and claim planes and ran ~40 small PyTorch ops around it.
//
// Determinism: the one atomic counts block arrivals; the count is summed
// in block-index order, and no float is added atomically.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fusion_pixel.cuh"
#include "irls_common.cuh"

namespace {

using irls::kThreads;

__device__ __forceinline__ float4 ro4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void put4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Vec: every level-0 plane is 16-byte aligned, so a full quad of pixels
// moves as one float4 per plane.
template <bool Vec>
__global__ void __launch_bounds__(kThreads, irls::kMinBlocksPerSm)
fusion_kernel(FusionParams p, const float* __restrict__ T, const float* __restrict__ cov,
              const float* __restrict__ kf_xi, const float* __restrict__ kf_var,
              const float* __restrict__ kf_mask, const float* __restrict__ kf_hits,
              const float* __restrict__ cur_xi, const float* __restrict__ cur_mask,
              float* __restrict__ xi_out, float* __restrict__ var_out,
              float* __restrict__ mask_out, float* __restrict__ hits_out,
              float* __restrict__ partials, unsigned int* __restrict__ counter,
              float* __restrict__ n_fused) {
  __shared__ fusion::Pose pose;
  if (threadIdx.x == 0) fusion::load_pose(p, T, cov, pose);
  __syncthreads();
  const int n = p.h * p.w;
  const int quads = (n + 3) / 4;
  float count = 0.f;
  for (int q = blockIdx.x * kThreads + threadIdx.x; q < quads; q += gridDim.x * kThreads) {
    const int i = 4 * q;
    // (u, v) of the quad's first pixel; the rest follow without a division.
    int iv = i / p.w, iu = i - iv * p.w;
    if (Vec && i + 4 <= n) {
      const float4 x = ro4(kf_xi + i), v = ro4(kf_var + i);
      const float4 m = ro4(kf_mask + i), h = ro4(kf_hits + i);
      const fusion::Out o0 = fusion::pixel(p, pose, iu, iv, x.x, v.x, m.x, h.x, cur_xi, cur_mask);
      fusion::next(p, iu, iv);
      const fusion::Out o1 = fusion::pixel(p, pose, iu, iv, x.y, v.y, m.y, h.y, cur_xi, cur_mask);
      fusion::next(p, iu, iv);
      const fusion::Out o2 = fusion::pixel(p, pose, iu, iv, x.z, v.z, m.z, h.z, cur_xi, cur_mask);
      fusion::next(p, iu, iv);
      const fusion::Out o3 = fusion::pixel(p, pose, iu, iv, x.w, v.w, m.w, h.w, cur_xi, cur_mask);
      put4(xi_out + i, o0.xi, o1.xi, o2.xi, o3.xi);
      put4(var_out + i, o0.var, o1.var, o2.var, o3.var);
      put4(mask_out + i, o0.mask, o1.mask, o2.mask, o3.mask);
      put4(hits_out + i, o0.hits, o1.hits, o2.hits, o3.hits);
      count += o0.fuse + o1.fuse + o2.fuse + o3.fuse;
    } else {
      for (int k = i; k < i + 4 && k < n; ++k, fusion::next(p, iu, iv)) {
        const fusion::Out o = fusion::pixel(p, pose, iu, iv, kf_xi[k], kf_var[k], kf_mask[k],
                                            kf_hits[k], cur_xi, cur_mask);
        xi_out[k] = o.xi;
        var_out[k] = o.var;
        mask_out[k] = o.mask;
        hits_out[k] = o.hits;
        count += o.fuse;
      }
    }
  }
  // Counts of 0/1 values stay exact in float32 up to 2^24 pixels.
  const float acc[1] = {count};
  irls::block_reduce<1>(acc, partials + blockIdx.x);
  if (!irls::last_to_arrive(counter, 1)) return;
  __shared__ float total[1];
  irls::sum_rows<1>(partials, gridDim.x, total);
  if (threadIdx.x == 0) {
    *n_fused = total[0];
    *counter = 0u;
  }
}

}  // namespace

// One fused frame. ``partials`` holds max_blocks floats; ``counter`` is 0
// on entry and is 0 again when the launch ends.
extern "C" int fusion_launch(FusionParams p, int max_blocks, const float* T, const float* cov,
                             const float* kf_xi, const float* kf_var, const float* kf_mask,
                             const float* kf_hits, const float* cur_xi, const float* cur_mask,
                             float* xi_out, float* var_out, float* mask_out, float* hits_out,
                             float* partials, unsigned int* counter, float* n_fused,
                             void* stream) {
  if (p.n_coarse < 0 || p.n_coarse > fusion::kMaxCoarse) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int quads = (p.h * p.w + 3) / 4;
  const int blocks = max(1, min((quads + kThreads - 1) / kThreads, max_blocks));
  const float* planes[] = {kf_xi, kf_var, kf_mask, kf_hits, xi_out, var_out, mask_out, hits_out};
  bool aligned = true;
  for (const float* q : planes) aligned &= reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (aligned) {
    fusion_kernel<true><<<blocks, kThreads, 0, st>>>(p, T, cov, kf_xi, kf_var, kf_mask, kf_hits,
                                                     cur_xi, cur_mask, xi_out, var_out, mask_out,
                                                     hits_out, partials, counter, n_fused);
  } else {
    fusion_kernel<false><<<blocks, kThreads, 0, st>>>(p, T, cov, kf_xi, kf_var, kf_mask, kf_hits,
                                                      cur_xi, cur_mask, xi_out, var_out, mask_out,
                                                      hits_out, partials, counter, n_fused);
  }
  return static_cast<int>(cudaGetLastError());
}
