// The end of one IRLS iteration alone: the damped 6x6 solve and the SE(3)
// pose update from an evaluation that was all-reduced across ranks.
//
// Replaces: the ic_update that follows gauss_newton.allreduce_irls in the
// JAX package's row-sharded tracker (rgbid_tpu/tracking/tracker.py:391-396,
// rgbid_tpu/ops/gauss_newton.py:107-127, 530). The one-process tracker
// needs no such launch: its IRLS kernels solve in their own last block
// (irls_common.cuh, finish_iteration). A row-sharded iteration cannot:
// every rank evaluates its band (the result-only ESM launch), the ranks
// all-reduce the 48 result floats (ops/kernels.py allreduce_irls), and
// then every rank makes this launch on the same floats. Likewise the
// replicated Cholesky solve and pose update of the JAX package's IC SPMD
// tracker (rgbid_tpu/parallel/spmd.py:124-128), which steps on any finite
// delta: it launches with min_valid -inf.
//
// One block, one thread of it doing the work: the solve is 6x6 and the
// pose 4x4, so launch latency bounds it (about 0.3 KB read and written).
// The body is the fused kernels' own tail, irls::solve_update (built with
// -fmad=false like them), so on the same result, T and damping the launch
// writes the same bits as the fused launch's last block. Its output has
// the fused layout (irls::kOut floats: result | T' | delta), so the next
// iteration's early exit (``prev``) and ops/kernels.py's IrlsStep views
// read it unchanged. Under the early exit, a ``prev`` whose step norm is
// <= tol is copied to ``out`` and nothing else runs (irls::converged);
// under a predicate word of 0, ``hold`` is (irls::held).

#include <cuda_runtime.h>

#include "irls_common.cuh"

namespace {

constexpr int kSolveThreads = 96;  // >= irls::kOut: the copies are one float a thread
static_assert(kSolveThreads >= irls::kOut, "one thread per output float");

__global__ void __launch_bounds__(kSolveThreads)
irls_solve_kernel(const float* __restrict__ result, const float* __restrict__ T, float damping,
                  float tol, float min_valid, float* __restrict__ out,
                  const float* __restrict__ prev, unsigned int* __restrict__ runs,
                  const int* __restrict__ go, const float* __restrict__ hold) {
  if (irls::held(go, hold, out)) return;
  if (irls::converged(prev, tol, out)) return;
  const int t = threadIdx.x;
  if (t < irls::kResult) out[t] = result[t];
  if (t == 0) {
    // result: [0:36] H, [36:42] b, [45] n_valid (irls_common.cuh).
    irls::solve_update(result, result + 36, damping, result[45], T, out + irls::kResult,
                       out + irls::kResult + 16, min_valid);
    if (runs != nullptr) *runs += 1u;
  }
}

}  // namespace

// out (irls::kOut floats) = [result (48) | T' (16) | delta (6)] from the
// all-reduced ``result`` (48 floats), the pose ``T`` (16) and ``damping``;
// the step is suppressed unless n_valid > ``min_valid`` (100 in the
// row-sharded ESM tracker, as ic_update; -inf in the IC SPMD tracker).
// ``prev``: the previous iteration's out, or nullptr; ``runs``: the level's
// slot of the count of iterations run, or nullptr; ``go`` and ``hold``: the
// launch's predicate word and what it copies when the word is 0
// (irls::held), or nullptr.
extern "C" int irls_solve_launch(float damping, float tol, float min_valid, const float* result,
                                 const float* T, float* out, const float* prev,
                                 unsigned int* runs, const int* go, const float* hold,
                                 void* stream) {
  irls_solve_kernel<<<1, kSolveThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      result, T, damping, tol, min_valid, out, prev, runs, go, hold);
  return static_cast<int>(cudaGetLastError());
}
