// One motion-consensus vote on the device: analyze, decide and the
// tracker's per-vote bookkeeping, in one launch of one block.
//
// Replaces: no Pallas kernel. The JAX package runs this as XLA inside its
// per-frame program: rgbid_tpu/tracking/consensus.py:134-424 (analyze,
// decide) and the vote's bookkeeping in rgbid_tpu/tracking/tracker.py
// (the raw flags, the attack-probe candidate, the member vector, the
// rerun predicate of its lax.cond). The plain version is
// rgbid_tpu_torch/tracking/consensus.py::vote_plain.
//
// Input: the (K, 50) raw per-stratum sums of one stratified launch
// (esm_stratified.cu; columns as ops/gauss_newton.py STRATIFIED_SUMS), the
// baseline scale and the streak history (K) as device values, and the vote
// state of 5K + 3 floats (member, flags_any, nk_last, probe_cand,
// excl_any, probe_fire, consensus_frac, rescue_flag). Output: the new
// state, the int32 word that predicates the level's masked rerun, and the
// diagnostics (deltas, excluded, hostage, dominant, info_share, the
// decision's member, majority_ok, triggered, rescue, excluded_frac).
//
// Design: K <= 16, so the work is small; launch latency and the chain of
// dependent float64 operations bound it. Each stratum's 6x6 eigenproblem
// is solved by a group of 36 threads, one matrix entry each, in shared
// memory (JACOBI_SWEEPS cyclic sweeps in the round-robin order of
// consensus.py::JACOBI_ROUNDS: three disjoint rotations a round, applied
// to the columns, then the rows, then the eigenvector columns; three
// barriers a round), then six of them do the truncated-eigenspace solve.
// The first design gave the whole eigensolve of a stratum to one thread:
// ~20,000 dependent float64 operations, 189 us a launch against 67 us for
// this one (an H100 80GB HBM3 at 700 W, chip_smoke.py [times]). Thread (j, k) forms the induced-flow
// disagreement m[j][k]. Thread 0 then runs the vote, the medians, the
// hostage test, decide and the bookkeeping, with every sum over the strata
// taken in stratum order. A chain of ~300 small PyTorch ops would capture
// into the frame's graph too, but would cost ~300 graph nodes per vote.
//
// Float order: every operation follows vote_plain one by one, and the
// build disables FMA contraction (-fmad=false), so the kernel's output
// equals the plain version's bit for bit on the same input.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// By-value parameters (ops/_build.py VoteParams). Outside the anonymous
// namespace: the C entry point takes it, and must keep external linkage.
struct VoteParams {
  int k;
  float tol, min_frac, err_ratio, err_floor, trigger_frac, max_frac;
  int persist;
  int attack_probe;
};

namespace {

constexpr int kMaxK = 16;
constexpr int kCols = 50;
// 36 threads per stratum for its eigensolve (also >= kMaxK * kMaxK, one
// thread per (j, k) pair of the flow metric).
constexpr int kThreads = kMaxK * 36;
constexpr int kSweeps = 10;    // consensus.py JACOBI_SWEEPS
constexpr float kMinorityCap = 0.35f;
constexpr float kErrMinorityCap = 0.40f;

__constant__ int kRounds[5][3][2] = {{{0, 1}, {2, 3}, {4, 5}}, {{0, 2}, {1, 4}, {3, 5}},
                                     {{0, 4}, {2, 5}, {1, 3}}, {{0, 5}, {4, 3}, {2, 1}},
                                     {{0, 3}, {5, 1}, {4, 2}}};

// Column of the upper-triangle entry (a, c), a <= c, in the 21-entry
// blocks of the stratified sums.
__device__ __forceinline__ int upper(int a, int c) {
  const int lo = a < c ? a : c, hi = a < c ? c : a;
  return lo * 6 - lo * (lo - 1) / 2 + (hi - lo);
}

// torch.clamp(min=) / torch.maximum semantics: NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ double clamp_min(double x, double lo) { return x < lo ? lo : x; }
__device__ __forceinline__ double tmax(double a, double b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

// consensus.py::nanmedian: the mean of the two middle values of the
// entries with use[k] set and a non-NaN value; 0 when there is none or the
// median is not finite.
__device__ float nanmedian(const float* x, const bool* use, int K) {
  float v[kMaxK];
  int c = 0;
  for (int k = 0; k < K; ++k) {
    const bool ok = use[k] && !(x[k] != x[k]);
    v[k] = ok ? x[k] : INFINITY;
    c += ok ? 1 : 0;
  }
  for (int i = 1; i < K; ++i) {  // insertion sort, ascending
    const float t = v[i];
    int j = i - 1;
    while (j >= 0 && v[j] > t) {
      v[j + 1] = v[j];
      --j;
    }
    v[j + 1] = t;
  }
  int lo = (c - 1) / 2, hi = c / 2;
  lo = lo < 0 ? 0 : (lo > K - 1 ? K - 1 : lo);
  hi = hi < 0 ? 0 : (hi > K - 1 ? K - 1 : hi);
  const float med = (v[lo] + v[hi]) / 2.0f;
  return (c > 0 && isfinite(med)) ? med : 0.f;
}

// Index x's partner in round r's pair.
__device__ __forceinline__ int partner(int r, int x) {
  int p = x;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (kRounds[r][q][0] == x) p = kRounds[r][q][1];
    if (kRounds[r][q][1] == x) p = kRounds[r][q][0];
  }
  return p;
}

// Stratum k's Jacobi eigensolve of Hn (float64) and truncated solve, by the
// 36 threads e = 6 i + j of its group, one matrix entry each: every entry's
// update is the same expression as in the plain version, so the lanes'
// parallel order changes no bit. Every thread of the block calls it (the
// barriers); ``active`` is false for the groups past K.
__device__ void strata_deltas(const float* __restrict__ s, const float* __restrict__ inv_n,
                              int K, float (*delta)[6]) {
  __shared__ double A[kMaxK][6][6], V[kMaxK][6][6], T[kMaxK][6][6], W[kMaxK][6][6];
  __shared__ double cv[kMaxK][6], sv[kMaxK][6], w[kMaxK][6];
  const int t = threadIdx.x;
  const int k = t / 36, e = t % 36, i = e / 6, j = e % 6;
  const bool active = k < K;
  if (active) {
    A[k][i][j] = static_cast<double>(s[k * kCols + upper(i, j)] * inv_n[k]);
    V[k][i][j] = i == j ? 1.0 : 0.0;
  }
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    for (int r = 0; r < 5; ++r) {
      if (active && e < 3) {
        const int P = kRounds[r][e][0], Q = kRounds[r][e][1];
        const double app = A[k][P][P], aqq = A[k][Q][Q], apq = A[k][P][Q];
        const double theta = (aqq - app) / (2.0 * apq);
        const double sgn = theta >= 0.0 ? 1.0 : -1.0;
        double tt = sgn / (fabs(theta) + sqrt(theta * theta + 1.0));
        if (apq == 0.0) tt = 0.0;
        const double c = 1.0 / sqrt(tt * tt + 1.0);
        const double sn = tt * c;
        cv[k][P] = c;
        cv[k][Q] = c;
        sv[k][P] = sn * -1.0;
        sv[k][Q] = sn * 1.0;
      }
      __syncthreads();
      if (active) {
        const int pj = partner(r, j);
        T[k][i][j] = A[k][i][j] * cv[k][j] + A[k][i][pj] * sv[k][j];
        W[k][i][j] = V[k][i][j] * cv[k][j] + V[k][i][pj] * sv[k][j];
      }
      __syncthreads();
      if (active) {
        const int pi = partner(r, i);
        A[k][i][j] = T[k][i][j] * cv[k][i] + T[k][pi][j] * sv[k][i];
        V[k][i][j] = W[k][i][j];
      }
      __syncthreads();
    }
  }
  if (active && e < 6) {
    double emax = A[k][0][0];
    for (int q = 1; q < 6; ++q) emax = tmax(emax, A[k][q][q]);
    const double ev = A[k][e][e];
    const double inv = ev > 0.01 * emax ? 1.0 / clamp_min(ev, 1e-12) : 0.0;
    double proj = V[k][0][e] * static_cast<double>(s[k * kCols + 21] * inv_n[k]);
    for (int l = 1; l < 6; ++l)
      proj = proj + V[k][l][e] * static_cast<double>(s[k * kCols + 21 + l] * inv_n[k]);
    w[k][e] = inv * proj;
  }
  __syncthreads();
  if (active && e < 6) {
    double d = V[k][e][0] * w[k][0];
    for (int q = 1; q < 6; ++q) d = d + V[k][e][q] * w[k][q];
    const float f = static_cast<float>(d);
    delta[k][e] = isfinite(f) ? f : 0.f;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
consensus_vote_kernel(VoteParams p, const float* __restrict__ sums,
                      const float* __restrict__ bscale_p, const float* __restrict__ hist,
                      const float* __restrict__ state, float* __restrict__ state_out,
                      int* __restrict__ go, float* __restrict__ diag) {
  const int K = p.k;
  const int t = threadIdx.x;
  __shared__ float s[kMaxK * kCols];
  __shared__ float nk[kMaxK], inv_n[kMaxK], delta[kMaxK][6];
  __shared__ bool agree[kMaxK][kMaxK];
  __shared__ float n_total;
  for (int i = t; i < K * kCols; i += kThreads) s[i] = sums[i];
  __syncthreads();
  if (t < K) {
    nk[t] = s[t * kCols + 27];
    inv_n[t] = 1.0f / clamp_min(s[t * kCols + 27], 1.f);
  }
  if (t == 0) {
    float acc = s[27];
    for (int k = 1; k < K; ++k) acc = acc + s[k * kCols + 27];
    n_total = clamp_min(acc, 1.f);
  }
  __syncthreads();
  strata_deltas(s, inv_n, K, delta);
  const float bscale = *bscale_p;
  if (t < K * K) {
    const int j = t / K, k = t % K;
    const float* g = s + j * kCols + 29;
    float diff[6];
#pragma unroll
    for (int l = 0; l < 6; ++l) diff[l] = delta[j][l] - delta[k][l];
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float ti = (g[upper(i, 0)] * inv_n[j]) * diff[0];
#pragma unroll
      for (int l = 1; l < 6; ++l) ti = ti + (g[upper(i, l)] * inv_n[j]) * diff[l];
      m = i == 0 ? diff[0] * ti : m + diff[i] * ti;
    }
    const float tol_eff = p.tol * bscale;
    agree[j][k] = m <= tol_eff * tol_eff;
  }
  __syncthreads();
  if (t != 0) return;

  // analyze: the vote, the error outliers, the hostage.
  bool voter[kMaxK], ex_vote[kMaxK], excluded[kMaxK], dominant[kMaxK], hostage[kMaxK];
  bool minority[kMaxK], others[kMaxK];
  float err_n[kMaxK], info_share[kMaxK];
  int n_voters = 0;
  for (int k = 0; k < K; ++k) {
    voter[k] = nk[k] >= p.min_frac * n_total;
    n_voters += voter[k] ? 1 : 0;
    err_n[k] = s[k * kCols + 28] * inv_n[k];
  }
  int best = 0;
  float best_v = 0.f;
  for (int k = 0; k < K; ++k) {
    float sup = (agree[0][k] ? 1.f : 0.f) * (nk[0] * (voter[0] ? 1.f : 0.f));
    for (int j = 1; j < K; ++j) sup = sup + (agree[j][k] ? 1.f : 0.f) * (nk[j] * (voter[j] ? 1.f : 0.f));
    sup = voter[k] ? sup : -1.f;
    if (k == 0 || sup > best_v) {
      best = k;
      best_v = sup;
    }
  }
  const float err_med = nanmedian(err_n, voter, K);
  const float err_thr = clamp_min(p.err_ratio * err_med * bscale, p.err_floor);
  const bool enough = n_voters >= 3;
  const bool majority_ok = (best_v > 0.6f * n_total) && enough;
  float info[kMaxK];
  float info_sum = 0.f;
  for (int k = 0; k < K; ++k) {
    const float* h = s + k * kCols;
    float acc = h[upper(0, 0)];
    for (int i = 1; i < 6; ++i) acc = acc + h[upper(i, i)];
    info[k] = acc;
    info_sum = k == 0 ? acc : info_sum + acc;
  }
  const float info_den = clamp_min(info_sum, 1e-12f);
  for (int k = 0; k < K; ++k) {
    ex_vote[k] = voter[k] && !agree[k][best];
    const bool ex_err = voter[k] && (nk[k] < kErrMinorityCap * n_total) && (err_n[k] > err_thr);
    excluded[k] = (ex_vote[k] && majority_ok) || ex_err;
    info_share[k] = info[k] / info_den;
    const float pix_share = nk[k] / n_total;
    dominant[k] = voter[k] && (info_share[k] > 2.0f * clamp_min(pix_share, 1e-6f));
    others[k] = voter[k] && !excluded[k] && !dominant[k];
    minority[k] = nk[k] < kMinorityCap * n_total;
  }
  const float others_med = nanmedian(err_n, others, K);
  float hostage_sum = 0.f;
  for (int k = 0; k < K; ++k) {
    hostage[k] = dominant[k] && enough && minority[k] &&
                 (others_med > 2.0f * clamp_min(err_n[k], 1e-3f)) && (others_med > 0.35f);
    const float hf = hostage[k] ? 1.f : 0.f;
    hostage_sum = k == 0 ? hf : hostage_sum + hf;
  }
  if (hostage_sum > 0.5f)
    for (int k = 0; k < K; ++k) excluded[k] = ex_vote[k] && majority_ok;

  // decide.
  const float persist1 = static_cast<float>(p.persist - 1), persist = static_cast<float>(p.persist);
  float ex_f[kMaxK], gate[kMaxK], persistent[kMaxK], hostage_p[kMaxK];
  float frac_sum = 0.f, hp_sum = 0.f;
  for (int k = 0; k < K; ++k) {
    ex_f[k] = excluded[k] ? 1.f : 0.f;
    gate[k] = hist[k] >= persist1 ? 1.f : 0.f;
    persistent[k] = ex_f[k] * gate[k];
    hostage_p[k] = (hostage[k] ? 1.f : 0.f) * gate[k];
    const float pn = persistent[k] * nk[k];
    frac_sum = k == 0 ? pn : frac_sum + pn;
    hp_sum = k == 0 ? hostage_p[k] : hp_sum + hostage_p[k];
  }
  const float excluded_frac = frac_sum / n_total;
  const bool triggered =
      (excluded_frac > p.trigger_frac) && (excluded_frac < p.max_frac) && majority_ok;
  const bool rescue = hp_sum > 0.5f;
  const bool act = triggered || rescue;
  float member_d[kMaxK];
  float excl_sum = 0.f;
  for (int k = 0; k < K; ++k) {
    const float recent = hist[k] >= persist ? 1.f : 0.f;
    const float ex = rescue ? tmax(tmax(persistent[k], hostage_p[k]), recent) : persistent[k];
    member_d[k] = act ? 1.0f - ex : 1.f;
    const float en = ex * nk[k];
    excl_sum = k == 0 ? en : excl_sum + en;
  }
  const float frac_out = act ? excl_sum / n_total : 0.f;

  // The vote's bookkeeping (tracking/tracker.py).
  const float* member = state;
  const float* flags_any = state + K;
  const float* probe_cand = state + 3 * K;
  const float* excl_any = state + 4 * K;
  float* o = state_out;
  float ex_sum = 0.f, changed = 0.f;
  for (int k = 0; k < K; ++k) {
    const float m2 = member[k] * member_d[k];
    o[k] = m2;
    o[K + k] = tmax(flags_any[k], tmax(ex_f[k], hostage[k] ? 1.f : 0.f));
    o[2 * K + k] = nk[k];
    o[3 * K + k] = probe_cand[k];
    o[4 * K + k] = excl_any[k];
    ex_sum = k == 0 ? ex_f[k] : ex_sum + ex_f[k];
    const float ch = m2 < member[k] ? 1.f : 0.f;
    changed = k == 0 ? ch : changed + ch;
  }
  float probe_fire = state[5 * K];
  if (p.attack_probe) {
    // n_total is tot_k: the same clamped sum.
    float pool_sum = 0.f, best_d = 0.f;
    int arg = 0;
    for (int k = 0; k < K; ++k) {
      const bool pool = (nk[k] >= p.min_frac * n_total) && (ex_f[k] < 0.5f) &&
                        (nk[k] < kMinorityCap * n_total);
      const float pf = pool ? 1.f : 0.f;
      pool_sum = k == 0 ? pf : pool_sum + pf;
      const float dens = pool ? info_share[k] / clamp_min(nk[k] / n_total, 1e-6f) : -1.f;
      if (k == 0 || dens > best_d) {
        arg = k;
        best_d = dens;
      }
    }
    const bool fire = (ex_sum > 0.5f) && majority_ok && (pool_sum > 0.5f);
    for (int k = 0; k < K; ++k) {
      if (fire) o[3 * K + k] = k == arg ? 1.f : 0.f;
      o[4 * K + k] = tmax(excl_any[k], ex_f[k]);
    }
    probe_fire = tmax(probe_fire, fire ? 1.f : 0.f);
  }
  o[5 * K] = probe_fire;
  o[5 * K + 1] = tmax(state[5 * K + 1], frac_out);
  o[5 * K + 2] = tmax(state[5 * K + 2], rescue ? 1.f : 0.f);
  *go = (act && changed > 0.5f && !rescue) ? 1 : 0;

  for (int k = 0; k < K; ++k) {
    for (int i = 0; i < 6; ++i) diag[k * 6 + i] = delta[k][i];
    diag[6 * K + k] = ex_f[k];
    diag[7 * K + k] = hostage[k] ? 1.f : 0.f;
    diag[8 * K + k] = (dominant[k] && minority[k]) ? 1.f : 0.f;
    diag[9 * K + k] = info_share[k];
    diag[10 * K + k] = member_d[k];
  }
  diag[11 * K] = majority_ok ? 1.f : 0.f;
  diag[11 * K + 1] = act ? 1.f : 0.f;
  diag[11 * K + 2] = rescue ? 1.f : 0.f;
  diag[11 * K + 3] = frac_out;
}

}  // namespace

extern "C" int consensus_vote_launch(VoteParams p, const float* sums, const float* bscale,
                                     const float* hist, const float* state, float* state_out,
                                     int* go, float* diag, void* stream) {
  if (p.k < 1 || p.k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  consensus_vote_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, sums, bscale, hist, state, state_out, go, diag);
  return static_cast<int>(cudaGetLastError());
}
