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
// Design: K <= 16, so the work is small and latency bounds it: the chain
// of JACOBI_SWEEPS x 5 rounds of dependent float64 divides and square
// roots of each stratum's 6x6 eigensolve is the floor of any design that
// keeps the plain version's bits. One block of 128 threads, three block
// barriers (after the load, after the eigensolves, after the flow metric).
// 1. Eigensolve: a group of 8 lanes a stratum, four strata a warp; lane i
//    holds row i of A and of the eigenvectors V in registers (lanes 6 and
//    7 idle). The rounds are unrolled from the template arguments, so
//    every column index and partner is a constant. In a round lanes 0-2
//    each compute one pair's rotation from pivots fetched by shuffle and
//    hand (c, s) to the group; each lane turns the columns of its rows in
//    registers and takes its partner row by shuffle for the row turn. No
//    barrier and no shared memory inside the sweeps. The truncated solve
//    follows inside the group, by shuffles.
// 2. Flow metric: one (j, k) stratum pair a thread, 16 pairs a row, so a
//    warp's ballot holds two rows of the agreement matrix as bitmasks.
// 3. The vote's tail in the last warp, lane k holding stratum k: what
//    needs no agreement (the sums, the error median, the information
//    shares, the state) while the other warps solve, the rest after the
//    flow metric. Every sum over the strata gathers the K values by
//    shuffle and adds them in stratum order, the medians select by rank
//    (the stable sort's order, signed zeros included), the argmaxes keep
//    torch.argmax's first index (a NaN beats any number).
// On an H100 80GB HBM3 at 700 W (tools/irls_variants.py --vote) this takes
// 28.2 us a launch at the VGA L2 vote (K 6): 23.4 in the eigensolve (0.47
// a round), 1.7 in the tail. PR 13's design (36 threads a stratum in shared memory,
// three block barriers a round, thread 0 alone for the tail with its
// arrays in local memory) took 67.5 us, 57 of them in the eigensolve and 8
// in the tail; a lane a column with every lane computing all three
// rotations, 70 us (the three chains run one after another in a lane).
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
constexpr int kThreads = 128;  // 4 warps: 16 eigensolve groups, 8 rows of pairs a pass
constexpr int kGroup = 8;      // lanes a stratum in the eigensolve
// The warp of the vote's tail: the last, which has no eigensolve at K <= 12.
constexpr int kTailWarp = kThreads / 32 - 1;
constexpr int kSweeps = 10;    // consensus.py JACOBI_SWEEPS
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMinorityCap = 0.35f;
constexpr float kErrMinorityCap = 0.40f;

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

// The rotation (c, s) of one pair from A[P][P], A[Q][Q], A[P][Q]: the
// expressions of consensus.py::jacobi_eigh. Where A[P][Q] is 0, jacobi_eigh
// sets t = 0, so c = 1 / sqrt(0 * 0 + 1) = 1 and s = 0 * c = +0 exactly:
// the chain is skipped there (its divides by 0 take the slow path).
__device__ __forceinline__ void rotation(double app, double aqq, double apq, double& c,
                                         double& s) {
  c = 1.0;
  s = 0.0;
  if (apq == 0.0) return;
  const double theta = (aqq - app) / (2.0 * apq);
  const double sgn = theta >= 0.0 ? 1.0 : -1.0;
  const double tt = sgn / (fabs(theta) + sqrt(theta * theta + 1.0));
  c = 1.0 / sqrt(tt * tt + 1.0);
  s = tt * c;
}

// One round of consensus.py::JACOBI_ROUNDS, the pairs (P0, Q0), (P1, Q1),
// (P2, Q2), on the group's matrix: lane i holds row i of A (a[j] =
// A[i][j]) and of V. Lane q < 3 computes pair q's rotation (the pivots
// fetched by shuffle: each lane offers A[i][i] and A[i][partner i]) and
// hands (c, s) to the group. As in jacobi_eigh, the rotations turn the
// columns of A, then its rows, then the columns of V: a'[i][r] = a[i][r]
// c_r + a[i][partner r] (sign_r s_r), sign -1 for P and +1 for Q. The
// column turns are this lane's own row; the row turn takes the partner row
// by shuffle. A group past K (``live`` false) turns nothing.
template <int P0, int Q0, int P1, int Q1, int P2, int Q2>
__device__ __forceinline__ void jacobi_round(double (&a)[6], double (&v)[6], int i, bool live) {
  constexpr int P[3] = {P0, P1, P2}, Q[3] = {Q0, Q1, Q2};
  int pt[6];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    pt[P[x]] = Q[x];
    pt[Q[x]] = P[x];
  }
  double diag = a[0], off = a[pt[0]];
  int p = P[0], q = Q[0];
#pragma unroll
  for (int x = 1; x < 6; ++x) {
    if (i == x) {
      diag = a[x];
      off = a[pt[x]];
    }
  }
#pragma unroll
  for (int x = 1; x < 3; ++x) {
    if (i == x) {
      p = P[x];
      q = Q[x];
    }
  }
  const double app = __shfl_sync(kFull, diag, p, kGroup);
  const double aqq = __shfl_sync(kFull, diag, q, kGroup);
  const double apq = __shfl_sync(kFull, off, p, kGroup);
  double c = 1.0, s = 0.0;
  if (live && i < 3) rotation(app, aqq, apq, c, s);
  double cv[6], sv[6];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    const double cx = __shfl_sync(kFull, c, x, kGroup), sx = __shfl_sync(kFull, s, x, kGroup);
    cv[P[x]] = cx;
    cv[Q[x]] = cx;
    sv[P[x]] = sx * -1.0;
    sv[Q[x]] = sx * 1.0;
  }
  double t[6], w[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    t[j] = a[j] * cv[j] + a[pt[j]] * sv[j];
    w[j] = v[j] * cv[j] + v[pt[j]] * sv[j];
  }
  double ci = 1.0, si = 0.0;
  int pi = i;
#pragma unroll
  for (int x = 0; x < 6; ++x) {
    if (i == x) {
      ci = cv[x];
      si = sv[x];
      pi = pt[x];
    }
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const double tp = __shfl_sync(kFull, t[j], pi, kGroup);
    a[j] = t[j] * ci + tp * si;
    v[j] = w[j];
  }
}

// Every stratum's correction: the Jacobi eigensolve of Hn (float64) and
// the truncated-eigenspace solve, by groups of 8 lanes, four strata a warp
// (see the design note). Called by every thread of the block; warps with
// no stratum return at once, and every lane of a warp that has one takes
// part in each shuffle (the groups past K and the lanes 6, 7 compute on
// zeros and store nothing). Writes delta (shared) and the diag's deltas.
__device__ void strata_deltas(const float* __restrict__ s, int K, float (*delta)[6],
                              float* __restrict__ diag) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp * (32 / kGroup) >= K) return;
  const int k = warp * (32 / kGroup) + lane / kGroup, i = lane % kGroup;
  const bool live = k < K, active = live && i < 6;
  const float* h = s + (live ? k : 0) * kCols;
  const float inv_n = 1.0f / clamp_min(h[27], 1.f);
  double a[6], v[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    a[j] = active ? static_cast<double>(h[upper(i, j)] * inv_n) : 0.0;
    v[j] = i == j ? 1.0 : 0.0;
  }
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    jacobi_round<0, 1, 2, 3, 4, 5>(a, v, i, live);
    jacobi_round<0, 2, 1, 4, 3, 5>(a, v, i, live);
    jacobi_round<0, 4, 2, 5, 1, 3>(a, v, i, live);
    jacobi_round<0, 5, 4, 3, 2, 1>(a, v, i, live);
    jacobi_round<0, 3, 5, 1, 4, 2>(a, v, i, live);
  }
  // The truncated solve in analyze's order: emax over the eigenvalues in
  // index order; lane e's inverse eigenvalue; proj[e] = sum over l in
  // order of V[l][e] b[l], gathered from the rows' lanes; then this
  // lane's delta[i] = sum over j in order of V[i][j] (inv[j] proj[j]).
  double dg[6];
#pragma unroll
  for (int x = 0; x < 6; ++x) dg[x] = __shfl_sync(kFull, a[x], x, kGroup);
  double emax = dg[0], ev = dg[0];
#pragma unroll
  for (int x = 1; x < 6; ++x) {
    emax = tmax(emax, dg[x]);
    if (i == x) ev = dg[x];
  }
  const double inv_own = ev > 0.01 * emax ? 1.0 / clamp_min(ev, 1e-12) : 0.0;
  const double b_own = active ? static_cast<double>(h[21 + i] * inv_n) : 0.0;
  double proj[6];
#pragma unroll
  for (int l = 0; l < 6; ++l) {
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const double x = __shfl_sync(kFull, v[e] * b_own, l, kGroup);
      proj[e] = l == 0 ? x : proj[e] + x;
    }
  }
  double d = 0.0;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const double wj = __shfl_sync(kFull, inv_own, j, kGroup) * proj[j];
    d = j == 0 ? v[0] * wj : d + v[j] * wj;
  }
  if (active) {
    const float f = static_cast<float>(d);
    delta[k][i] = isfinite(f) ? f : 0.f;
    diag[k * 6 + i] = delta[k][i];
  }
}

// The agreement matrix in the induced-flow metric: bit k of rows[j] is
// agree[j][k], m[j][k] = (d_j - d_k)^T (G_j / n_j) (d_j - d_k) <= tol_eff^2,
// in analyze's order. Thread t takes the pair (row0 + t / 16, t % 16), so
// a warp's ballot holds two rows.
__device__ void agreement(const float* __restrict__ s, const float (*delta)[6], int K,
                          float tol_eff, unsigned* rows) {
  const int lane = threadIdx.x % 32;
  for (int row0 = 0; row0 < K; row0 += kThreads / kMaxK) {
    const int j = row0 + threadIdx.x / kMaxK, k = threadIdx.x % kMaxK;
    bool agree = false;
    if (j < K && k < K) {
      const float* g = s + j * kCols + 29;
      const float inv_n = 1.0f / clamp_min(s[j * kCols + 27], 1.f);
      float diff[6];
#pragma unroll
      for (int l = 0; l < 6; ++l) diff[l] = delta[j][l] - delta[k][l];
      float m = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float ti = (g[upper(i, 0)] * inv_n) * diff[0];
#pragma unroll
        for (int l = 1; l < 6; ++l) ti = ti + (g[upper(i, l)] * inv_n) * diff[l];
        m = i == 0 ? diff[0] * ti : m + diff[i] * ti;
      }
      agree = m <= tol_eff * tol_eff;
    }
    const unsigned bits = __ballot_sync(kFull, agree);
    const int r = row0 + 2 * (threadIdx.x / 32);
    if (lane == 0 && r < kMaxK) {
      rows[r] = bits & 0xffffu;
      rows[r + 1] = bits >> 16;
    }
  }
}

// The tail warp's helpers: lane k < K holds stratum k's value, and
// every lane gets the result.

// consensus.py::_seqsum: x_0, then + x_1, ..., + x_{K-1}.
__device__ __forceinline__ float seqsum(float x, int K) {
  float acc = __shfl_sync(kFull, x, 0);
#pragma unroll
  for (int q = 1; q < kMaxK; ++q) {
    const float y = __shfl_sync(kFull, x, q);
    if (q < K) acc = acc + y;
  }
  return acc;
}

// torch.argmax over x_0..x_{K-1}: the first NaN if there is one, else the
// first of the largest values.
__device__ __forceinline__ int argmax_first(float x, int K, float& best_v) {
  int best = 0;
  best_v = __shfl_sync(kFull, x, 0);
#pragma unroll
  for (int q = 1; q < kMaxK; ++q) {
    const float y = __shfl_sync(kFull, x, q);
    if (q < K && (y > best_v || (y != y && best_v == best_v))) {
      best = q;
      best_v = y;
    }
  }
  return best;
}

// consensus.py::nanmedian of the lanes' x where ``use`` is set and x is
// not NaN: the mean of the values at ranks (c - 1) / 2 and c / 2 of the
// ascending order, the others counting as +inf; 0 when there is none or
// the median is not finite. A lane's rank is the number of smaller values
// plus the number of equal ones at lower lanes: the stable sort's order,
// so the same elements as torch.sort's (signed zeros compare equal).
__device__ __forceinline__ float nanmedian(float x, bool use, int K, int lane) {
  const bool ok = use && !(x != x);
  const float u = ok ? x : INFINITY;
  const int c = __popc(__ballot_sync(kFull, ok));
  int rank = 0;
#pragma unroll
  for (int q = 0; q < kMaxK; ++q) {
    const float y = __shfl_sync(kFull, u, q);
    if (q < K && (y < u || (y == u && q < lane))) ++rank;
  }
  int lo = (c - 1) / 2, hi = c / 2;
  lo = lo < 0 ? 0 : (lo > K - 1 ? K - 1 : lo);
  hi = hi < 0 ? 0 : (hi > K - 1 ? K - 1 : hi);
  const int at_lo = __ffs(__ballot_sync(kFull, lane < K && rank == lo)) - 1;
  const int at_hi = __ffs(__ballot_sync(kFull, lane < K && rank == hi)) - 1;
  const float med = (__shfl_sync(kFull, u, at_lo) + __shfl_sync(kFull, u, at_hi)) / 2.0f;
  return (c > 0 && isfinite(med)) ? med : 0.f;
}

// Whether any lane < K has ``b`` set: a _seqsum of 0/1 flags > 0.5.
__device__ __forceinline__ bool any_lane(bool b, int K, int lane) {
  return __ballot_sync(kFull, b && lane < K) != 0u;
}

// Stratum ``lane``'s part of the vote that needs no agreement, and the
// state it will update: the tail warp computes it while the other warps
// solve. Lane k holds stratum k; the lanes past K hold zeros and count in
// no sum, rank or flag.
struct Strata {
  bool valid, voter, dominant, minority;
  int n_voters;
  float nk, n_total, err_n, err_thr, info_share;
  float hist, member, flags_any, probe_cand, excl_any, probe_fire, frac_any, rescue_any;
};

__device__ __forceinline__ Strata strata_prefix(const float* __restrict__ s, const VoteParams& p,
                                                float bscale, const float* __restrict__ hist,
                                                const float* __restrict__ state, int lane) {
  const int K = p.k;
  Strata a;
  a.valid = lane < K;
  const float* h = s + (a.valid ? lane : 0) * kCols;
  a.nk = a.valid ? h[27] : 0.f;
  const float inv_n = 1.0f / clamp_min(a.nk, 1.f);
  a.n_total = clamp_min(seqsum(a.nk, K), 1.f);
  a.voter = a.valid && a.nk >= p.min_frac * a.n_total;
  a.n_voters = __popc(__ballot_sync(kFull, a.voter));
  a.err_n = h[28] * inv_n;
  const float err_med = nanmedian(a.err_n, a.voter, K, lane);
  a.err_thr = clamp_min(p.err_ratio * err_med * bscale, p.err_floor);
  float info = h[upper(0, 0)];
#pragma unroll
  for (int i = 1; i < 6; ++i) info = info + h[upper(i, i)];
  a.info_share = info / clamp_min(seqsum(info, K), 1e-12f);
  const float pix_share = a.nk / a.n_total;
  a.dominant = a.voter && (a.info_share > 2.0f * clamp_min(pix_share, 1e-6f));
  a.minority = a.nk < kMinorityCap * a.n_total;
  a.hist = a.valid ? hist[lane] : 0.f;
  a.member = a.valid ? state[lane] : 0.f;
  a.flags_any = a.valid ? state[K + lane] : 0.f;
  a.probe_cand = a.valid ? state[3 * K + lane] : 0.f;
  a.excl_any = a.valid ? state[4 * K + lane] : 0.f;
  a.probe_fire = state[5 * K];
  a.frac_any = state[5 * K + 1];
  a.rescue_any = state[5 * K + 2];
  return a;
}

// The rest of analyze (the vote, the error outliers, the hostage), decide
// and the vote's bookkeeping (tracking/tracker.py), from the agreement
// rows; writes the new state, the rerun word and the diagnostics.
__device__ __forceinline__ void vote_finish(const Strata& a, const unsigned* rows,
                                            const VoteParams& p, float* __restrict__ o,
                                            int* __restrict__ go, float* __restrict__ diag,
                                            int lane) {
  const int K = p.k;
  // Support of hypothesis ``lane``: the sum over j in order of
  // agree[j][lane] x (n_j x voter_j).
  const float wv = a.nk * (a.voter ? 1.f : 0.f);
  float sup = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxK; ++q) {
    const float wq = __shfl_sync(kFull, wv, q);
    if (q < K) {
      const float term = (((rows[q] >> lane) & 1u) ? 1.f : 0.f) * wq;
      sup = q == 0 ? term : sup + term;
    }
  }
  sup = a.voter ? sup : -1.f;
  float best_v;
  const int best = argmax_first(sup, K, best_v);
  const bool enough = a.n_voters >= 3;
  const bool majority_ok = (best_v > 0.6f * a.n_total) && enough;
  const unsigned row = a.valid ? rows[lane] : 0u;
  const bool ex_vote = a.voter && !((row >> best) & 1u);
  const bool ex_err = a.voter && (a.nk < kErrMinorityCap * a.n_total) && (a.err_n > a.err_thr);
  bool excluded = (ex_vote && majority_ok) || ex_err;
  const bool others = a.voter && !excluded && !a.dominant;
  const float others_med = nanmedian(a.err_n, others, K, lane);
  const bool hostage = a.dominant && enough && a.minority &&
                       (others_med > 2.0f * clamp_min(a.err_n, 1e-3f)) && (others_med > 0.35f);
  if (any_lane(hostage, K, lane)) excluded = ex_vote && majority_ok;

  // decide.
  const float persist1 = static_cast<float>(p.persist - 1), persist = static_cast<float>(p.persist);
  const float ex_f = excluded ? 1.f : 0.f;
  const float hostage_f = hostage ? 1.f : 0.f;
  const float gate = a.hist >= persist1 ? 1.f : 0.f;
  const float persistent = ex_f * gate;
  const float hostage_p = hostage_f * gate;
  const float excluded_frac = seqsum(persistent * a.nk, K) / a.n_total;
  const bool triggered =
      (excluded_frac > p.trigger_frac) && (excluded_frac < p.max_frac) && majority_ok;
  const bool rescue = any_lane(hostage_p > 0.5f, K, lane);
  const bool act = triggered || rescue;
  const float recent = a.hist >= persist ? 1.f : 0.f;
  const float ex = rescue ? tmax(tmax(persistent, hostage_p), recent) : persistent;
  const float member_d = act ? 1.0f - ex : 1.f;
  const float excl_sum = seqsum(ex * a.nk, K);
  const float frac_out = act ? excl_sum / a.n_total : 0.f;

  // The bookkeeping. n_total is the attack probe's tot_k: the same
  // clamped sum.
  const float m2 = a.member * member_d;
  float probe_cand = a.probe_cand, excl_any = a.excl_any, probe_fire = a.probe_fire;
  if (p.attack_probe) {
    const bool pool = a.voter && (ex_f < 0.5f) && (a.nk < kMinorityCap * a.n_total);
    const float dens = pool ? a.info_share / clamp_min(a.nk / a.n_total, 1e-6f) : -1.f;
    float best_d;
    const int arg = argmax_first(dens, K, best_d);
    const bool fire = any_lane(excluded, K, lane) && majority_ok && any_lane(pool, K, lane);
    if (fire) probe_cand = lane == arg ? 1.f : 0.f;
    excl_any = tmax(excl_any, ex_f);
    probe_fire = tmax(probe_fire, fire ? 1.f : 0.f);
  }
  const bool changed = any_lane(m2 < a.member, K, lane);
  if (a.valid) {
    o[lane] = m2;
    o[K + lane] = tmax(a.flags_any, tmax(ex_f, hostage_f));
    o[2 * K + lane] = a.nk;
    o[3 * K + lane] = probe_cand;
    o[4 * K + lane] = excl_any;
    diag[6 * K + lane] = ex_f;
    diag[7 * K + lane] = hostage_f;
    diag[8 * K + lane] = (a.dominant && a.minority) ? 1.f : 0.f;
    diag[9 * K + lane] = a.info_share;
    diag[10 * K + lane] = member_d;
  }
  if (lane == 0) {
    o[5 * K] = probe_fire;
    o[5 * K + 1] = tmax(a.frac_any, frac_out);
    o[5 * K + 2] = tmax(a.rescue_any, rescue ? 1.f : 0.f);
    *go = (act && changed && !rescue) ? 1 : 0;
    diag[11 * K] = majority_ok ? 1.f : 0.f;
    diag[11 * K + 1] = act ? 1.f : 0.f;
    diag[11 * K + 2] = rescue ? 1.f : 0.f;
    diag[11 * K + 3] = frac_out;
  }
}

__global__ void __launch_bounds__(kThreads)
consensus_vote_kernel(VoteParams p, const float* __restrict__ sums,
                      const float* __restrict__ bscale_p, const float* __restrict__ hist,
                      const float* __restrict__ state, float* __restrict__ state_out,
                      int* __restrict__ go, float* __restrict__ diag) {
  const int K = p.k;
  __shared__ float s[kMaxK * kCols];
  __shared__ float delta[kMaxK][6];
  __shared__ unsigned rows[kMaxK];
  for (int i = threadIdx.x; i < K * kCols; i += kThreads) s[i] = sums[i];
  const float bscale = *bscale_p;
  const bool tail = threadIdx.x / 32 == kTailWarp;
  const int lane = threadIdx.x % 32;
  __syncthreads();
  strata_deltas(s, K, delta, diag);
  Strata a;
  if (tail) a = strata_prefix(s, p, bscale, hist, state, lane);
  __syncthreads();
  agreement(s, delta, K, p.tol * bscale, rows);
  __syncthreads();
  if (tail) vote_finish(a, rows, p, state_out, go, diag, lane);
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
