// The end of one IRLS iteration for one thread: the damped 6x6 solve and
// the SE(3) pose update of ops/gauss_newton.py::ic_update,
//
//   delta = solve(H + damping I, b)    (f32 Cholesky, lower triangle)
//   ok    = n_valid > min_valid && every pivot > 0 && delta finite
//   T'    = orthonormalize(T . exp(-(ok ? delta : 0)))
//
// with exp and orthonormalize as core/se3.py writes them (Taylor branches
// below theta^2 = 1e-8; two Newton polar iterations). The IRLS kernels run
// it in one thread of their last block. The functions are host and device
// code, so the CPU tests compile this header with a C++ compiler and hold
// it to ic_update.

#pragma once

#include <math.h>

// Every loop below has a constant trip count; unrolled, the matrices stay
// in registers instead of local memory.
#ifdef __CUDACC__
#define IRLS_HD __host__ __device__ __forceinline__
#define IRLS_UNROLL _Pragma("unroll")
#else
#define IRLS_HD inline
#define IRLS_UNROLL
#endif

namespace irls {

// False for NaN and +-inf.
IRLS_HD bool is_finite(float x) { return fabsf(x) <= 3.40282347e38f; }

// Lower Cholesky factor of the symmetric 6x6 A (row-major; the lower
// triangle is read), in place. False when a pivot is not > 0, NaN
// included; the factor is then garbage and must not be used.
IRLS_HD bool cholesky6(float A[36]) {
  bool ok = true;
  IRLS_UNROLL
  for (int j = 0; j < 6; ++j) {
    float d = A[j * 6 + j];
    IRLS_UNROLL
    for (int k = 0; k < j; ++k) d -= A[j * 6 + k] * A[j * 6 + k];
    if (!(d > 0.f)) ok = false;
    const float l = sqrtf(d);
    A[j * 6 + j] = l;
    IRLS_UNROLL
    for (int i = j + 1; i < 6; ++i) {
      float s = A[i * 6 + j];
      IRLS_UNROLL
      for (int k = 0; k < j; ++k) s -= A[i * 6 + k] * A[j * 6 + k];
      A[i * 6 + j] = s / l;
    }
  }
  return ok;
}

// x = (L L^T)^-1 b for the factor of cholesky6.
IRLS_HD void cholesky6_solve(const float L[36], const float b[6], float x[6]) {
  float y[6];
  IRLS_UNROLL
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    IRLS_UNROLL
    for (int k = 0; k < i; ++k) s -= L[i * 6 + k] * y[k];
    y[i] = s / L[i * 6 + i];
  }
  IRLS_UNROLL
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    IRLS_UNROLL
    for (int k = i + 1; k < 6; ++k) s -= L[k * 6 + i] * x[k];
    x[i] = s / L[i * 6 + i];
  }
}

// C = A B for 3x3 row-major matrices.
IRLS_HD void mul3(const float A[9], const float B[9], float C[9]) {
  IRLS_UNROLL
  for (int r = 0; r < 3; ++r) {
    IRLS_UNROLL
    for (int c = 0; c < 3; ++c)
      C[r * 3 + c] = A[r * 3] * B[c] + A[r * 3 + 1] * B[3 + c] + A[r * 3 + 2] * B[6 + c];
  }
}

// se3.exp of the twist [v, w] (translation first): the 4x4 row-major E.
IRLS_HD void se3_exp(const float xi[6], float E[16]) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float W[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float W2[9];
  mul3(W, W, W2);
  const float theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = theta2 < 1e-8f;
  const float t2 = small ? 1.f : theta2;
  const float theta = sqrtf(t2);
  const float a = small ? 1.f - theta2 / 6.f : sinf(theta) / theta;
  const float b = small ? 0.5f - theta2 / 24.f : (1.f - cosf(theta)) / t2;
  const float c = small ? 1.f / 6.f - theta2 / 120.f : (theta - sinf(theta)) / (t2 * theta);
  float V[9];
  IRLS_UNROLL
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.f : 0.f;
    E[(k / 3) * 4 + k % 3] = eye + a * W[k] + b * W2[k];
    V[k] = eye + b * W[k] + c * W2[k];
  }
  IRLS_UNROLL
  for (int r = 0; r < 3; ++r)
    E[r * 4 + 3] = V[r * 3] * xi[0] + V[r * 3 + 1] * xi[1] + V[r * 3 + 2] * xi[2];
  E[12] = 0.f;
  E[13] = 0.f;
  E[14] = 0.f;
  E[15] = 1.f;
}

// se3.orthonormalize with two Newton polar iterations,
// R <- R (1.5 I - 0.5 R^T R); the translation is kept and the last row
// set to [0, 0, 0, 1].
IRLS_HD void orthonormalize(const float M[16], float out[16]) {
  float R[9], RtR[9], S[9], Rn[9];
  IRLS_UNROLL
  for (int k = 0; k < 9; ++k) R[k] = M[(k / 3) * 4 + k % 3];
  IRLS_UNROLL
  for (int it = 0; it < 2; ++it) {
    IRLS_UNROLL
    for (int r = 0; r < 3; ++r) {
      IRLS_UNROLL
      for (int c = 0; c < 3; ++c)
        RtR[r * 3 + c] = R[r] * R[c] + R[3 + r] * R[3 + c] + R[6 + r] * R[6 + c];
    }
    IRLS_UNROLL
    for (int k = 0; k < 9; ++k) S[k] = ((k % 4 == 0) ? 1.5f : 0.f) - 0.5f * RtR[k];
    mul3(R, S, Rn);
    IRLS_UNROLL
    for (int k = 0; k < 9; ++k) R[k] = Rn[k];
  }
  IRLS_UNROLL
  for (int k = 0; k < 9; ++k) out[(k / 3) * 4 + k % 3] = R[k];
  IRLS_UNROLL
  for (int r = 0; r < 3; ++r) out[r * 4 + 3] = M[r * 4 + 3];
  out[12] = 0.f;
  out[13] = 0.f;
  out[14] = 0.f;
  out[15] = 1.f;
}

// ic_update: H (6x6 row-major, symmetric), b (6), T (4x4 row-major) in;
// T_out and the applied delta out (zero when the update is suppressed).
// min_valid is ic_update's: the fused kernels keep its 100; -inf leaves
// the decision to the factorization and finiteness alone (the IC SPMD
// tracker's rule, parallel/spmd.py).
IRLS_HD void solve_update(const float H[36], const float b[6], float damping, float n_valid,
                          const float T[16], float T_out[16], float delta[6],
                          float min_valid = 100.f) {
  float L[36];
  IRLS_UNROLL
  for (int k = 0; k < 36; ++k) L[k] = H[k] + ((k % 7 == 0) ? damping : 0.f);
  const bool factored = cholesky6(L);
  float x[6];
  cholesky6_solve(L, b, x);
  bool ok = n_valid > min_valid && factored;
  IRLS_UNROLL
  for (int k = 0; k < 6; ++k) ok = ok && is_finite(x[k]);
  float neg[6];
  IRLS_UNROLL
  for (int k = 0; k < 6; ++k) {
    delta[k] = ok ? x[k] : 0.f;
    neg[k] = -delta[k];
  }
  float E[16], M[16];
  se3_exp(neg, E);
  IRLS_UNROLL
  for (int r = 0; r < 4; ++r) {
    IRLS_UNROLL
    for (int c = 0; c < 4; ++c)
      M[r * 4 + c] = T[r * 4] * E[c] + T[r * 4 + 1] * E[4 + c] + T[r * 4 + 2] * E[8 + c] +
                     T[r * 4 + 3] * E[12 + c];
  }
  orthonormalize(M, T_out);
}

}  // namespace irls
