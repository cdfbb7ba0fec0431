// Native pose-graph assembly kernels (C ABI, loaded via ctypes).
// The port's copy of rgbid_tpu/native/pose_graph.cpp, built by
// rgbid_tpu_torch/native/__init__.py into build/rgbid_tpu_torch/.
//
// TPU-native rebuild of the reference's host C++ pose-graph optimizer
// (SURVEY.md §2.1 "Pose-graph optimizer": Eigen-based GN on SE(3)).
// Division of labor with Python: this file does the O(E) per-edge work —
// SE(3) residuals, numeric Jacobians, robust weighting, and accumulation
// of the dense 6Nx6N normal system — which dominates a Python
// implementation; the single big Cholesky solve stays in numpy/LAPACK,
// which is already optimal.
//
// Conventions match rgbid_tpu.backend.pose_graph exactly (tested for
// equivalence): poses/edge transforms are row-major 4x4 double; twist =
// [v, w]; edge residual r = log(inv(T_to) @ T_from @ T_rel); updates are
// right-multiplied twists.

#include <cmath>
#include <cstring>

namespace {

struct Mat4 {
  double m[16];
  double& at(int r, int c) { return m[r * 4 + c]; }
  double at(int r, int c) const { return m[r * 4 + c]; }
};

Mat4 identity() {
  Mat4 T{};
  T.at(0, 0) = T.at(1, 1) = T.at(2, 2) = T.at(3, 3) = 1.0;
  return T;
}

Mat4 mul(const Mat4& a, const Mat4& b) {
  Mat4 out{};
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) {
      double s = 0;
      for (int k = 0; k < 4; ++k) s += a.at(r, k) * b.at(k, c);
      out.at(r, c) = s;
    }
  return out;
}

Mat4 rigid_inverse(const Mat4& T) {
  Mat4 out = identity();
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) out.at(r, c) = T.at(c, r);
  for (int r = 0; r < 3; ++r) {
    double s = 0;
    for (int c = 0; c < 3; ++c) s += out.at(r, c) * T.at(c, 3);
    out.at(r, 3) = -s;
  }
  return out;
}

void hat3(const double w[3], double W[9]) {
  W[0] = 0;     W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0;     W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0;
}

void mat3_mul(const double a[9], const double b[9], double out[9]) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += a[r * 3 + k] * b[k * 3 + c];
      out[r * 3 + c] = s;
    }
}

Mat4 se3_exp(const double d[6]) {
  const double* v = d;
  const double* w = d + 3;
  double theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  double theta = std::sqrt(theta2);
  double W[9], W2[9];
  hat3(w, W);
  mat3_mul(W, W, W2);
  double a, b, c;
  if (theta < 1e-9) {
    a = 1.0 - theta2 / 6.0;
    b = 0.5 - theta2 / 24.0;
    c = 1.0 / 6.0 - theta2 / 120.0;
  } else {
    a = std::sin(theta) / theta;
    b = (1.0 - std::cos(theta)) / theta2;
    c = (theta - std::sin(theta)) / (theta2 * theta);
  }
  Mat4 T = identity();
  for (int r = 0; r < 3; ++r)
    for (int col = 0; col < 3; ++col) {
      double eye = (r == col) ? 1.0 : 0.0;
      T.at(r, col) = eye + a * W[r * 3 + col] + b * W2[r * 3 + col];
    }
  for (int r = 0; r < 3; ++r) {
    double V_row[3];
    for (int col = 0; col < 3; ++col) {
      double eye = (r == col) ? 1.0 : 0.0;
      V_row[col] = eye + b * W[r * 3 + col] + c * W2[r * 3 + col];
    }
    T.at(r, 3) = V_row[0] * v[0] + V_row[1] * v[1] + V_row[2] * v[2];
  }
  return T;
}

void se3_log(const Mat4& T, double out[6]) {
  double tr = T.at(0, 0) + T.at(1, 1) + T.at(2, 2);
  double cos_theta = (tr - 1.0) * 0.5;
  if (cos_theta > 1.0) cos_theta = 1.0;
  if (cos_theta < -1.0) cos_theta = -1.0;
  double theta = std::acos(cos_theta);
  double w[3] = {T.at(2, 1) - T.at(1, 2), T.at(0, 2) - T.at(2, 0),
                 T.at(1, 0) - T.at(0, 1)};
  double k;
  double Vinv[9];
  if (theta < 1e-9) {
    k = 0.5;
    double W[9];
    double wv[3] = {k * w[0], k * w[1], k * w[2]};
    hat3(wv, W);
    for (int i = 0; i < 9; ++i) Vinv[i] = -0.5 * W[i];
    Vinv[0] += 1.0; Vinv[4] += 1.0; Vinv[8] += 1.0;
    out[3] = wv[0]; out[4] = wv[1]; out[5] = wv[2];
  } else {
    k = theta / (2.0 * std::sin(theta));
    double wv[3] = {k * w[0], k * w[1], k * w[2]};
    double W[9], W2[9];
    hat3(wv, W);
    mat3_mul(W, W, W2);
    double coef =
        1.0 / (theta * theta) -
        (1.0 + std::cos(theta)) / (2.0 * theta * std::sin(theta));
    for (int i = 0; i < 9; ++i) Vinv[i] = -0.5 * W[i] + coef * W2[i];
    Vinv[0] += 1.0; Vinv[4] += 1.0; Vinv[8] += 1.0;
    out[3] = wv[0]; out[4] = wv[1]; out[5] = wv[2];
  }
  for (int r = 0; r < 3; ++r)
    out[r] = Vinv[r * 3 + 0] * T.at(0, 3) + Vinv[r * 3 + 1] * T.at(1, 3) +
             Vinv[r * 3 + 2] * T.at(2, 3);
}

void edge_residual(const Mat4& Tf, const Mat4& Tt, const Mat4& Trel,
                   double r[6]) {
  se3_log(mul(mul(rigid_inverse(Tt), Tf), Trel), r);
}

}  // namespace

extern "C" {

// Accumulate the dense normal system H (6N x 6N row-major) and b (6N) for
// one GN iteration, plus the robust total error. H/b must be zeroed by the
// caller. Returns the total (robust-weighted) error.
double pg_build_system(const double* poses,   // N*16
                       int n_nodes,
                       const int* e_from, const int* e_to,
                       const double* e_T,     // E*16
                       const double* e_info,  // E*36
                       const unsigned char* e_robust,
                       int n_edges, double huber_delta,
                       double* H, double* b) {
  const double eps = 1e-6;
  double total = 0.0;
  const int dim = 6 * n_nodes;
  for (int e = 0; e < n_edges; ++e) {
    Mat4 Tf, Tt, Trel;
    std::memcpy(Tf.m, poses + 16 * e_from[e], sizeof(Tf.m));
    std::memcpy(Tt.m, poses + 16 * e_to[e], sizeof(Tt.m));
    std::memcpy(Trel.m, e_T + 16 * e, sizeof(Trel.m));

    double r[6];
    edge_residual(Tf, Tt, Trel, r);

    const double* info_in = e_info + 36 * e;
    double info[36];
    std::memcpy(info, info_in, sizeof(info));
    // Mahalanobis norm for the error accumulation; the Huber weight uses
    // the METRIC residual norm (huber_delta's scale, 0.1 ~= 100 mm) —
    // production informations are H*n_valid (~1e9), so a Mahalanobis-
    // normed Huber annihilated every loop edge bridging a real
    // inconsistency (see pose_graph.py).
    double m2 = 0;
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j) m2 += r[i] * info[i * 6 + j] * r[j];
    if (m2 < 0) m2 = 0;
    if (e_robust[e]) {
      double mr2 = 0;
      for (int i = 0; i < 6; ++i) mr2 += r[i] * r[i];
      double m = std::sqrt(mr2 > 1e-18 ? mr2 : 1e-18);
      double wgt = (m <= huber_delta) ? 1.0 : huber_delta / m;
      for (int i = 0; i < 36; ++i) info[i] *= wgt;
      total += m2 * wgt;
    } else {
      total += m2;
    }

    // Numeric central-difference Jacobians wrt right-perturbations.
    double Jf[36], Jt[36];
    for (int k = 0; k < 6; ++k) {
      double d[6] = {0, 0, 0, 0, 0, 0};
      d[k] = eps;
      Mat4 Ep = se3_exp(d);
      d[k] = -eps;
      Mat4 Em = se3_exp(d);
      double rp[6], rm[6];
      edge_residual(mul(Tf, Ep), Tt, Trel, rp);
      edge_residual(mul(Tf, Em), Tt, Trel, rm);
      for (int i = 0; i < 6; ++i) Jf[i * 6 + k] = (rp[i] - rm[i]) / (2 * eps);
      edge_residual(Tf, mul(Tt, Ep), Trel, rp);
      edge_residual(Tf, mul(Tt, Em), Trel, rm);
      for (int i = 0; i < 6; ++i) Jt[i * 6 + k] = (rp[i] - rm[i]) / (2 * eps);
    }

    // info*J and info*r (6x6 / 6)
    double IJf[36], IJt[36], Ir[6];
    for (int i = 0; i < 6; ++i) {
      Ir[i] = 0;
      for (int j = 0; j < 6; ++j) Ir[i] += info[i * 6 + j] * r[j];
      for (int k = 0; k < 6; ++k) {
        double sf = 0, st = 0;
        for (int j = 0; j < 6; ++j) {
          sf += info[i * 6 + j] * Jf[j * 6 + k];
          st += info[i * 6 + j] * Jt[j * 6 + k];
        }
        IJf[i * 6 + k] = sf;
        IJt[i * 6 + k] = st;
      }
    }

    const int f = 6 * e_from[e], t = 6 * e_to[e];
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j) {
        double hf = 0, ht = 0, hft = 0, htf = 0;
        for (int k = 0; k < 6; ++k) {
          hf += Jf[k * 6 + i] * IJf[k * 6 + j];
          ht += Jt[k * 6 + i] * IJt[k * 6 + j];
          hft += Jf[k * 6 + i] * IJt[k * 6 + j];
          htf += Jt[k * 6 + i] * IJf[k * 6 + j];
        }
        H[(f + i) * dim + (f + j)] += hf;
        H[(t + i) * dim + (t + j)] += ht;
        H[(f + i) * dim + (t + j)] += hft;
        H[(t + i) * dim + (f + j)] += htf;
      }
    for (int i = 0; i < 6; ++i) {
      double bf = 0, bt = 0;
      for (int k = 0; k < 6; ++k) {
        bf += Jf[k * 6 + i] * Ir[k];
        bt += Jt[k * 6 + i] * Ir[k];
      }
      b[f + i] += bf;
      b[t + i] += bt;
    }
  }
  return total;
}

// Total (non-robust-weighted raw) graph error; used for convergence checks.
double pg_total_error(const double* poses, int n_nodes, const int* e_from,
                      const int* e_to, const double* e_T,
                      const double* e_info, int n_edges) {
  double total = 0;
  (void)n_nodes;
  for (int e = 0; e < n_edges; ++e) {
    Mat4 Tf, Tt, Trel;
    std::memcpy(Tf.m, poses + 16 * e_from[e], sizeof(Tf.m));
    std::memcpy(Tt.m, poses + 16 * e_to[e], sizeof(Tt.m));
    std::memcpy(Trel.m, e_T + 16 * e, sizeof(Trel.m));
    double r[6];
    edge_residual(Tf, Tt, Trel, r);
    const double* info = e_info + 36 * e;
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j) total += r[i] * info[i * 6 + j] * r[j];
  }
  return total;
}

// Apply right-multiplied twist updates: poses[i] <- poses[i] @ exp(delta_i),
// skipping fixed nodes, with SO(3) re-orthonormalization (Gram-Schmidt).
void pg_apply_updates(double* poses, int n_nodes, const double* delta,
                      const unsigned char* fixed) {
  for (int i = 0; i < n_nodes; ++i) {
    if (fixed[i]) continue;
    Mat4 T;
    std::memcpy(T.m, poses + 16 * i, sizeof(T.m));
    Mat4 out = mul(T, se3_exp(delta + 6 * i));
    // Gram-Schmidt on the rotation columns.
    double c0[3] = {out.at(0, 0), out.at(1, 0), out.at(2, 0)};
    double n0 = std::sqrt(c0[0] * c0[0] + c0[1] * c0[1] + c0[2] * c0[2]);
    for (double& x : c0) x /= n0;
    double c1[3] = {out.at(0, 1), out.at(1, 1), out.at(2, 1)};
    double d01 = c0[0] * c1[0] + c0[1] * c1[1] + c0[2] * c1[2];
    for (int k = 0; k < 3; ++k) c1[k] -= d01 * c0[k];
    double n1 = std::sqrt(c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2]);
    for (double& x : c1) x /= n1;
    double c2[3] = {c0[1] * c1[2] - c0[2] * c1[1],
                    c0[2] * c1[0] - c0[0] * c1[2],
                    c0[0] * c1[1] - c0[1] * c1[0]};
    for (int k = 0; k < 3; ++k) {
      out.at(k, 0) = c0[k];
      out.at(k, 1) = c1[k];
      out.at(k, 2) = c2[k];
    }
    std::memcpy(poses + 16 * i, out.m, sizeof(out.m));
  }
}

// Batched Hamming distances between binary descriptors (DBoW2-style
// scoring primitive): a (N x nbytes) vs b (M x nbytes) -> out (N x M) i32.
void hamming_batch(const unsigned char* a, int n, const unsigned char* b,
                   int m, int nbytes, int* out) {
  for (int i = 0; i < n; ++i) {
    const unsigned char* ai = a + i * nbytes;
    for (int j = 0; j < m; ++j) {
      const unsigned char* bj = b + j * nbytes;
      int d = 0;
      for (int k = 0; k < nbytes; ++k)
        d += __builtin_popcount((unsigned)(ai[k] ^ bj[k]));
      out[i * m + j] = d;
    }
  }
}

}  // extern "C"
