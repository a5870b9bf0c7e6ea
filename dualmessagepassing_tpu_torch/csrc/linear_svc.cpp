// Linear SVM solvers for the UNC evaluation (unc/linear_svc.py), host
// code built by g++ at first use. scikit-learn's LinearSVC with its
// defaults (squared hinge, L2, intercept as a constant feature) runs
// one of three LIBLINEAR solvers; this file carries those three as
// scikit-learn 1.9 ships them (sklearn/svm/src/liblinear/linear.cpp and
// tron.cpp, with its newrand.h generator), so that the port scores
// embeddings on a machine without scikit-learn:
//   L2R_L2LOSS_SVC       the primal trust-region Newton method (TRON over
//                        l2r_l2_svc_fun; linear.cpp:228-390, 2345-2362,
//                        tron.cpp), for n_samples >= n_features;
//   L2R_L2LOSS_SVC_DUAL  dual coordinate descent (solve_l2r_l1l2_svc,
//                        linear.cpp:819-1018, its L2-loss case), for
//                        n_samples < n_features;
//   MCSVM_CS             Crammer and Singer (Solver_MCSVM_CS,
//                        linear.cpp:493-787).
// around them train()'s class grouping and one-vs-rest loop
// (linear.cpp:2200-2307, 2453-2595). Left out: every other solver,
// sample and class weights (all 1 here), the info() printing, models
// and prediction. TRON's BLAS level-1 calls go to the functions the
// caller passes (scikit-learn passes scipy's BLAS; unc/linear_svc.py
// passes the same where scipy is installed), else to plain loops.
//
// The solvers keep LIBLINEAR's licence:
//
// Copyright (c) 2007-2014 The LIBLINEAR Project.
// All rights reserved.
//
// Redistribution and use in source and binary forms, with or without
// modification, are permitted provided that the following conditions
// are met:
//
// 1. Redistributions of source code must retain the above copyright
// notice, this list of conditions and the following disclaimer.
//
// 2. Redistributions in binary form must reproduce the above copyright
// notice, this list of conditions and the following disclaimer in the
// documentation and/or other materials provided with the distribution.
//
// 3. Neither name of copyright holders nor the names of its contributors
// may be used to endorse or promote products derived from this software
// without specific prior written permission.
//
// THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS
// ``AS IS'' AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT
// LIMITED TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR
// A PARTICULAR PURPOSE ARE DISCLAIMED.  IN NO EVENT SHALL THE REGENTS OR
// CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL, SPECIAL,
// EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED TO,
// PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR
// PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF
// LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING
// NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE OF THIS
// SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <random>
#include <vector>

namespace {

const double INF = HUGE_VAL;
enum { L2R_L2LOSS_SVC_DUAL = 1, L2R_L2LOSS_SVC = 2, MCSVM_CS = 4 };

struct feature_node {
  int index;      // 1-based; -1 ends a row
  double value;
};

struct problem {
  int l, n;
  double *y;
  feature_node **x;
};

// newrand.h: a Mersenne twister and the tweaked Lemire post-processor,
// seeded once per fit (set_parameter -> set_seed).
struct Rand {
  std::mt19937 mt;
  explicit Rand(unsigned seed) : mt(seed) {}
  uint32_t bounded(uint32_t range) {
    uint32_t x = mt();
    uint64_t m = uint64_t(x) * uint64_t(range);
    uint32_t l = uint32_t(m);
    if (l < range) {
      uint32_t t = -range;
      if (t >= range) {
        t -= range;
        if (t >= range) t %= range;
      }
      while (l < t) {
        x = mt();
        m = uint64_t(x) * uint64_t(range);
        l = uint32_t(m);
      }
    }
    return m >> 32;
  }
};

// --- BLAS level 1 ----------------------------------------------------------

typedef double (*ddot_t)(int *, const double *, int *, const double *, int *);
typedef void (*daxpy_t)(int *, double *, const double *, int *, double *,
                        int *);
typedef void (*dscal_t)(int *, double *, double *, int *);
typedef double (*dnrm2_t)(int *, const double *, int *);

struct Blas {          // Fortran-style entry points, or null: plain loops
  ddot_t ddot;
  daxpy_t daxpy;
  dscal_t dscal;
  dnrm2_t dnrm2;

  double dot(int n, const double *x, const double *y) const {
    int one = 1;
    if (ddot) return ddot(&n, x, &one, y, &one);
    double s = 0;
    for (int i = 0; i < n; i++) s += x[i] * y[i];
    return s;
  }
  void axpy(int n, double a, const double *x, double *y) const {
    int one = 1;
    if (daxpy) return daxpy(&n, &a, x, &one, y, &one);
    for (int i = 0; i < n; i++) y[i] += a * x[i];
  }
  void scal(int n, double a, double *x) const {
    int one = 1;
    if (dscal) return dscal(&n, &a, x, &one);
    for (int i = 0; i < n; i++) x[i] *= a;
  }
  double nrm2(int n, const double *x) const {
    int one = 1;
    if (dnrm2) return dnrm2(&n, x, &one);
    return std::sqrt(dot(n, x, x));
  }
};

// --- l2r_l2_svc_fun (linear.cpp:228-390) -----------------------------------

class l2r_l2_svc_fun {
 public:
  l2r_l2_svc_fun(const problem *prob, const double *C)
      : C(C), z(prob->l), I(prob->l), sizeI(0), prob(prob) {}

  int get_nr_variable() const { return prob->n; }

  double fun(const double *w) {
    double f = 0;
    const double *y = prob->y;
    int l = prob->l, w_size = get_nr_variable();
    Xv(w, z.data());
    for (int i = 0; i < w_size; i++) f += w[i] * w[i];
    f /= 2.0;
    for (int i = 0; i < l; i++) {
      z[i] = y[i] * z[i];
      double d = 1 - z[i];
      if (d > 0) f += C[i] * d * d;
    }
    return f;
  }

  void grad(const double *w, double *g) {
    const double *y = prob->y;
    int l = prob->l, w_size = get_nr_variable();
    sizeI = 0;
    for (int i = 0; i < l; i++)
      if (z[i] < 1) {
        z[sizeI] = C[i] * y[i] * (z[i] - 1);
        I[sizeI] = i;
        sizeI++;
      }
    subXTv(z.data(), g);
    for (int i = 0; i < w_size; i++) g[i] = w[i] + 2 * g[i];
  }

  void Hv(const double *s, double *Hs) {
    int w_size = get_nr_variable();
    std::vector<double> wa(sizeI);
    subXv(s, wa.data());
    for (int i = 0; i < sizeI; i++) wa[i] = C[I[i]] * wa[i];
    subXTv(wa.data(), Hs);
    for (int i = 0; i < w_size; i++) Hs[i] = s[i] + 2 * Hs[i];
  }

 private:
  void Xv(const double *v, double *out) {
    for (int i = 0; i < prob->l; i++) {
      const feature_node *s = prob->x[i];
      out[i] = 0;
      for (; s->index != -1; s++) out[i] += v[s->index - 1] * s->value;
    }
  }
  void subXv(const double *v, double *out) {
    for (int i = 0; i < sizeI; i++) {
      const feature_node *s = prob->x[I[i]];
      out[i] = 0;
      for (; s->index != -1; s++) out[i] += v[s->index - 1] * s->value;
    }
  }
  void subXTv(const double *v, double *XTv) {
    for (int i = 0; i < get_nr_variable(); i++) XTv[i] = 0;
    for (int i = 0; i < sizeI; i++)
      for (const feature_node *s = prob->x[I[i]]; s->index != -1; s++)
        XTv[s->index - 1] += v[i] * s->value;
  }

  const double *C;
  std::vector<double> z;
  std::vector<int> I;
  int sizeI;
  const problem *prob;
};

// --- TRON (tron.cpp) ---------------------------------------------------------

int trcg(l2r_l2_svc_fun *fun_obj, const Blas &blas, double delta,
         const double *g, double *s, double *r) {
  int n = fun_obj->get_nr_variable();
  std::vector<double> d(n), Hd(n);
  double rTr, rnewTrnew, alpha, beta, cgtol;
  for (int i = 0; i < n; i++) {
    s[i] = 0;
    r[i] = -g[i];
    d[i] = r[i];
  }
  cgtol = 0.1 * blas.nrm2(n, g);
  int cg_iter = 0;
  rTr = blas.dot(n, r, r);
  while (1) {
    if (blas.nrm2(n, r) <= cgtol) break;
    cg_iter++;
    fun_obj->Hv(d.data(), Hd.data());
    alpha = rTr / blas.dot(n, d.data(), Hd.data());
    blas.axpy(n, alpha, d.data(), s);
    if (blas.nrm2(n, s) > delta) {
      // cg reaches the trust region boundary
      alpha = -alpha;
      blas.axpy(n, alpha, d.data(), s);
      double std_ = blas.dot(n, s, d.data());
      double sts = blas.dot(n, s, s);
      double dtd = blas.dot(n, d.data(), d.data());
      double dsq = delta * delta;
      double rad = std::sqrt(std_ * std_ + dtd * (dsq - sts));
      if (std_ >= 0)
        alpha = (dsq - sts) / (std_ + rad);
      else
        alpha = (rad - std_) / dtd;
      blas.axpy(n, alpha, d.data(), s);
      alpha = -alpha;
      blas.axpy(n, alpha, Hd.data(), r);
      break;
    }
    alpha = -alpha;
    blas.axpy(n, alpha, Hd.data(), r);
    rnewTrnew = blas.dot(n, r, r);
    beta = rnewTrnew / rTr;
    blas.scal(n, beta, d.data());
    blas.axpy(n, 1.0, r, d.data());
    rTr = rnewTrnew;
  }
  return cg_iter;
}

int tron(l2r_l2_svc_fun *fun_obj, const Blas &blas, double eps, int max_iter,
         double *w) {
  // parameters for updating the iterates
  double eta0 = 1e-4, eta1 = 0.25, eta2 = 0.75;
  // parameters for updating the trust region size delta
  double sigma1 = 0.25, sigma2 = 0.5, sigma3 = 4;

  int n = fun_obj->get_nr_variable();
  double delta, snorm;
  double alpha, f, fnew, prered, actred, gs;
  int search = 1, iter = 1;
  std::vector<double> s(n), r(n), w_new(n), g(n);

  for (int i = 0; i < n; i++) w[i] = 0;
  f = fun_obj->fun(w);
  fun_obj->grad(w, g.data());
  delta = blas.nrm2(n, g.data());
  double gnorm1 = delta;
  double gnorm = gnorm1;
  if (gnorm <= eps * gnorm1) search = 0;

  iter = 1;
  while (iter <= max_iter && search) {
    trcg(fun_obj, blas, delta, g.data(), s.data(), r.data());
    std::memcpy(w_new.data(), w, sizeof(double) * n);
    blas.axpy(n, 1.0, s.data(), w_new.data());
    gs = blas.dot(n, g.data(), s.data());
    prered = -0.5 * (gs - blas.dot(n, s.data(), r.data()));
    fnew = fun_obj->fun(w_new.data());

    // the actual reduction
    actred = f - fnew;

    // on the first iteration, adjust the initial step bound
    snorm = blas.nrm2(n, s.data());
    if (iter == 1) delta = std::min(delta, snorm);

    // prediction alpha*snorm of the step
    if (fnew - f - gs <= 0)
      alpha = sigma3;
    else
      alpha = std::max(sigma1, -0.5 * (gs / (fnew - f - gs)));

    // update the trust region bound by the ratio of actual to predicted
    if (actred < eta0 * prered)
      delta = std::min(std::max(alpha, sigma1) * snorm, sigma2 * delta);
    else if (actred < eta1 * prered)
      delta = std::max(sigma1 * delta, std::min(alpha * snorm, sigma2 * delta));
    else if (actred < eta2 * prered)
      delta = std::max(sigma1 * delta, std::min(alpha * snorm, sigma3 * delta));
    else
      delta = std::max(delta, std::min(alpha * snorm, sigma3 * delta));

    if (actred > eta0 * prered) {
      iter++;
      std::memcpy(w, w_new.data(), sizeof(double) * n);
      f = fnew;
      fun_obj->grad(w, g.data());
      gnorm = blas.nrm2(n, g.data());
      if (gnorm <= eps * gnorm1) break;
    }
    if (f < -1.0e+32) break;
    if (std::fabs(actred) <= 0 && prered <= 0) break;
    if (std::fabs(actred) <= 1.0e-12 * std::fabs(f) &&
        std::fabs(prered) <= 1.0e-12 * std::fabs(f))
      break;
  }
  return --iter;
}

// --- solve_l2r_l1l2_svc, L2-loss case (linear.cpp:819-1018) -----------------

int solve_l2r_l2_svc_dual(const problem *prob, double *w, double eps,
                          double Cp, double Cn, int max_iter, Rand &rnd) {
  int l = prob->l;
  int w_size = prob->n;
  int i, s, iter = 0;
  double C, d, G;
  std::vector<double> QD(l), alpha(l), diag(l), upper_bound(l);
  std::vector<int> index(l);
  std::vector<signed char> y(l);
  int active_size = l;

  // PG: projected gradient, for shrinking and stopping
  double PG;
  double PGmax_old = INF;
  double PGmin_old = -INF;
  double PGmax_new, PGmin_new;

  for (i = 0; i < l; i++) {
    double C_i = prob->y[i] > 0 ? Cp : Cn;
    diag[i] = 0.5 / C_i;
    upper_bound[i] = INF;
    y[i] = prob->y[i] > 0 ? +1 : -1;
    alpha[i] = 0;
  }
  for (i = 0; i < w_size; i++) w[i] = 0;
  for (i = 0; i < l; i++) {
    QD[i] = diag[i];
    for (const feature_node *xi = prob->x[i]; xi->index != -1; xi++) {
      double val = xi->value;
      QD[i] += val * val;
      w[xi->index - 1] += y[i] * alpha[i] * val;
    }
    index[i] = i;
  }

  while (iter < max_iter) {
    PGmax_new = -INF;
    PGmin_new = INF;

    for (i = 0; i < active_size; i++) {
      int j = i + rnd.bounded(active_size - i);
      std::swap(index[i], index[j]);
    }

    for (s = 0; s < active_size; s++) {
      i = index[s];
      G = 0;
      signed char yi = y[i];
      for (const feature_node *xi = prob->x[i]; xi->index != -1; xi++)
        G += w[xi->index - 1] * (xi->value);
      G = G * yi - 1;

      C = upper_bound[i];
      G += alpha[i] * diag[i];

      PG = 0;
      if (alpha[i] == 0) {
        if (G > PGmax_old) {
          active_size--;
          std::swap(index[s], index[active_size]);
          s--;
          continue;
        } else if (G < 0) {
          PG = G;
        }
      } else if (alpha[i] == C) {
        if (G < PGmin_old) {
          active_size--;
          std::swap(index[s], index[active_size]);
          s--;
          continue;
        } else if (G > 0) {
          PG = G;
        }
      } else {
        PG = G;
      }

      PGmax_new = std::max(PGmax_new, PG);
      PGmin_new = std::min(PGmin_new, PG);

      if (std::fabs(PG) > 1.0e-12) {
        double alpha_old = alpha[i];
        alpha[i] = std::min(std::max(alpha[i] - G / QD[i], 0.0), C);
        d = (alpha[i] - alpha_old) * yi;
        for (const feature_node *xi = prob->x[i]; xi->index != -1; xi++)
          w[xi->index - 1] += d * xi->value;
      }
    }

    iter++;
    if (PGmax_new - PGmin_new <= eps) {
      if (active_size == l) {
        break;
      } else {
        active_size = l;
        PGmax_old = INF;
        PGmin_old = -INF;
        continue;
      }
    }
    PGmax_old = PGmax_new;
    PGmin_old = PGmin_new;
    if (PGmax_old <= 0) PGmax_old = INF;
    if (PGmin_old >= 0) PGmin_old = -INF;
  }
  return iter;
}

// --- Solver_MCSVM_CS (linear.cpp:493-787) -----------------------------------

class Solver_MCSVM_CS {
 public:
  Solver_MCSVM_CS(const problem *prob, int nr_class, double C_all,
                  double eps = 0.1, int max_iter = 100000)
      : B(nr_class), C(prob->l, C_all), G(nr_class), w_size(prob->n),
        l(prob->l), nr_class(nr_class), max_iter(max_iter), eps(eps),
        prob(prob) {}

  int Solve(double *w, Rand &rnd) {
    int i, m, s;
    int iter = 0;
    std::vector<double> alpha(l * nr_class), alpha_new(nr_class), QD(l),
        d_val(nr_class);
    std::vector<int> index(l), d_ind(nr_class), alpha_index(nr_class * l),
        y_index(l), active_size_i(l);
    int active_size = l;
    double eps_shrink = std::max(10.0 * eps, 1.0);  // shrinking tolerance
    bool start_from_all = true;

    for (i = 0; i < l * nr_class; i++) alpha[i] = 0;
    for (i = 0; i < w_size * nr_class; i++) w[i] = 0;
    for (i = 0; i < l; i++) {
      for (m = 0; m < nr_class; m++) alpha_index[i * nr_class + m] = m;
      QD[i] = 0;
      for (const feature_node *xi = prob->x[i]; xi->index != -1; xi++)
        QD[i] += xi->value * xi->value;
      active_size_i[i] = nr_class;
      y_index[i] = (int)prob->y[i];
      index[i] = i;
    }

    while (iter < max_iter) {
      double stopping = -INF;
      for (i = 0; i < active_size; i++) {
        int j = i + rnd.bounded(active_size - i);
        std::swap(index[i], index[j]);
      }
      for (s = 0; s < active_size; s++) {
        i = index[s];
        double Ai = QD[i];
        double *alpha_i = &alpha[i * nr_class];
        int *alpha_index_i = &alpha_index[i * nr_class];

        if (Ai > 0) {
          for (m = 0; m < active_size_i[i]; m++) G[m] = 1;
          if (y_index[i] < active_size_i[i]) G[y_index[i]] = 0;

          for (const feature_node *xi = prob->x[i]; xi->index != -1; xi++) {
            double *w_i = &w[(xi->index - 1) * nr_class];
            for (m = 0; m < active_size_i[i]; m++)
              G[m] += w_i[alpha_index_i[m]] * (xi->value);
          }

          double minG = INF;
          double maxG = -INF;
          for (m = 0; m < active_size_i[i]; m++) {
            if (alpha_i[alpha_index_i[m]] < 0 && G[m] < minG) minG = G[m];
            if (G[m] > maxG) maxG = G[m];
          }
          if (y_index[i] < active_size_i[i])
            if (alpha_i[(int)prob->y[i]] < C[i] && G[y_index[i]] < minG)
              minG = G[y_index[i]];

          for (m = 0; m < active_size_i[i]; m++) {
            if (be_shrunk(i, m, y_index[i], alpha_i[alpha_index_i[m]],
                          minG)) {
              active_size_i[i]--;
              while (active_size_i[i] > m) {
                if (!be_shrunk(i, active_size_i[i], y_index[i],
                               alpha_i[alpha_index_i[active_size_i[i]]],
                               minG)) {
                  std::swap(alpha_index_i[m],
                            alpha_index_i[active_size_i[i]]);
                  std::swap(G[m], G[active_size_i[i]]);
                  if (y_index[i] == active_size_i[i])
                    y_index[i] = m;
                  else if (y_index[i] == m)
                    y_index[i] = active_size_i[i];
                  break;
                }
                active_size_i[i]--;
              }
            }
          }

          if (active_size_i[i] <= 1) {
            active_size--;
            std::swap(index[s], index[active_size]);
            s--;
            continue;
          }

          if (maxG - minG <= 1e-12)
            continue;
          else
            stopping = std::max(maxG - minG, stopping);

          for (m = 0; m < active_size_i[i]; m++)
            B[m] = G[m] - Ai * alpha_i[alpha_index_i[m]];

          solve_sub_problem(Ai, y_index[i], C[i], active_size_i[i],
                            alpha_new.data());
          int nz_d = 0;
          for (m = 0; m < active_size_i[i]; m++) {
            double d = alpha_new[m] - alpha_i[alpha_index_i[m]];
            alpha_i[alpha_index_i[m]] = alpha_new[m];
            if (std::fabs(d) >= 1e-12) {
              d_ind[nz_d] = alpha_index_i[m];
              d_val[nz_d] = d;
              nz_d++;
            }
          }

          for (const feature_node *xi = prob->x[i]; xi->index != -1; xi++) {
            double *w_i = &w[(xi->index - 1) * nr_class];
            for (m = 0; m < nz_d; m++) w_i[d_ind[m]] += d_val[m] * xi->value;
          }
        }
      }

      iter++;
      if (stopping < eps_shrink) {
        if (stopping < eps && start_from_all == true) {
          break;
        } else {
          active_size = l;
          for (i = 0; i < l; i++) active_size_i[i] = nr_class;
          eps_shrink = std::max(eps_shrink / 2, eps);
          start_from_all = true;
        }
      } else {
        start_from_all = false;
      }
    }
    return iter;
  }

 private:
  void solve_sub_problem(double A_i, int yi, double C_yi, int active_i,
                         double *alpha_new) {
    int r;
    std::vector<double> D(B.begin(), B.begin() + active_i);
    if (yi < active_i) D[yi] += A_i * C_yi;
    // qsort with compare_double: descending
    std::sort(D.begin(), D.end(), std::greater<double>());

    double beta = D[0] - A_i * C_yi;
    for (r = 1; r < active_i && beta < r * D[r]; r++) beta += D[r];
    beta /= r;

    for (r = 0; r < active_i; r++) {
      if (r == yi)
        alpha_new[r] = std::min(C_yi, (beta - B[r]) / A_i);
      else
        alpha_new[r] = std::min((double)0, (beta - B[r]) / A_i);
    }
  }

  bool be_shrunk(int i, int m, int yi, double alpha_i, double minG) {
    double bound = 0;
    if (m == yi) bound = C[i];
    return alpha_i == bound && G[m] < minG;
  }

  std::vector<double> B, C, G;
  int w_size, l;
  int nr_class;
  int max_iter;
  double eps;
  const problem *prob;
};

// --- train_one (linear.cpp:2309-2422) ---------------------------------------

int train_one(const problem *prob, int solver, double eps, int max_iter,
              double *w, double Cp, double Cn, Rand &rnd, const Blas &blas) {
  int pos = 0;
  for (int i = 0; i < prob->l; i++)
    if (prob->y[i] > 0) pos++;
  int neg = prob->l - pos;
  double primal_solver_tol = eps * std::max(std::min(pos, neg), 1) / prob->l;
  if (solver == L2R_L2LOSS_SVC) {
    std::vector<double> C(prob->l);
    for (int i = 0; i < prob->l; i++) C[i] = prob->y[i] > 0 ? Cp : Cn;
    l2r_l2_svc_fun fun_obj(prob, C.data());
    return tron(&fun_obj, blas, primal_solver_tol, max_iter, w);
  }
  return solve_l2r_l2_svc_dual(prob, w, eps, Cp, Cn, max_iter, rnd);
}

}  // namespace

// X: float64 [l, n_features] row-major; y: class index in [0, nr_class)
// (the LabelEncoder's, so group_classes' sorted labels are 0..k-1);
// solver: 1 dual, 2 primal, 4 Crammer-Singer; bias > 0 appends the
// constant feature. coef receives rows x (n_features + (bias > 0))
// float64, row-major: one row for a binary dual or primal problem (the
// second class positive), else one per class; n_iter one count per row
// (one for Crammer-Singer); ddot, daxpy, dscal, dnrm2: Fortran BLAS
// entry points for TRON, or null. Returns 0, or -1 on bad arguments.
extern "C" int dmp_linear_svc_train(const double *X, int l, int n_features,
                                    const int *y, int nr_class, int solver,
                                    double eps, double C, double bias,
                                    int max_iter, unsigned seed, double *coef,
                                    int *n_iter, void *ddot, void *daxpy,
                                    void *dscal, void *dnrm2) {
  if (l <= 0 || n_features < 0 || nr_class < 2 ||
      (solver != L2R_L2LOSS_SVC_DUAL && solver != L2R_L2LOSS_SVC &&
       solver != MCSVM_CS))
    return -1;
  for (int i = 0; i < l; i++)
    if (y[i] < 0 || y[i] >= nr_class) return -1;
  const int n = n_features + (bias > 0);

  // dense_to_sparse (liblinear_helper.c:20-75): zeros are left out
  std::vector<feature_node> space;
  std::vector<size_t> row_start(l);
  for (int i = 0; i < l; i++) {
    row_start[i] = space.size();
    for (int j = 0; j < n_features; j++) {
      double v = X[(size_t)i * n_features + j];
      if (v != 0) space.push_back({j + 1, v});
    }
    if (bias > 0) space.push_back({n_features + 1, bias});
    space.push_back({-1, 0.0});
  }

  // group_classes: the data permuted class by class, stable
  std::vector<int> count(nr_class, 0), start(nr_class, 0), perm(l);
  for (int i = 0; i < l; i++) count[y[i]]++;
  for (int c = 1; c < nr_class; c++) start[c] = start[c - 1] + count[c - 1];
  std::vector<int> next(start);
  for (int i = 0; i < l; i++) perm[next[y[i]]++] = i;

  std::vector<feature_node *> x(l);
  for (int k = 0; k < l; k++) x[k] = &space[row_start[perm[k]]];
  std::vector<double> sub_y(l);
  problem sub_prob{l, n, sub_y.data(), x.data()};
  Rand rnd(seed);
  const Blas blas{(ddot_t)ddot, (daxpy_t)daxpy, (dscal_t)dscal,
                  (dnrm2_t)dnrm2};

  if (solver == MCSVM_CS) {
    for (int c = 0; c < nr_class; c++)
      for (int j = start[c]; j < start[c] + count[c]; j++) sub_y[j] = c;
    std::vector<double> w((size_t)n * nr_class);
    Solver_MCSVM_CS solver_cs(&sub_prob, nr_class, C, eps);
    n_iter[0] = solver_cs.Solve(w.data(), rnd);
    for (int c = 0; c < nr_class; c++)
      for (int j = 0; j < n; j++)
        coef[(size_t)c * n + j] = w[(size_t)j * nr_class + c];
    return 0;
  }
  if (nr_class == 2) {
    int e0 = start[0] + count[0];
    for (int k = 0; k < l; k++) sub_y[k] = k < e0 ? -1 : +1;
    n_iter[0] = train_one(&sub_prob, solver, eps, max_iter, coef, C, C, rnd,
                          blas);
    return 0;
  }
  for (int c = 0; c < nr_class; c++) {
    int si = start[c], ei = si + count[c];
    for (int k = 0; k < l; k++) sub_y[k] = (k >= si && k < ei) ? +1 : -1;
    n_iter[c] = train_one(&sub_prob, solver, eps, max_iter,
                          coef + (size_t)c * n, C, C, rnd, blas);
  }
  return 0;
}
