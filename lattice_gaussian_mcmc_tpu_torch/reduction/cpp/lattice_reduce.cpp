// Host-side lattice reduction: LLL (L2-style floating GSO over an exact
// integer Gram matrix) and BKZ with Schnorr-Euchner enumeration.
//
// This is the TPU build's native replacement for the reference's fplll
// dependency (reference src/lattices/reduction.py:103,275 calls Sage
// Matrix.LLL()/.BKZ()): reduction is inherently sequential exact-arithmetic
// work, so it stays on the host in C++ and the reduced basis is pushed to
// device HBM afterwards (SURVEY.md section 2.2).
//
// GSO state (mu + r-diagonal) is maintained INCREMENTALLY: O(n) per
// size-reduction step and per adjacent swap (the classic LLL update
// formulas), with periodic O(n^3) recomputation from the exact Gram matrix
// to cancel floating-point drift. The previous version recomputed GSO rows
// from scratch after every swap, which made n=256 q-ary reductions take
// minutes; incremental updates bring that to seconds (fplll-style).
//
// Exposed C ABI (ctypes):
//   int lll_reduce(int64_t* basis, int n, double delta);
//   int bkz_reduce(int64_t* basis, int n, int beta, double delta,
//                  int max_tours);
//   basis is row-major, n x n, rows are basis VECTORS. Returns 0 on success,
//   nonzero on numerical failure (caller falls back to Python).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

using i64 = int64_t;
using i128 = __int128;

struct Reducer {
  int n;
  std::vector<std::vector<i64>> b;       // basis rows
  std::vector<std::vector<i128>> G;      // exact Gram matrix
  std::vector<std::vector<double>> mu;   // GSO coefficients (unit diagonal)
  std::vector<std::vector<double>> r;    // only r[i][i] maintained live;
                                         // full rows refreshed on recompute
  long long ops_since_refresh = 0;       // drift guard counter

  explicit Reducer(i64* basis, int n_) : n(n_) {
    b.assign(n, std::vector<i64>(n));
    for (int i = 0; i < n; i++)
      for (int j = 0; j < n; j++) b[i][j] = basis[i * n + j];
    G.assign(n, std::vector<i128>(n));
    for (int i = 0; i < n; i++)
      for (int j = 0; j <= i; j++) {
        i128 s = 0;
        for (int k = 0; k < n; k++) s += (i128)b[i][k] * b[j][k];
        G[i][j] = G[j][i] = s;
      }
    mu.assign(n, std::vector<double>(n, 0.0));
    r.assign(n, std::vector<double>(n, 0.0));
    recompute_all();
  }

  // Full GSO from the exact Gram matrix (Cholesky-style, O(n^3)).
  void recompute_all() {
    for (int i = 0; i < n; i++) {
      for (int j = 0; j <= i; j++) {
        double rij = (double)G[i][j];
        for (int l = 0; l < j; l++) rij -= mu[j][l] * r[i][l];
        r[i][j] = rij;
        if (j < i) mu[i][j] = r[j][j] != 0.0 ? rij / r[j][j] : 0.0;
      }
      mu[i][i] = 1.0;
    }
    ops_since_refresh = 0;
  }

  void maybe_refresh() {
    if (++ops_since_refresh > 16LL * n) recompute_all();
  }

  // b_i -= c * b_j (j < i), exact Gram update + O(n) incremental mu update.
  void addmul(int i, int j, i64 c) {
    if (c == 0) return;
    for (int k = 0; k < n; k++) b[i][k] -= c * b[j][k];
    i128 c128 = (i128)c;
    i128 gii = G[i][i] - 2 * c128 * G[i][j] + c128 * c128 * G[j][j];
    for (int l = 0; l < n; l++) {
      if (l == i) continue;
      G[i][l] -= c128 * G[j][l];
      G[l][i] = G[i][l];
    }
    G[i][i] = gii;
    // mu row i picks up -c * (mu row j) on columns <= j; b*_i (and all other
    // b*'s) are unchanged since b_j lies in span(b*_0..b*_j)
    double cd = (double)c;
    for (int l = 0; l < j; l++) mu[i][l] -= cd * mu[j][l];
    mu[i][j] -= cd;
    // large coefficients multiply existing mu drift by |c| — weight the
    // refresh counter so deep reductions refresh much sooner
    double ac = std::fabs(cd);
    ops_since_refresh += ac > 1024.0 ? 64 : (ac > 16.0 ? 8 : 0);
    maybe_refresh();
  }

  // Negate row i: flips mu row (cols < i) and mu column (rows > i).
  void negate_row(int i) {
    for (int k = 0; k < n; k++) b[i][k] = -b[i][k];
    for (int l = 0; l < n; l++) {
      if (l == i) continue;
      G[i][l] = -G[i][l];
      G[l][i] = G[i][l];
    }
    for (int l = 0; l < i; l++) mu[i][l] = -mu[i][l];
    for (int l = i + 1; l < n; l++) mu[l][i] = -mu[l][i];
  }

  // Swap adjacent rows k-1 and k with O(n) GSO update (classic formulas).
  void swap_adjacent(int k) {
    std::swap(b[k - 1], b[k]);
    std::swap(G[k - 1], G[k]);
    for (int l = 0; l < n; l++) std::swap(G[l][k - 1], G[l][k]);

    double nu = mu[k][k - 1];
    double rk = r[k][k], rk1 = r[k - 1][k - 1];
    double B = rk + nu * nu * rk1;
    if (B <= 0.0 || !std::isfinite(B)) { recompute_all(); return; }
    double mu_new = nu * rk1 / B;
    r[k][k] = rk1 * rk / B;
    r[k - 1][k - 1] = B;
    for (int j = 0; j < k - 1; j++) std::swap(mu[k - 1][j], mu[k][j]);
    mu[k][k - 1] = mu_new;
    double rk_over_B = rk / B;
    for (int i = k + 1; i < n; i++) {
      double t = mu[i][k - 1], u = mu[i][k];
      mu[i][k - 1] = t * mu_new + u * rk_over_B;
      mu[i][k] = t - nu * u;
    }
    maybe_refresh();
  }

  // Size-reduce row k against rows j < k. Returns false on overflow risk.
  bool size_reduce(int k) {
    const double eta = 0.51;
    for (int iter = 0; iter < 64; iter++) {
      bool any = false, big = false;
      for (int j = k - 1; j >= 0; j--) {
        double m = mu[k][j];
        if (std::fabs(m) > eta) {
          double rm = std::nearbyint(m);
          if (std::fabs(rm) > 9.0e18) return false;  // would overflow i64
          addmul(k, j, (i64)rm);
          any = true;
          if (std::fabs(rm) > 1048576.0) big = true;
        }
      }
      if (!any) return true;
      // re-reducing means the first pass used drifted mu (or amplified it
      // with a huge coefficient) — refresh from the exact Gram before the
      // next pass so the loop converges instead of cycling
      if (big || iter > 0) recompute_all();
    }
    return true;  // eta-reduction may cycle at FP precision limits; accept
  }

  int lll_pass(double delta) {
    int k = 1;
    long long guard = 0, guard_max = 64LL * n * n * n + 1000000;
    while (k < n) {
      if (++guard > guard_max) return 1;
      if (!size_reduce(k)) return 2;
      double lhs = delta * r[k - 1][k - 1];
      double rhs = r[k][k] + mu[k][k - 1] * mu[k][k - 1] * r[k - 1][k - 1];
      if (lhs <= rhs) {
        k++;
      } else {
        swap_adjacent(k);
        k = k > 1 ? k - 1 : 1;
      }
    }
    return 0;
  }

  // Verified LLL: run passes until the output checks out against a fresh
  // exact-Gram GSO (Lovász + size-reduction), bounding FP-drift escapes.
  int lll(double delta) {
    for (int pass = 0; pass < 8; pass++) {
      int rc = lll_pass(delta);
      if (rc != 0) return rc;
      recompute_all();
      bool ok = true;
      for (int kk = 1; kk < n && ok; kk++) {
        double lhs = delta * r[kk - 1][kk - 1];
        double rhs =
            r[kk][kk] + mu[kk][kk - 1] * mu[kk][kk - 1] * r[kk - 1][kk - 1];
        if (lhs > rhs * (1.0 + 1e-9)) ok = false;
        for (int j = 0; j < kk && ok; j++)
          if (std::fabs(mu[kk][j]) > 0.52) ok = false;
      }
      if (ok) return 0;
    }
    return 3;  // persistent FP trouble: caller falls back to Python
  }

  double gs_norm2(int i) { return r[i][i]; }

  // Raw row op b_p += c * b_q with exact Gram update and NO GSO update —
  // the caller must recompute_all() before trusting mu/r again. Used by the
  // general BKZ insertion below where ops go in both row directions.
  void row_addmul_raw(int p, int q, i64 c) {
    if (c == 0) return;
    for (int k = 0; k < n; k++) b[p][k] += c * b[q][k];
    i128 c128 = (i128)c;
    i128 gpp = G[p][p] + 2 * c128 * G[p][q] + c128 * c128 * G[q][q];
    for (int l = 0; l < n; l++) {
      if (l == p) continue;
      G[p][l] += c128 * G[q][l];
      G[l][p] = G[p][l];
    }
    G[p][p] = gpp;
  }

  // Raw adjacent-free row swap (basis + Gram only; GSO left stale).
  void swap_rows_raw(int a, int bb) {
    std::swap(b[a], b[bb]);
    std::swap(G[a], G[bb]);
    for (int l = 0; l < n; l++) std::swap(G[l][a], G[l][bb]);
  }

  // General BKZ insertion: make row j equal v = sum_t x[t] * b[j+t]
  // (x integer, not all zero) while keeping the rows a basis of the same
  // lattice. This is what fplll's BKZ achieves by extending the block with
  // v and LLL-ing out the linear dependency (reference
  // src/lattices/reduction.py:275 semantics); here the dependency never
  // exists: x is reduced to +-g * e_p by a sequence of 2-row unimodular
  // Euclidean steps applied simultaneously to the basis. Identity used:
  //   v = ... + x_p b_p + x_q b_q  ==  x_p (b_p + c b_q) + (x_q - c x_p) b_q
  // so the coefficient step x_q -= c * x_p pairs with the row op
  // b_p += c * b_q. Divides x by gcd(x) first (v/g is shorter and in the
  // lattice). Leaves GSO stale; caller recomputes.
  void insert_combination(int j, std::vector<i64> x) {
    int m = (int)x.size();
    // gcd division
    i64 g = 0;
    for (i64 v : x) g = std::__gcd(g, v < 0 ? -v : v);
    if (g == 0) return;
    if (g > 1)
      for (auto& v : x) v /= g;
    // Euclidean elimination to a single +-1 coefficient
    while (true) {
      int p = -1;
      for (int t = 0; t < m; t++)
        if (x[t] != 0 &&
            (p < 0 || std::llabs(x[t]) < std::llabs(x[p])))
          p = t;
      bool others = false;
      for (int t = 0; t < m; t++) {
        if (t == p || x[t] == 0) continue;
        others = true;
        // c = nearest integer to x[t] / x[p]: strict reduction since
        // |x[t]| >= |x[p]|
        double cd = std::nearbyint((double)x[t] / (double)x[p]);
        i64 c = (i64)cd;
        if (c == 0) c = x[t] > 0 == x[p] > 0 ? 1 : -1;
        x[t] -= c * x[p];
        row_addmul_raw(j + p, j + t, c);
      }
      if (!others) {
        if (x[p] < 0) {
          for (int k = 0; k < n; k++) b[j + p][k] = -b[j + p][k];
          for (int l = 0; l < n; l++) {
            if (l == j + p) continue;
            G[j + p][l] = -G[j + p][l];
            G[l][j + p] = G[j + p][l];
          }
        }
        // bubble the new short row down to position j
        for (int t = j + p; t > j; t--) swap_rows_raw(t, t - 1);
        return;
      }
    }
  }
};

// Schnorr-Euchner enumeration (depth-first zig-zag).
struct Enumerator {
  int m, j0;
  const std::vector<std::vector<double>>& mu;
  const std::vector<std::vector<double>>& r;
  std::vector<double> x, c, partdist, step;
  std::vector<double> best;
  std::vector<double> prune;  // per-level bound fraction (linear pruning)
  double R;
  bool found = false;
  long long budget;

  Enumerator(int j0_, int m_, double bound,
             const std::vector<std::vector<double>>& mu_,
             const std::vector<std::vector<double>>& r_, long long budget_,
             bool use_pruning = false)
      : m(m_), j0(j0_), mu(mu_), r(r_), x(m_, 0), c(m_, 0),
        partdist(m_ + 1, 0), step(m_, 0), best(m_, 0), prune(m_ + 1, 1.0),
        R(bound), budget(budget_) {
    if (use_pruning) {
      // linear pruning (Schnorr-Horner): at depth k from the leaves the
      // partial distance may use only ~((m - k)/m) of the bound
      for (int k = 0; k <= m; k++)
        prune[k] = std::max(0.3, (double)(m - k + 1) / m);
    }
  }

  void center(int k) {
    double s = 0;
    for (int t = k + 1; t < m; t++) s += x[t] * mu[j0 + t][j0 + k];
    c[k] = -s;
  }

  // next candidate for x[k] in zig-zag order: c, c+1, c-1, c+2, c-2, ...
  void first(int k) {
    center(k);
    x[k] = std::nearbyint(c[k]);
    step[k] = 0;
  }
  void next(int k) {
    double s = step[k];
    s = (s <= 0) ? -s + 1 : -s;
    step[k] = s;
    x[k] = std::nearbyint(c[k]) + s;
  }

  void run() {
    int k = m - 1;
    first(k);
    while (true) {
      if (--budget < 0) return;
      double yk = x[k] - c[k];
      double dist = partdist[k + 1] + yk * yk * r[j0 + k][j0 + k];
      if (dist < R * prune[k] * (1.0 - 1e-12)) {
        if (k == 0) {
          bool nonzero = false;
          for (int t = 0; t < m; t++)
            if (std::fabs(x[t]) > 0.5) { nonzero = true; break; }
          if (nonzero) { R = dist; best = x; found = true; }
          next(k);
        } else {
          partdist[k] = dist;
          k--;
          first(k);
        }
      } else {
        k++;
        if (k >= m) return;
        next(k);
      }
    }
  }
};

}  // namespace

extern "C" {

int lll_reduce(i64* basis, int n, double delta) {
  Reducer red(basis, n);
  int rc = red.lll(delta);
  if (rc == 0)
    for (int i = 0; i < n; i++)
      for (int j = 0; j < n; j++) basis[i * n + j] = red.b[i][j];
  return rc;
}

// One BKZ tour applies enumeration to each block and inserts improvements.
int bkz_reduce(i64* basis, int n, int beta, double delta, int max_tours) {
  Reducer red(basis, n);
  int rc = red.lll(delta);
  if (rc != 0) return rc;
  if (beta < 2) beta = 2;

  for (int tour = 0; tour < max_tours; tour++) {
    bool improved = false;
    red.recompute_all();  // enumeration wants full-accuracy r rows
    for (int j = 0; j < n - 1; j++) {
      int kend = j + beta - 1 < n - 1 ? j + beta - 1 : n - 1;
      int m = kend - j + 1;
      if (m < 2) continue;
      double bound = red.r[j][j];
      // linear pruning for large blocks (finds slightly fewer vectors per
      // tour but explores orders of magnitude fewer nodes at beta >= 25)
      Enumerator en(j, m, bound * (1.0 - 1e-9), red.mu, red.r, 20000000,
                    beta >= 25);
      en.run();
      if (en.found) {
        // General insertion: ANY integer combination is inserted at
        // position j via unimodular Euclidean row ops — nothing is
        // silently skipped when the last nonzero coefficient is not +-1
        // (fplll handles those by extending the block and LLL-ing out the
        // dependency; insert_combination is the fixed-size equivalent).
        std::vector<i64> x(m);
        for (int t = 0; t < m; t++) x[t] = (i64)std::nearbyint(en.best[t]);
        red.insert_combination(j, x);
        red.recompute_all();
        rc = red.lll(delta);
        if (rc != 0) return rc;
        red.recompute_all();
        improved = true;
      }
    }
    if (!improved) break;
  }
  for (int i = 0; i < n; i++)
    for (int j = 0; j < n; j++) basis[i * n + j] = red.b[i][j];
  return 0;
}

// Gram-Schmidt profile of an integer basis (squared norms), for analytics.
int gso_profile(i64* basis, int n, double* out_norm2) {
  Reducer red(basis, n);
  for (int i = 0; i < n; i++) out_norm2[i] = red.gs_norm2(i);
  return 0;
}

}  // extern "C"
