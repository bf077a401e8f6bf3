// tailkit: native multilevel V-cycle executor for the HOST-side f64
// algebraic metric tail (amg.structured.HostTailHybrid).
//
// Why this exists: the host-tail hybrid runs the gamma-critical metric
// tail on the host between two device launches (krylov.pcg_split).
// The jax-CPU tail program pays padded-ELL reads (row width = the MAX row
// length — the 3D-1D curve-coupled rows are ~1000x wider than the bulk
// stencil, so every full matvec reads GBs of padding) and full padded
// batched-dense Schwarz einsums, on one core: ~30 s per 383k-dof cycle at
// production scale.  This executor runs the SAME cycle (V, maxit=1, UA
// transfers — the .dat metric config, /root/reference/src/input_metric.dat
// role) from CSR + ragged per-block data with OpenMP threading: the role
// HAZmath's C `AMG_data` cycle plays in the reference's all-native path
// (/root/reference/src/utils.py:119).
//
// Semantics mirror amg/hierarchy.MGPreconditioner._cycle exactly
// (cycle='v', maxit=1) with the smoother menu the metric tail uses:
//   - MetricSmoother: GS(rev) -> Schwarz(sym mult) -> GS(!rev)
//     (/root/reference/src/utils.py:84 split: interface Schwarz + GS)
//   - MulticolorGS (color-Jacobi within a color = the jax ordering)
//   - Chebyshev on D^{-1}A, Jacobi/l1-Jacobi
//   - UA restrict/prolong via aggregate maps; dense coarse inverse.
// Parity is verified against the jax tail in tests/test_native_tail.py.
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <map>
#include <memory>
#include <mutex>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Csr {
  int64_t n = 0;
  std::vector<int64_t> indptr;
  std::vector<int32_t> idx;
  std::vector<double> val;
};

// y = A x  (parallel rows)
static void spmv(const Csr& A, const double* x, double* y) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < A.n; ++i) {
    double s = 0.0;
    for (int64_t p = A.indptr[i]; p < A.indptr[i + 1]; ++p)
      s += A.val[p] * x[A.idx[p]];
    y[i] = s;
  }
}

// r = b - A x
static void residual(const Csr& A, const double* x, const double* b,
                     double* r) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < A.n; ++i) {
    double s = 0.0;
    for (int64_t p = A.indptr[i]; p < A.indptr[i + 1]; ++p)
      s += A.val[p] * x[A.idx[p]];
    r[i] = b[i] - s;
  }
}

struct GsData {
  int ncolors = 0;
  std::vector<int64_t> cptr;   // ncolors+1 into ids/invd
  std::vector<int32_t> ids;    // row indices, concat per color
  std::vector<double> invd;    // relaxation scale per row (1/diag or 1/l1)
  double omega = 1.0;
  int symmetric = 0;
};

struct SchwarzData {
  int64_t nb = 0;
  std::vector<int64_t> bptr;   // nb+1 into ids
  std::vector<int32_t> ids;    // block dof ids, concat (ragged)
  std::vector<int64_t> fptr;   // nb+1 into inv (sz*sz each)
  std::vector<double> inv;     // dense block inverses, row-major, concat
  std::vector<int32_t> color;  // color per block
  int ncolors = 0;
  std::vector<std::vector<int64_t>> by_color;  // block lists per color
  double weight = 1.0;
  int symmetric = 1;
};

struct ChebData {
  std::vector<double> invd;
  double lmax = 1.0, lmin = 0.125;
  int degree = 3;
};

enum SmKind {
  SM_NONE = 0,
  SM_GS = 1,
  SM_METRIC_GS = 2,   // GS complement + Schwarz
  SM_SCHWARZ = 3,     // Schwarz only (no complement)
  SM_CHEB = 4,
  SM_METRIC_CHEB = 5, // Chebyshev complement + Schwarz
  SM_JACOBI = 6,
};

struct Level {
  Csr A;
  std::vector<int32_t> agg;
  int64_t nc = 0;
  int kind = SM_NONE;
  GsData gs;
  SchwarzData sw;
  ChebData cheb;
  std::vector<double> jac_invd;
  double jac_omega = 1.0;
  // scratch
  std::vector<double> x, b, r, t;
};

struct Tail {
  std::vector<Level> levels;
  int64_t nc = 0;               // coarse size
  std::vector<double> cinv;     // (nc, nc) row-major
  std::vector<double> cb, cx;   // coarse scratch
  int presmooth = 1, postsmooth = 1, coarse_scaling = 0;
};

std::mutex g_mu;
std::map<int64_t, std::unique_ptr<Tail>> g_tails;
int64_t g_next = 1;

static Tail* get(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_tails.find(h);
  return it == g_tails.end() ? nullptr : it->second.get();
}

// ---- smoother applications ------------------------------------------

// One multicolor-GS half sweep over `order` of colors.  Matches the jax
// MulticolorGS._half_sweep: per color, residuals for ALL color rows are
// computed against the CURRENT x, then applied (color-Jacobi — exact GS
// when the color is independent, and what the overflow color needs).
static void gs_half_sweep(Level& L, double* x, const double* b,
                          const std::vector<int>& order) {
  for (int c : order) {
    const int64_t lo = L.gs.cptr[c], hi = L.gs.cptr[c + 1];
#pragma omp parallel for schedule(static)
    for (int64_t k = lo; k < hi; ++k) {
      const int32_t i = L.gs.ids[k];
      double s = 0.0;
      for (int64_t p = L.A.indptr[i]; p < L.A.indptr[i + 1]; ++p)
        s += L.A.val[p] * x[L.A.idx[p]];
      L.t[k - lo] = b[i] - s;
    }
#pragma omp parallel for schedule(static)
    for (int64_t k = lo; k < hi; ++k)
      x[L.gs.ids[k]] += L.gs.omega * L.gs.invd[k] * L.t[k - lo];
  }
}

static void gs_smooth(Level& L, double* x, const double* b, bool reverse) {
  std::vector<int> fwd(L.gs.ncolors);
  for (int c = 0; c < L.gs.ncolors; ++c) fwd[c] = c;
  if (reverse && !L.gs.symmetric) std::reverse(fwd.begin(), fwd.end());
  gs_half_sweep(L, x, b, fwd);
  if (L.gs.symmetric) {
    std::reverse(fwd.begin(), fwd.end());
    gs_half_sweep(L, x, b, fwd);
  }
}

// One Schwarz color update: full residual, then disjoint block solves.
static void schwarz_color(Level& L, double* x, const double* b, int c) {
  residual(L.A, x, b, L.r.data());
  const auto& blocks = L.sw.by_color[c];
#pragma omp parallel for schedule(dynamic)
  for (size_t bi = 0; bi < blocks.size(); ++bi) {
    const int64_t bk = blocks[bi];
    const int64_t lo = L.sw.bptr[bk], hi = L.sw.bptr[bk + 1];
    const int64_t sz = hi - lo;
    const double* M = L.sw.inv.data() + L.sw.fptr[bk];
    const int32_t* ids = L.sw.ids.data() + lo;
    // delta = M @ r[ids]; x[ids] += weight * delta
    for (int64_t i = 0; i < sz; ++i) {
      double s = 0.0;
      const double* row = M + i * sz;
      for (int64_t j = 0; j < sz; ++j) s += row[j] * L.r[ids[j]];
      x[ids[i]] += L.sw.weight * s;
    }
  }
}

static void schwarz_smooth(Level& L, double* x, const double* b,
                           bool reverse) {
  const int nc = L.sw.ncolors;
  if (L.sw.symmetric) {
    for (int c = 0; c < nc; ++c) schwarz_color(L, x, b, c);
    for (int c = nc - 1; c >= 0; --c) schwarz_color(L, x, b, c);
  } else if (reverse) {
    for (int c = nc - 1; c >= 0; --c) schwarz_color(L, x, b, c);
  } else {
    for (int c = 0; c < nc; ++c) schwarz_color(L, x, b, c);
  }
}

static void cheb_smooth(Level& L, double* x, const double* b) {
  const double theta = 0.5 * (L.cheb.lmax + L.cheb.lmin);
  const double delta = 0.5 * (L.cheb.lmax - L.cheb.lmin);
  const double sigma1 = theta / delta;
  const int64_t n = L.A.n;
  double* r = L.r.data();
  double* d = L.t.data();
  double rho = 1.0 / sigma1;
  residual(L.A, x, b, r);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    r[i] *= L.cheb.invd[i];
    d[i] = r[i] / theta;
  }
  for (int k = 1; k < L.cheb.degree; ++k) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) x[i] += d[i];
    residual(L.A, x, b, r);
    const double rho_new = 1.0 / (2.0 * sigma1 - rho);
    const double c1 = rho_new * rho, c2 = 2.0 * rho_new / delta;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i)
      d[i] = c1 * d[i] + c2 * L.cheb.invd[i] * r[i];
    rho = rho_new;
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) x[i] += d[i];
}

static void jacobi_smooth(Level& L, double* x, const double* b) {
  residual(L.A, x, b, L.r.data());
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < L.A.n; ++i)
    x[i] += L.jac_omega * L.jac_invd[i] * L.r[i];
}

// iters applications of the level smoother (MGPreconditioner passes
// presmooth/postsmooth counts; MetricSmoother composes per iteration).
static void smooth(Level& L, double* x, const double* b, int iters,
                   bool reverse) {
  for (int it = 0; it < iters; ++it) {
    switch (L.kind) {
      case SM_GS:
        gs_smooth(L, x, b, reverse);
        break;
      case SM_METRIC_GS:
        gs_smooth(L, x, b, reverse);
        schwarz_smooth(L, x, b, reverse);
        gs_smooth(L, x, b, !reverse);
        break;
      case SM_SCHWARZ:
        schwarz_smooth(L, x, b, reverse);
        break;
      case SM_CHEB:
        cheb_smooth(L, x, b);
        break;
      case SM_METRIC_CHEB:
        cheb_smooth(L, x, b);
        schwarz_smooth(L, x, b, reverse);
        cheb_smooth(L, x, b);
        break;
      case SM_JACOBI:
        jacobi_smooth(L, x, b);
        break;
      default:
        break;
    }
  }
}

}  // namespace

extern "C" {

int64_t tk_create() {
  std::lock_guard<std::mutex> lk(g_mu);
  const int64_t h = g_next++;
  g_tails[h] = std::make_unique<Tail>();
  return h;
}

void tk_free(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_tails.erase(h);
}

void tk_set_opts(int64_t h, int32_t presmooth, int32_t postsmooth,
                 int32_t coarse_scaling) {
  Tail* T = get(h);
  if (!T) return;
  T->presmooth = presmooth;
  T->postsmooth = postsmooth;
  T->coarse_scaling = coarse_scaling;
}

// Add one level (CSR copied). agg: int32 len n (aggregate per row, -1
// allowed = untransferred row); nc = coarse vector length.
void tk_add_level(int64_t h, int64_t n, int64_t nnz,
                  const int64_t* indptr, const int32_t* indices,
                  const double* data, const int32_t* agg, int64_t nc) {
  Tail* T = get(h);
  if (!T) return;
  T->levels.emplace_back();
  Level& L = T->levels.back();
  L.A.n = n;
  L.A.indptr.assign(indptr, indptr + n + 1);
  L.A.idx.assign(indices, indices + nnz);
  L.A.val.assign(data, data + nnz);
  L.agg.assign(agg, agg + n);
  L.nc = nc;
  L.x.assign(n, 0.0);
  L.b.assign(n, 0.0);
  L.r.assign(n, 0.0);
  L.t.assign(n, 0.0);
}

void tk_level_gs(int64_t h, int64_t lvl, int32_t ncolors,
                 const int64_t* cptr, const int32_t* ids,
                 const double* invd, double omega, int32_t symmetric) {
  Tail* T = get(h);
  if (!T || lvl >= (int64_t)T->levels.size()) return;
  GsData& G = T->levels[lvl].gs;
  G.ncolors = ncolors;
  G.cptr.assign(cptr, cptr + ncolors + 1);
  G.ids.assign(ids, ids + cptr[ncolors]);
  G.invd.assign(invd, invd + cptr[ncolors]);
  G.omega = omega;
  G.symmetric = symmetric;
}

void tk_level_schwarz(int64_t h, int64_t lvl, int64_t nb,
                      const int64_t* bptr, const int32_t* ids,
                      const int64_t* fptr, const double* inv,
                      const int32_t* color, int32_t ncolors,
                      double weight, int32_t symmetric) {
  Tail* T = get(h);
  if (!T || lvl >= (int64_t)T->levels.size()) return;
  SchwarzData& S = T->levels[lvl].sw;
  S.nb = nb;
  S.bptr.assign(bptr, bptr + nb + 1);
  S.ids.assign(ids, ids + bptr[nb]);
  S.fptr.assign(fptr, fptr + nb + 1);
  S.inv.assign(inv, inv + fptr[nb]);
  S.color.assign(color, color + nb);
  S.ncolors = ncolors;
  S.weight = weight;
  S.symmetric = symmetric;
  S.by_color.assign(ncolors, {});
  for (int64_t bk = 0; bk < nb; ++bk)
    S.by_color[color[bk]].push_back(bk);
}

void tk_level_cheb(int64_t h, int64_t lvl, const double* invd,
                   double lmax, double lmin, int32_t degree) {
  Tail* T = get(h);
  if (!T || lvl >= (int64_t)T->levels.size()) return;
  Level& L = T->levels[lvl];
  L.cheb.invd.assign(invd, invd + L.A.n);
  L.cheb.lmax = lmax;
  L.cheb.lmin = lmin;
  L.cheb.degree = degree;
}

void tk_level_jacobi(int64_t h, int64_t lvl, const double* invd,
                     double omega) {
  Tail* T = get(h);
  if (!T || lvl >= (int64_t)T->levels.size()) return;
  Level& L = T->levels[lvl];
  L.jac_invd.assign(invd, invd + L.A.n);
  L.jac_omega = omega;
}

void tk_level_kind(int64_t h, int64_t lvl, int32_t kind) {
  Tail* T = get(h);
  if (!T || lvl >= (int64_t)T->levels.size()) return;
  T->levels[lvl].kind = kind;
}

void tk_set_coarse(int64_t h, int64_t nc, const double* inv) {
  Tail* T = get(h);
  if (!T) return;
  T->nc = nc;
  T->cinv.assign(inv, inv + nc * nc);
  T->cb.assign(nc, 0.0);
  T->cx.assign(nc, 0.0);
}

// One V-cycle (maxit=1, zero initial guess): x_out = B b_in.
// Matches MGPreconditioner._cycle for cycle='v'.
void tk_apply(int64_t h, const double* b_in, double* x_out) {
  Tail* T = get(h);
  if (!T) return;
  const int64_t nlev = (int64_t)T->levels.size();
  if (nlev == 0) {  // pure dense solve
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < T->nc; ++i) {
      double s = 0.0;
      const double* row = T->cinv.data() + i * T->nc;
      for (int64_t j = 0; j < T->nc; ++j) s += row[j] * b_in[j];
      x_out[i] = s;
    }
    return;
  }
  std::memcpy(T->levels[0].b.data(), b_in,
              sizeof(double) * T->levels[0].A.n);
  // down: pre-smooth + restrict
  for (int64_t l = 0; l < nlev; ++l) {
    Level& L = T->levels[l];
    std::fill(L.x.begin(), L.x.end(), 0.0);
    smooth(L, L.x.data(), L.b.data(), T->presmooth, false);
    residual(L.A, L.x.data(), L.b.data(), L.r.data());
    double* bc = (l + 1 < nlev) ? T->levels[l + 1].b.data()
                                : T->cb.data();
    const int64_t ncl = L.nc;
    std::fill(bc, bc + ncl, 0.0);
    for (int64_t i = 0; i < L.A.n; ++i) {
      const int32_t a = L.agg[i];
      if (a >= 0) bc[a] += L.r[i];
    }
  }
  // coarse dense solve
  {
    const int64_t nc = T->nc;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nc; ++i) {
      double s = 0.0;
      const double* row = T->cinv.data() + i * nc;
      for (int64_t j = 0; j < nc; ++j) s += row[j] * T->cb[j];
      T->cx[i] = s;
    }
  }
  // up: (scale) + prolong + post-smooth
  for (int64_t l = nlev - 1; l >= 0; --l) {
    Level& L = T->levels[l];
    double* ec = (l + 1 < nlev) ? T->levels[l + 1].x.data()
                                : T->cx.data();
    if (T->coarse_scaling && l + 1 < nlev) {
      // alpha = <rc,ec>/<ec,Ac ec> clipped to [0,2]
      Level& Lc = T->levels[l + 1];
      spmv(Lc.A, ec, Lc.r.data());
      double denom = 0.0, num = 0.0;
#pragma omp parallel for schedule(static) reduction(+ : denom, num)
      for (int64_t i = 0; i < Lc.A.n; ++i) {
        denom += ec[i] * Lc.r[i];
        num += Lc.b[i] * ec[i];
      }
      double alpha = 1.0;
      if (denom > 0.0) {
        alpha = num / (denom + 1e-300);
        alpha = std::min(std::max(alpha, 0.0), 2.0);
      }
#pragma omp parallel for schedule(static)
      for (int64_t i = 0; i < Lc.A.n; ++i) ec[i] *= alpha;
    }
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < L.A.n; ++i) {
      const int32_t a = L.agg[i];
      if (a >= 0) L.x[i] += ec[a];
    }
    smooth(L, L.x.data(), L.b.data(), T->postsmooth, true);
  }
  std::memcpy(x_out, T->levels[0].x.data(),
              sizeof(double) * T->levels[0].A.n);
}

int32_t tk_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
