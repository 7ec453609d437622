// The eleven Riemann solvers of Godunov SPH as device functions, one
// elementwise call each: (rhol, rhor, pl, pr, ul, ur) -> (pstar, ustar).
//
// The counterpart of pysph_tpu_torch/sph/gas_dynamics/riemann_solver.py
// (the JAX package's pysph_tpu/sph/gas_dynamics/riemann_solver.py), in
// its operations and their order: each torch.where is a select, each
// torch.clamp(x, min=c) and torch.maximum / torch.minimum propagates a
// NaN as torch's does (cmax, tmax, tmin), the constants that the torch
// solver forms from gamma in Python doubles are formed in double here and
// cast to the working type where the torch solver meets a tensor, and the
// iterative solvers (van Leer, exact) run exactly niter Newton trips, as
// the JAX package's fori_loop: no early exit, and tol is unused.  The
// guards stay: the SMALLP = 1e-25 floors, van Leer's zeroing of a state
// with a negative density or pressure, the exact solver's zeroing where
// the states would generate a vacuum.  A select evaluates only the
// branch it takes, so a NaN or an infinity of the branch it discards (the
// exact solver's pressure guesses in float32) never reaches the result,
// as it does not through torch.where.
//
// riemann::solve(method, ...) dispatches on the solver's id, uniform over
// a launch (the ids of riemann_solver.SOLVERS; an unknown one gives 0, and
// the wrappers refuse it before a launch).

#pragma once

#include <cuda_runtime.h>

namespace riemann {

constexpr double kSmallP = 1e-25;

// torch.clamp(x, min=c): a NaN x stays
template <typename T>
__device__ __forceinline__ T cmax(T x, T c) {
  return x != x ? x : (x < c ? c : x);
}
// torch.maximum / torch.minimum: a NaN of either side propagates
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float tpow(float x, float e) { return powf(x, e); }
__device__ __forceinline__ double tpow(double x, double e) {
  return pow(x, e);
}

template <typename T>
__device__ __forceinline__ void non_diffusive(T, T, T pl, T pr, T ul, T ur,
                                              T& ps, T& us) {
  ps = T(0.5) * (pl + pr);
  us = T(0.5) * (ul + ur);
}

template <typename T>
__device__ void van_leer(T rhol, T rhor, T pl, T pr, T ul, T ur,
                         double gamma, int niter, T& ps, T& us) {
  const double gamma2d = 1.0 + gamma;
  const T gamma2 = T(gamma2d);
  const T gamma1 = T(0.5 * gamma2d / gamma);
  const T g = T(gamma);
  const T smallp = T(kSmallP);
  const T Vl = T(1) / rhol;
  const T Vr = T(1) / rhor;
  const T cl = sqrt(g * pl * rhol);
  const T cr = sqrt(g * pr * rhor);
  T pstar = pl + (pr - pl - cr * (ur - ul)) * cl / (cl + cr);
  pstar = cmax(pstar, smallp);
  T wl = cl, wr = cr;
  for (int it = 0; it < niter; ++it) {
    wl = cl * sqrt(cmax(T(1) + gamma1 * (pstar - pl) / pl, smallp));
    wr = cr * sqrt(cmax(T(1) + gamma1 * (pstar - pr) / pr, smallp));
    T zl = T(4) * Vl * wl * wl;
    zl = -zl * wl / (zl - gamma2 * (pstar - pl));
    T zr = T(4) * Vr * wr * wr;
    zr = zr * wr / (zr - gamma2 * (pstar - pr));
    const T ustar_l = ul - (pstar - pl) / wl;
    const T ustar_r = ur + (pstar - pr) / wr;
    pstar = pstar + (ustar_r - ustar_l) * (zl * zr) / (zr - zl);
    pstar = cmax(pstar, smallp);
  }
  const T ustar_l = ul - (pstar - pl) / wl;
  const T ustar_r = ur + (pstar - pr) / wr;
  const T ustar = T(0.5) * (ustar_l + ustar_r);
  const bool bad = rhol < T(0) || rhor < T(0) || pl < T(0) || pr < T(0);
  ps = bad ? T(0) : pstar;
  us = bad ? T(0) : ustar;
}

// the exact solver's constants, formed in double from gamma
struct Exact {
  double g1, g2, g3, g4, g5, g6, g7;
  __device__ explicit Exact(double gamma) {
    const double tmp1 = 1.0 / (2 * gamma);
    const double tmp2 = 1.0 / (gamma - 1.0);
    const double tmp3 = 1.0 / (gamma + 1.0);
    g1 = (gamma - 1.0) * tmp1;
    g2 = (gamma + 1.0) * tmp1;
    g3 = 2 * gamma * tmp2;
    g4 = 2 * tmp2;
    g5 = 2 * tmp3;
    g6 = tmp3 / tmp2;
    g7 = 0.5 * (gamma - 1.0);
  }
};

// f and f' of the exact solver's pressure function for one side
template <typename T>
__device__ __forceinline__ void prefun(T p, T dk, T pk, T ck, const Exact& c,
                                       T& f, T& fd) {
  const T pratio = p / pk;
  if (p <= pk) {
    f = T(c.g4) * ck * (tpow(pratio, T(c.g1)) - T(1));
    fd = (T(1) / (dk * ck)) * tpow(pratio, T(-c.g2));
  } else {
    const T ak = T(c.g5) / dk;
    const T bk = T(c.g6) * pk;
    const T qrt = sqrt(ak / (bk + p));
    f = (p - pk) * qrt;
    fd = (T(1) - T(0.5) * (p - pk) / (bk + p)) * qrt;
  }
}

template <typename T>
__device__ void exact(T rhol, T rhor, T pl, T pr, T ul, T ur, double gamma,
                      int niter, T& ps, T& us) {
  const Exact c(gamma);
  const T g = T(gamma);
  const T smallp = T(kSmallP);
  const T cl = sqrt(g * pl / rhol);
  const T cr = sqrt(g * pr / rhor);
  // the pressure guess: PVRS, two-rarefaction or two-shock
  const T cup = T(0.25) * (rhol + rhor) * (cl + cr);
  const T ppv = cmax(T(0.5) * (pl + pr) + T(0.5) * (ul - ur) * cup, T(0));
  const T pmin = tmin(pl, pr);
  const T pmax = tmax(pl, pr);
  const T qmax = pmax / pmin;
  T pm;
  if (qmax <= T(2) && pmin <= ppv && ppv <= pmax) {
    pm = ppv;
  } else if (ppv < pmin) {
    const T pq = tpow(pl / pr, T(c.g1));
    const T um_g = (pq * ul / cl + ur / cr + T(c.g4) * (pq - T(1))) /
                   (pq / cl + T(1) / cr);
    const T ptl = T(1) + T(c.g7) * (ul - um_g) / cl;
    const T ptr = T(1) + T(c.g7) * (um_g - ur) / cr;
    pm = T(0.5) * (pl * tpow(cmax(ptl, smallp), T(c.g3)) +
                   pr * tpow(cmax(ptr, smallp), T(c.g3)));
  } else {
    const T gel = sqrt((T(c.g5) / rhol) / (T(c.g6) * pl + ppv));
    const T ger = sqrt((T(c.g5) / rhor) / (T(c.g6) * pr + ppv));
    pm = (gel * pl + ger * pr - (ur - ul)) / (gel + ger);
  }
  T p = cmax(pm, smallp);
  const T udiff = ur - ul;
  for (int it = 0; it < niter; ++it) {
    T fl, fld, fr, frd;
    prefun(p, rhol, pl, cl, c, fl, fld);
    prefun(p, rhor, pr, cr, c, fr, frd);
    p = cmax(p - (fl + fr + udiff) / (fld + frd), smallp);
  }
  T fl, fr, unused;
  prefun(p, rhol, pl, cl, c, fl, unused);
  prefun(p, rhor, pr, cr, c, fr, unused);
  const T um = T(0.5) * (ul + ur + fr - fl);
  // vacuum generation: the reference returns an error code
  const bool vacuum = T(c.g4) * (cl + cr) <= (ur - ul);
  ps = vacuum ? T(0) : p;
  us = vacuum ? T(0) : um;
}

// abs(x) carrying the sign of y
template <typename T>
__device__ __forceinline__ T sign_of(T x, T y) {
  return y >= T(0) ? fabs(x) : -fabs(x);
}

template <typename T>
__device__ void ducowicz(T rhol, T rhor, T pl, T pr, T ul, T ur,
                         double gamma, T& ps, T& us) {
  const T al = T(0.5 * (gamma + 1.0));
  const T ar = T(0.5 * (gamma + 1.0));
  const T g = T(gamma);
  const T csl = sqrt(g * pl * rhol);
  const T csr = sqrt(g * pr * rhor);
  const T umin = ur - T(0.5) * csr / ar;
  const T umax = ul + T(0.5) * csl / al;
  const T plmin = pl - T(0.25) * rhol * csl * csl / al;
  const T prmin = pr - T(0.25) * rhor * csr * csr / ar;
  const T bl = rhol * al;
  const T br = rhor * ar;
  const T a = (br - bl) * (prmin - plmin);
  const T b = br * umin * umin - bl * umax * umax;
  const T c = br * umin - bl * umax;
  const T d = br * bl * (umin - umax) * (umin - umax);
  const T ddA = sqrt(cmax(d - a, T(0)));
  const T uA = (b + prmin - plmin) / (c - sign_of(ddA, umax - umin));
  const bool okA = (uA - umin) >= T(0) && (uA - umax) <= T(0);
  const T ddB = sqrt(cmax(d + a, T(0)));
  const T uB = (b - prmin + plmin) / (c - sign_of(ddB, umax - umin));
  const bool okB = (uB - umin) <= T(0) && (uB - umax) >= T(0);
  const T a2 = (bl + br) * (plmin - prmin);
  const T b2 = bl * umax + br * umin;
  const T c2 = T(1) / (bl + br);
  const T ddC = sqrt(cmax(a2 - d, T(0)));
  const T uC = (b2 + ddC) * c2;
  const bool okC = (uC - umin) >= T(0) && (uC - umax) >= T(0);
  const T ddD = sqrt(cmax(-a2 - d, T(0)));
  const T uD = (b2 - ddD) * c2;
  const T ustar = okA ? uA : okB ? uB : okC ? uC : uD;
  const T pstar = T(0.5) * (plmin + prmin +
                            br * fabs(ustar - umin) * (ustar - umin) -
                            bl * fabs(ustar - umax) * (ustar - umax));
  ps = cmax(pstar, T(0));
  us = ustar;
}

template <typename T>
__device__ void roe(T rhol, T rhor, T pl, T pr, T ul, T ur, double gamma,
                    T& ps, T& us) {
  const T rrhol = sqrt(rhol);
  const T rrhor = sqrt(rhor);
  const T denominator = T(1) / (rrhor + rrhol);
  const T plr = (rrhol * pl + rrhor * pr) * denominator;
  const T vlr = (rrhol / rhol + rrhor / rhor) * denominator;
  const T ulr = (rrhol * ul + rrhor * ur) * denominator;
  const T cslr = sqrt(T(gamma) * plr / vlr);
  const T cslr1 = T(1) / cslr;
  ps = plr - T(0.5) * (ur - ul) * cslr;
  us = ulr - T(0.5) * (pr - pl) * cslr1;
}

template <typename T>
__device__ void llxf(T rhol, T rhor, T pl, T pr, T ul, T ur, double gamma,
                     T& ps, T& us) {
  const T gamma1 = T(1.0 / (gamma - 1.0));
  const T g = T(gamma);
  const T csl = sqrt(g * pl * rhol);
  const T csr = sqrt(g * pr * rhor);
  const T cslr = tmax(csr, csl);
  const T El = pl * gamma1 / rhol + T(0.5) * ul * ul;
  const T Er = pr * gamma1 / rhor + T(0.5) * ur * ur;
  const T pstar = T(0.5) * (pl + pr - cslr * (ur - ul));
  ps = pstar;
  us = (T(0.5) * ((pl * ul + pr * ur) - cslr * (Er - El))) / pstar;
}

template <typename T>
__device__ void hllc(T rhol, T rhor, T pl, T pr, T ul, T ur, double gamma,
                     T& ps, T& us) {
  const T gamma1 = T(1.0 / (gamma - 1.0));
  const T g = T(gamma);
  const T rrhol = sqrt(rhol);
  const T rrhor = sqrt(rhor);
  const T ulr = (rrhol * ul + rrhor * ur) / (rrhol + rrhor);
  const T vl = ul - ulr;
  const T vr = ur - ulr;
  const T csl = sqrt(g * pl / rhol);
  const T csr = sqrt(g * pr / rhor);
  const T cslr = (rrhol * csl + rrhor * csr) / (rrhol + rrhor);
  const T sl = tmin(vl - csl, -cslr);
  const T sr = tmax(vr + csr, cslr);
  const T sm = (rhor * vr * (sr - vr) - rhol * vl * (sl - vl) + pl - pr) /
               (rhor * (sr - vr) - rhol * (sl - vl));
  const T phat = rhol * (vl - sl) * (vl - sm) + pl;
  const T El = rhol * (pl * gamma1 / rhol + T(0.5) * ul * ul);
  const T Er = rhor * (pr * gamma1 / rhor + T(0.5) * ur * ur);
  const T Ml = rhol * ul;
  const T Mr = rhor * ur;
  auto star = [&](T s_, T v_, T M_, T E_, T p_, T& pst, T& ust) {
    const T m = T(1) / (s_ - sm) * ((s_ - v_) * M_ + (phat - p_));
    const T e = T(1) / (s_ - sm) * ((s_ - v_) * E_ - p_ * v_ + phat * sm);
    pst = sm * m + phat;
    ust = (sm * e + (sm + ulr) * phat) / pst;
  };
  if (sl > T(0)) {
    ps = pl;
    us = ul;
  } else if (sm > T(0)) {
    star(sl, vl, Ml, El, pl, ps, us);
  } else if (sr > T(0)) {
    star(sr, vr, Mr, Er, pr, ps, us);
  } else {
    ps = pr;
    us = ur;
  }
}

template <typename T>
__device__ void hllc_ball(T rhol, T rhor, T pl, T pr, T ul, T ur,
                          double gamma, T& ps, T& us) {
  const T gamma1 = T(0.5 * (gamma + 1.0) / gamma);
  const T g = T(gamma);
  const T csl = sqrt(g * pl / rhol);
  const T csr = sqrt(g * pr / rhor);
  const T cslr = T(0.5) * (csl + csr);
  const T rholr = T(0.5) * (rhol + rhor);
  T pstar = T(0.5) * (pl + pr - rholr * cslr * (ur - ul));
  const T ustar = T(0.5) * (ul + ur - T(1) / (rholr * cslr) * (pr - pl));
  const T Hl = pstar / pl;
  const T Hr = pstar / pr;
  const T ql = Hl > T(1) ? sqrt(T(1) + gamma1 * (Hl - T(1))) : T(1);
  const T qr = Hr > T(1) ? sqrt(T(1) + gamma1 * (Hr - T(1))) : T(1);
  const T Sl = ul - csl * ql;
  const T Sr = ur + csr * qr;
  const T pstar_l = pl + rhol * (ul - Sl) * (ul - ustar);
  const T pstar_r = pr + rhor * (ur - Sr) * (ur - ustar);
  pstar = T(0.5) * (pstar_l + pstar_r);
  ps = pstar;
  us = ustar;
}

template <typename T>
__device__ void hlle(T rhol, T rhor, T pl, T pr, T ul, T ur, double gamma,
                     T& ps, T& us) {
  const T gamma1 = T(1.0 / (gamma - 1.0));
  const T g = T(gamma);
  const T rrhol = sqrt(rhol);
  const T rrhor = sqrt(rhor);
  const T csl = sqrt(g * pl * rhol);
  const T csr = sqrt(g * pr * rhor);
  const T cslr = (rrhol * csl + rrhor * csr) / (rrhol + rrhor);
  const T sl = tmin(ul - csl, -cslr);
  const T sr = tmax(ur + csr, cslr);
  const T smax = tmax(sl, sr);
  const T smin = tmin(sl, sr);
  const T El = pl * gamma1 / rhol + T(0.5) * ul * ul;
  const T Er = pr * gamma1 / rhor + T(0.5) * ur * ur;
  const T pstar = ((smax * pl - smin * pr) / (smax - smin) +
                   smax * smin / (smax - smin) * (ur - ul));
  const T ustar = ((smax * pl * ul - smin * pr * ur) / (smax - smin) +
                   smax * smin / (smax - smin) * (Er - El));
  ps = pstar;
  us = ustar / pstar;
}

template <typename T>
__device__ void hll_ball(T rhol, T rhor, T pl, T pr, T ul, T ur,
                         double gamma, T& ps, T& us) {
  const T g = T(gamma);
  const T rrhol = sqrt(rhol);
  const T rrhor = sqrt(rhor);
  const T denominator = T(1) / (rrhor + rrhol);
  const T csl = sqrt(g * pl / rhol);
  const T csr = sqrt(g * pr / rhor);
  const T eta = T(0.5 * (gamma - 1.0)) * (rrhor * rrhol) * denominator *
                denominator;
  const T betal = fabs(ul);
  const T betar = fabs(ur);
  const T ulr = (rrhol * ul + rrhor * ur) / (rrhol * rrhor);
  const T cslr2 = (rrhol * csl * csl + rrhor * csr * csr) / (rrhol * rrhor);
  const T cslr = sqrt(cslr2 + eta * (betar - betal) * (betar - betal));
  const T Sl = tmin(ulr - cslr, ul - csl);
  const T Sr = tmax(ulr + cslr, ur + csr);
  const T ustar = ((Sr * Sl * (rhor - rhol) + rhol * ul * Sr -
                    rhor * ur * Sl) /
                   (rhol * (ul - Sl) + rhor * (Sr - ur)));
  ps = (pr * (ustar - Sl) - pl * (ustar - Sr) +
        rhor * ur * (ustar - Sl) * (ur - Sr) -
        rhol * ul * (ustar - Sr) * (ul - Sl)) /
       (Sr - Sl);
  us = ustar;
}

template <typename T>
__device__ void hllsy(T rhol, T rhor, T pl, T pr, T ul, T ur, double gamma,
                      T& ps, T& us) {
  const T gamma1 = T(1.0 / (gamma - 1.0));
  const T g = T(gamma);
  const T rrhol = sqrt(rhol);
  const T rrhor = sqrt(rhor);
  const T denominator = T(1) / (rrhor + rrhol);
  const T csl = sqrt(g * pl * rhol);
  const T csr = sqrt(g * pr * rhor);
  const T cslr = denominator * (rrhol * csl + rrhor * csr);
  const T bl = tmax(csl, cslr);
  const T br = tmax(csr, cslr);
  const T wl = br / (bl + br);
  const T wr = bl / (bl + br);
  const T wlr = bl * br / (bl + br);
  const T El = pl * gamma1 / rhol + T(0.5) * ul * ul;
  const T Er = pr * gamma1 / rhor + T(0.5) * ur * ur;
  const T pstar = wl * pl + wr * pr - wlr * (ur - ul);
  ps = pstar;
  us = (wl * (pl * ul) + wr * (pr * ur) - wlr * (Er - El)) / pstar;
}

// The solver of id `method` (riemann_solver.SOLVERS): 0 non_diffusive,
// 1 van_leer, 2 exact, 3 hllc, 4 ducowicz, 5 hlle, 6 roe, 7 llxf,
// 8 hllc_ball, 9 hll_ball, 10 hllsy.
template <typename T>
__device__ void solve(int method, T rhol, T rhor, T pl, T pr, T ul, T ur,
                      double gamma, int niter, T& ps, T& us) {
  switch (method) {
    case 0:
      non_diffusive(rhol, rhor, pl, pr, ul, ur, ps, us);
      break;
    case 1:
      van_leer(rhol, rhor, pl, pr, ul, ur, gamma, niter, ps, us);
      break;
    case 2:
      exact(rhol, rhor, pl, pr, ul, ur, gamma, niter, ps, us);
      break;
    case 3:
      hllc(rhol, rhor, pl, pr, ul, ur, gamma, ps, us);
      break;
    case 4:
      ducowicz(rhol, rhor, pl, pr, ul, ur, gamma, ps, us);
      break;
    case 5:
      hlle(rhol, rhor, pl, pr, ul, ur, gamma, ps, us);
      break;
    case 6:
      roe(rhol, rhor, pl, pr, ul, ur, gamma, ps, us);
      break;
    case 7:
      llxf(rhol, rhor, pl, pr, ul, ur, gamma, ps, us);
      break;
    case 8:
      hllc_ball(rhol, rhor, pl, pr, ul, ur, gamma, ps, us);
      break;
    case 9:
      hll_ball(rhol, rhor, pl, pr, ul, ur, gamma, ps, us);
      break;
    case 10:
      hllsy(rhol, rhor, pl, pr, ul, ur, gamma, ps, us);
      break;
    default:
      ps = us = T(0);
  }
}

}  // namespace riemann
