"""Exact solution of the 1D Riemann problem (Toro, 'Riemann Solvers
and Numerical Methods for Fluid Dynamics', Springer 2009, ch. 4).

A copy of ``pysph_tpu/examples/gas_dynamics/riemann_solver.py`` (numpy
only): ``set_gamma`` and ``solve``, which returns the density, velocity,
pressure, energy and the sample coordinates.  The star state is found by
Newton iteration on the pressure function, then every x/t ray is
classified at once with numpy masks.
"""

import numpy

gamma = 1.4


def set_gamma(g):
    global gamma
    gamma = float(g)


def _f_K(p, rho_K, p_K, c_K):
    """Toro eq. 4.6/4.7: the flux function for one side and its
    derivative, valid for both shock (p > p_K) and rarefaction."""
    A = 2.0 / ((gamma + 1) * rho_K)
    B = (gamma - 1) / (gamma + 1) * p_K
    shock = p > p_K
    sq = numpy.sqrt(A / (p + B))
    f_s = (p - p_K) * sq
    df_s = sq * (1 - 0.5 * (p - p_K) / (B + p))
    pr = numpy.maximum(p / p_K, 1e-30)
    ex = (gamma - 1) / (2.0 * gamma)
    f_r = 2 * c_K / (gamma - 1) * (pr ** ex - 1.0)
    df_r = 1.0 / (rho_K * c_K) * pr ** (-(gamma + 1) /
                                        (2 * gamma))
    return (numpy.where(shock, f_s, f_r),
            numpy.where(shock, df_s, df_r))


def star_pu(rho_l, u_l, p_l, c_l, rho_r, u_r, p_r, c_r,
            tol=1e-12, max_iter=100):
    """Star-region pressure/velocity by Newton-Raphson (Toro 4.3.2)."""
    du = u_r - u_l
    # two-rarefaction initial guess (robust for all wave patterns)
    ex = (gamma - 1) / (2.0 * gamma)
    p = ((c_l + c_r - 0.5 * (gamma - 1) * du) /
         (c_l / p_l ** ex + c_r / p_r ** ex)) ** (1.0 / ex)
    p = max(float(p), 1e-10)
    for _ in range(max_iter):
        f_l, df_l = _f_K(p, rho_l, p_l, c_l)
        f_r, df_r = _f_K(p, rho_r, p_r, c_r)
        f = f_l + f_r + du
        df = df_l + df_r
        p_new = p - f / df
        if p_new < 0:
            p_new = tol
        if abs(p_new - p) < tol * 0.5 * (p_new + p):
            p = p_new
            break
        p = p_new
    f_l, _ = _f_K(p, rho_l, p_l, c_l)
    f_r, _ = _f_K(p, rho_r, p_r, c_r)
    u = 0.5 * (u_l + u_r) + 0.5 * (f_r - f_l)
    return float(p), float(u)


def _sample_side(s, p_star, u_star, rho_K, u_K, p_K, c_K, sign):
    """Sample one side of the contact (sign=-1 left, +1 right).

    ``s`` is the array of x/t speeds on this side.  Returns
    (rho, u, p) arrays (Toro 4.5)."""
    gm1_gp1 = (gamma - 1.0) / (gamma + 1.0)
    ratio = p_star / p_K
    if p_star > p_K:  # shock
        S_K = u_K + sign * c_K * numpy.sqrt(
            (gamma + 1) / (2 * gamma) * ratio +
            (gamma - 1) / (2 * gamma))
        rho_star = rho_K * ((ratio + gm1_gp1) /
                            (gm1_gp1 * ratio + 1.0))
        ahead = sign * (s - S_K) > 0
        rho = numpy.where(ahead, rho_K, rho_star)
        u = numpy.where(ahead, u_K, u_star)
        p = numpy.where(ahead, p_K, p_star)
    else:  # rarefaction
        c_star = c_K * ratio ** ((gamma - 1) / (2 * gamma))
        S_H = u_K + sign * c_K       # head
        S_T = u_star + sign * c_star  # tail
        ahead = sign * (s - S_H) > 0
        inside = ~ahead & (sign * (s - S_T) > 0)
        # fan interior (Toro 4.56/4.63)
        fac = (2.0 / (gamma + 1) - sign * gm1_gp1 *
               (u_K - s) / c_K)
        fac = numpy.maximum(fac, 1e-12)
        rho_fan = rho_K * fac ** (2.0 / (gamma - 1))
        u_fan = (2.0 / (gamma + 1)) * (
            -sign * c_K + 0.5 * (gamma - 1) * u_K + s)
        p_fan = p_K * fac ** (2.0 * gamma / (gamma - 1))
        rho_star_r = rho_K * ratio ** (1.0 / gamma)
        rho = numpy.where(ahead, rho_K,
                          numpy.where(inside, rho_fan, rho_star_r))
        u = numpy.where(ahead, u_K, numpy.where(inside, u_fan,
                                                u_star))
        p = numpy.where(ahead, p_K, numpy.where(inside, p_fan,
                                                p_star))
    return rho, u, p


def solve(x_min=-0.5, x_max=0.5, x_0=0.0, t=0.1, p_l=1.0, p_r=0.1,
          rho_l=1.0, rho_r=0.125, u_l=0.0, u_r=0.0, N=101):
    """Exact solution sampled on N points at time t.

    Returns (density, velocity, pressure, energy, x) — the same
    order as the reference utility.  Defaults are the Sod tube."""
    assert x_min <= x_0 <= x_max, "discontinuity not in domain"
    c_l = numpy.sqrt(gamma * p_l / rho_l)
    c_r = numpy.sqrt(gamma * p_r / rho_r)
    p_star, u_star = star_pu(rho_l, u_l, p_l, c_l,
                             rho_r, u_r, p_r, c_r)
    x = numpy.linspace(x_min, x_max, N)
    s = (x - x_0) / max(t, 1e-300)
    left = s <= u_star
    rho = numpy.empty_like(x)
    u = numpy.empty_like(x)
    p = numpy.empty_like(x)
    rho_L, u_L, p_L = _sample_side(s, p_star, u_star, rho_l, u_l,
                                   p_l, c_l, sign=-1)
    rho_R, u_R, p_R = _sample_side(s, p_star, u_star, rho_r, u_r,
                                   p_r, c_r, sign=+1)
    rho = numpy.where(left, rho_L, rho_R)
    u = numpy.where(left, u_L, u_R)
    p = numpy.where(left, p_L, p_R)
    e = p / ((gamma - 1) * rho)
    return rho, u, p, e, x


if __name__ == '__main__':
    set_gamma(1.4)
    rho, u, p, e, x = solve()
    print('p_star/u_star sampled at t=0.1 over', len(x), 'points')
