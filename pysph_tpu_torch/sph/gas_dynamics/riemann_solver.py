"""Riemann solvers for Godunov SPH (port of
``pysph_tpu/sph/gas_dynamics/riemann_solver.py``).

Every solver is an elementwise torch function ``solver(rhol, rhor, pl, pr,
ul, ur, gamma, niter, tol) -> (pstar, ustar)`` on tensors of one shape
(or Python floats, which broadcast).  The iterative solvers (van Leer,
exact) run exactly ``niter`` Newton trips, as the JAX package's
``fori_loop``: they do not stop early, and a converged lane's update
vanishes.  ``tol`` is unused, as there.  ``csrc/riemann.cuh`` holds the
same eleven solvers for the card, in the same operations.
"""

import torch

SMALLP = 1e-25


def _t(x, like):
    """``x`` as a tensor of ``like``'s dtype and device (a Python float
    broadcasts)."""
    return x if torch.is_tensor(x) else torch.full_like(like, x)


def _sign(x, y):
    """abs(x) carrying the sign of y."""
    return torch.where(y >= 0, torch.abs(x), -torch.abs(x))


def non_diffusive(rhol, rhor, pl, pr, ul, ur, gamma=1.4, niter=20,
                  tol=1e-6):
    return 0.5 * (pl + pr), 0.5 * (ul + ur)


def van_leer(rhol, rhor, pl, pr, ul, ur, gamma=1.4, niter=20, tol=1e-6):
    """Van Leer's iterative solver."""
    gamma2 = 1.0 + gamma
    gamma1 = 0.5 * gamma2 / gamma
    Vl = 1.0 / rhol
    Vr = 1.0 / rhor
    cl = torch.sqrt(gamma * pl * rhol)
    cr = torch.sqrt(gamma * pr * rhor)
    pstar = pl + (pr - pl - cr * (ur - ul)) * cl / (cl + cr)
    pstar = torch.clamp(pstar, min=SMALLP)
    wl, wr = cl, cr
    for _ in range(int(niter)):
        wl = cl * torch.sqrt(torch.clamp(
            1.0 + gamma1 * (pstar - pl) / pl, min=SMALLP))
        wr = cr * torch.sqrt(torch.clamp(
            1.0 + gamma1 * (pstar - pr) / pr, min=SMALLP))
        zl = 4.0 * Vl * wl * wl
        zl = -zl * wl / (zl - gamma2 * (pstar - pl))
        zr = 4.0 * Vr * wr * wr
        zr = zr * wr / (zr - gamma2 * (pstar - pr))
        ustar_l = ul - (pstar - pl) / wl
        ustar_r = ur + (pstar - pr) / wr
        pstar = pstar + (ustar_r - ustar_l) * (zl * zr) / (zr - zl)
        pstar = torch.clamp(pstar, min=SMALLP)
    ustar_l = ul - (pstar - pl) / wl
    ustar_r = ur + (pstar - pr) / wr
    ustar = 0.5 * (ustar_l + ustar_r)
    bad = (rhol < 0) | (rhor < 0) | (pl < 0) | (pr < 0)
    return (torch.where(bad, 0.0, pstar), torch.where(bad, 0.0, ustar))


def _prefun_exact(p, dk, pk, ck, g1, g2, g4, g5, g6):
    """f and f' of the exact solver's pressure function for one side."""
    pratio = p / pk
    f_rare = g4 * ck * (pratio ** g1 - 1.0)
    fd_rare = (1.0 / (dk * ck)) * pratio ** (-g2)
    ak = g5 / dk
    bk = g6 * pk
    qrt = torch.sqrt(ak / (bk + p))
    f_shock = (p - pk) * qrt
    fd_shock = (1.0 - 0.5 * (p - pk) / (bk + p)) * qrt
    rare = p <= pk
    return (torch.where(rare, f_rare, f_shock),
            torch.where(rare, fd_rare, fd_shock))


def _exact_constants(gamma):
    tmp1 = 1.0 / (2 * gamma)
    tmp2 = 1.0 / (gamma - 1.0)
    tmp3 = 1.0 / (gamma + 1.0)
    return ((gamma - 1.0) * tmp1, (gamma + 1.0) * tmp1, 2 * gamma * tmp2,
            2 * tmp2, 2 * tmp3, tmp3 / tmp2, 0.5 * (gamma - 1.0))


def exact(rhol, rhor, pl, pr, ul, ur, gamma=1.4, niter=20, tol=1e-6):
    """Toro's exact Riemann solver: the PVRS, two-rarefaction or
    two-shock guess, then ``niter`` Newton trips."""
    g1, g2, g3, g4, g5, g6, g7 = _exact_constants(gamma)
    cl = torch.sqrt(gamma * pl / rhol)
    cr = torch.sqrt(gamma * pr / rhor)

    cup = 0.25 * (rhol + rhor) * (cl + cr)
    ppv = torch.clamp(0.5 * (pl + pr) + 0.5 * (ul - ur) * cup, min=0.0)
    pmin = torch.minimum(pl, pr)
    pmax = torch.maximum(pl, pr)
    qmax = pmax / pmin
    pq = (pl / pr) ** g1
    um_g = (pq * ul / cl + ur / cr + g4 * (pq - 1.0)) / \
        (pq / cl + 1.0 / cr)
    ptl = 1.0 + g7 * (ul - um_g) / cl
    ptr = 1.0 + g7 * (um_g - ur) / cr
    pm_rare = 0.5 * (pl * torch.clamp(ptl, min=SMALLP) ** g3 +
                     pr * torch.clamp(ptr, min=SMALLP) ** g3)
    gel = torch.sqrt((g5 / rhol) / (g6 * pl + ppv))
    ger = torch.sqrt((g5 / rhor) / (g6 * pr + ppv))
    pm_shock = (gel * pl + ger * pr - (ur - ul)) / (gel + ger)
    pm = torch.where((qmax <= 2.0) & (pmin <= ppv) & (ppv <= pmax), ppv,
                     torch.where(ppv < pmin, pm_rare, pm_shock))
    p = torch.clamp(pm, min=SMALLP)
    udiff = ur - ul
    for _ in range(int(niter)):
        fl, fld = _prefun_exact(p, rhol, pl, cl, g1, g2, g4, g5, g6)
        fr, frd = _prefun_exact(p, rhor, pr, cr, g1, g2, g4, g5, g6)
        p = torch.clamp(p - (fl + fr + udiff) / (fld + frd), min=SMALLP)
    fl, _ = _prefun_exact(p, rhol, pl, cl, g1, g2, g4, g5, g6)
    fr, _ = _prefun_exact(p, rhor, pr, cr, g1, g2, g4, g5, g6)
    um = 0.5 * (ul + ur + fr - fl)
    # vacuum generation: the reference returns an error code
    vacuum = g4 * (cl + cr) <= (ur - ul)
    return torch.where(vacuum, 0.0, p), torch.where(vacuum, 0.0, um)


def ducowicz(rhol, rhor, pl, pr, ul, ur, gamma=1.4, niter=20, tol=1e-6):
    """Ducowicz's approximate solver."""
    al = 0.5 * (gamma + 1.0)
    ar = 0.5 * (gamma + 1.0)
    csl = torch.sqrt(gamma * pl * rhol)
    csr = torch.sqrt(gamma * pr * rhor)
    umin = ur - 0.5 * csr / ar
    umax = ul + 0.5 * csl / al
    plmin = pl - 0.25 * rhol * csl * csl / al
    prmin = pr - 0.25 * rhor * csr * csr / ar
    bl = rhol * al
    br = rhor * ar
    a = (br - bl) * (prmin - plmin)
    b = br * umin * umin - bl * umax * umax
    c = br * umin - bl * umax
    d = br * bl * (umin - umax) * (umin - umax)

    ddA = torch.sqrt(torch.clamp(d - a, min=0.0))
    uA = (b + prmin - plmin) / (c - _sign(ddA, umax - umin))
    okA = ((uA - umin) >= 0.0) & ((uA - umax) <= 0.0)
    ddB = torch.sqrt(torch.clamp(d + a, min=0.0))
    uB = (b - prmin + plmin) / (c - _sign(ddB, umax - umin))
    okB = ((uB - umin) <= 0.0) & ((uB - umax) >= 0.0)
    a2 = (bl + br) * (plmin - prmin)
    b2 = bl * umax + br * umin
    c2 = 1.0 / (bl + br)
    ddC = torch.sqrt(torch.clamp(a2 - d, min=0.0))
    uC = (b2 + ddC) * c2
    okC = ((uC - umin) >= 0.0) & ((uC - umax) >= 0.0)
    ddD = torch.sqrt(torch.clamp(-a2 - d, min=0.0))
    uD = (b2 - ddD) * c2
    ustar = torch.where(okA, uA,
                        torch.where(okB, uB, torch.where(okC, uC, uD)))
    pstar = 0.5 * (plmin + prmin +
                   br * torch.abs(ustar - umin) * (ustar - umin) -
                   bl * torch.abs(ustar - umax) * (ustar - umax))
    return torch.clamp(pstar, min=0.0), ustar


def roe(rhol, rhor, pl, pr, ul, ur, gamma=1.4, niter=20, tol=1e-6):
    """Roe's approximate solver."""
    rrhol = torch.sqrt(rhol)
    rrhor = torch.sqrt(rhor)
    denominator = 1.0 / (rrhor + rrhol)
    plr = (rrhol * pl + rrhor * pr) * denominator
    vlr = (rrhol / rhol + rrhor / rhor) * denominator
    ulr = (rrhol * ul + rrhor * ur) * denominator
    cslr = torch.sqrt(gamma * plr / vlr)
    cslr1 = 1.0 / cslr
    pstar = plr - 0.5 * (ur - ul) * cslr
    ustar = ulr - 0.5 * (pr - pl) * cslr1
    return pstar, ustar


def llxf(rhol, rhor, pl, pr, ul, ur, gamma=1.4, niter=20, tol=1e-6):
    """Local Lax-Friedrichs."""
    gamma1 = 1.0 / (gamma - 1.0)
    csl = torch.sqrt(gamma * pl * rhol)
    csr = torch.sqrt(gamma * pr * rhor)
    cslr = torch.maximum(csr, csl)
    El = pl * gamma1 / rhol + 0.5 * ul * ul
    Er = pr * gamma1 / rhor + 0.5 * ur * ur
    pstar = 0.5 * (pl + pr - cslr * (ur - ul))
    ustar = (0.5 * ((pl * ul + pr * ur) - cslr * (Er - El))) / pstar
    return pstar, ustar


def hllc(rhol, rhor, pl, pr, ul, ur, gamma=1.4, niter=20, tol=1e-6):
    """HLLC."""
    gamma1 = 1.0 / (gamma - 1.0)
    rrhol = torch.sqrt(rhol)
    rrhor = torch.sqrt(rhor)
    ulr = (rrhol * ul + rrhor * ur) / (rrhol + rrhor)
    vl = ul - ulr
    vr = ur - ulr
    csl = torch.sqrt(gamma * pl / rhol)
    csr = torch.sqrt(gamma * pr / rhor)
    cslr = (rrhol * csl + rrhor * csr) / (rrhol + rrhor)
    sl = torch.minimum(vl - csl, -cslr)
    sr = torch.maximum(vr + csr, cslr)
    sm = (rhor * vr * (sr - vr) - rhol * vl * (sl - vl) + pl - pr) / \
        (rhor * (sr - vr) - rhol * (sl - vl))
    phat = rhol * (vl - sl) * (vl - sm) + pl
    El = rhol * (pl * gamma1 / rhol + 0.5 * ul * ul)
    Er = rhor * (pr * gamma1 / rhor + 0.5 * ur * ur)
    Ml = rhol * ul
    Mr = rhor * ur

    def star(s_, v_, M_, E_, p_):
        m = 1.0 / (s_ - sm) * ((s_ - v_) * M_ + (phat - p_))
        e = 1.0 / (s_ - sm) * ((s_ - v_) * E_ - p_ * v_ + phat * sm)
        ps = sm * m + phat
        us = (sm * e + (sm + ulr) * phat) / ps
        return ps, us

    psl, usl = star(sl, vl, Ml, El, pl)
    psr, usr = star(sr, vr, Mr, Er, pr)
    pstar = torch.where(sl > 0, pl,
                        torch.where(sm > 0, psl,
                                    torch.where(sr > 0, psr, pr)))
    ustar = torch.where(sl > 0, ul,
                        torch.where(sm > 0, usl,
                                    torch.where(sr > 0, usr, ur)))
    return pstar, ustar


def hllc_ball(rhol, rhor, pl, pr, ul, ur, gamma=1.4, niter=20, tol=1e-6):
    """HLLC with Ball's wave speeds."""
    gamma1 = 0.5 * (gamma + 1.0) / gamma
    csl = torch.sqrt(gamma * pl / rhol)
    csr = torch.sqrt(gamma * pr / rhor)
    cslr = 0.5 * (csl + csr)
    rholr = 0.5 * (rhol + rhor)
    pstar = 0.5 * (pl + pr - rholr * cslr * (ur - ul))
    ustar = 0.5 * (ul + ur - 1.0 / (rholr * cslr) * (pr - pl))
    Hl = pstar / pl
    Hr = pstar / pr
    ql = torch.where(Hl > 1, torch.sqrt(1 + gamma1 * (Hl - 1.0)), 1.0)
    qr = torch.where(Hr > 1, torch.sqrt(1 + gamma1 * (Hr - 1.0)), 1.0)
    Sl = ul - csl * ql
    Sr = ur + csr * qr
    pstar_l = pl + rhol * (ul - Sl) * (ul - ustar)
    pstar_r = pr + rhor * (ur - Sr) * (ur - ustar)
    pstar = 0.5 * (pstar_l + pstar_r)
    return pstar, ustar


def hlle(rhol, rhor, pl, pr, ul, ur, gamma=1.4, niter=20, tol=1e-6):
    """HLLE."""
    gamma1 = 1.0 / (gamma - 1.0)
    rrhol = torch.sqrt(rhol)
    rrhor = torch.sqrt(rhor)
    csl = torch.sqrt(gamma * pl * rhol)
    csr = torch.sqrt(gamma * pr * rhor)
    cslr = (rrhol * csl + rrhor * csr) / (rrhol + rrhor)
    sl = torch.minimum(ul - csl, -cslr)
    sr = torch.maximum(ur + csr, cslr)
    smax = torch.maximum(sl, sr)
    smin = torch.minimum(sl, sr)
    El = pl * gamma1 / rhol + 0.5 * ul * ul
    Er = pr * gamma1 / rhor + 0.5 * ur * ur
    pstar = ((smax * pl - smin * pr) / (smax - smin) +
             smax * smin / (smax - smin) * (ur - ul))
    ustar = ((smax * pl * ul - smin * pr * ur) / (smax - smin) +
             smax * smin / (smax - smin) * (Er - El))
    return pstar, ustar / pstar


def hll_ball(rhol, rhor, pl, pr, ul, ur, gamma=1.4, niter=20, tol=1e-6):
    """HLL with Ball's wave speeds."""
    rrhol = torch.sqrt(rhol)
    rrhor = torch.sqrt(rhor)
    denominator = 1.0 / (rrhor + rrhol)
    csl = torch.sqrt(gamma * pl / rhol)
    csr = torch.sqrt(gamma * pr / rhor)
    eta = 0.5 * (gamma - 1.0) * (rrhor * rrhol) * denominator * \
        denominator
    betal = torch.abs(ul)
    betar = torch.abs(ur)
    ulr = (rrhol * ul + rrhor * ur) / (rrhol * rrhor)
    cslr2 = (rrhol * csl * csl + rrhor * csr * csr) / (rrhol * rrhor)
    cslr = torch.sqrt(cslr2 + eta * (betar - betal) * (betar - betal))
    Sl = torch.minimum(ulr - cslr, ul - csl)
    Sr = torch.maximum(ulr + cslr, ur + csr)
    ustar = ((Sr * Sl * (rhor - rhol) + rhol * ul * Sr -
              rhor * ur * Sl) /
             (rhol * (ul - Sl) + rhor * (Sr - ur)))
    pstar = (pr * (ustar - Sl) - pl * (ustar - Sr) +
             rhor * ur * (ustar - Sl) * (ur - Sr) -
             rhol * ul * (ustar - Sr) * (ul - Sl)) / (Sr - Sl)
    return pstar, ustar


def hllsy(rhol, rhor, pl, pr, ul, ur, gamma=1.4, niter=20, tol=1e-6):
    """The HLL solver of Sirotkin and Yoh (2013)."""
    gamma1 = 1.0 / (gamma - 1.0)
    rrhol = torch.sqrt(rhol)
    rrhor = torch.sqrt(rhor)
    denominator = 1.0 / (rrhor + rrhol)
    csl = torch.sqrt(gamma * pl * rhol)
    csr = torch.sqrt(gamma * pr * rhor)
    cslr = denominator * (rrhol * csl + rrhor * csr)
    bl = torch.maximum(csl, cslr)
    br = torch.maximum(csr, cslr)
    wl = br / (bl + br)
    wr = bl / (bl + br)
    wlr = bl * br / (bl + br)
    El = pl * gamma1 / rhol + 0.5 * ul * ul
    Er = pr * gamma1 / rhor + 0.5 * ur * ur
    pstar = wl * pl + wr * pr - wlr * (ur - ul)
    ustar = (wl * (pl * ul) + wr * (pr * ur) - wlr * (Er - El)) / pstar
    return pstar, ustar


SOLVERS = {
    0: non_diffusive, 1: van_leer, 2: exact, 3: hllc, 4: ducowicz,
    5: hlle, 6: roe, 7: llxf, 8: hllc_ball, 9: hll_ball, 10: hllsy,
}


def riemann_solve(method, rhol, rhor, pl, pr, ul, ur, gamma=1.4,
                  niter=20, tol=1e-6):
    """The solver of id ``method`` (``SOLVERS``) on tensors; an unknown id
    raises ``ValueError``.  Python floats among the states take the dtype
    and device of the first tensor among them."""
    solver = SOLVERS.get(int(method))
    if solver is None:
        raise ValueError('riemann_solve: no Riemann solver %r (0-10)'
                         % (method,))
    states = (rhol, rhor, pl, pr, ul, ur)
    like = next((s for s in states if torch.is_tensor(s)), None)
    if like is None:
        like = torch.zeros((), dtype=torch.float64)
    return solver(*[_t(s, like) for s in states], gamma, niter, tol)


HELPERS = list(SOLVERS.values())
