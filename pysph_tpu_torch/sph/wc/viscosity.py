"""Viscosity equations (port of ``pysph_tpu/sph/wc/viscosity.py``).

``LaminarViscosity`` is ``wcsph_pair``'s and ``dense_pair``'s ``VISC``
term; a pair phase that holds one of the others runs on the torch pair
engine.  ``WCSPHScheme`` uses ``LaminarViscosity`` and
``LaminarViscosityDeltaSPH`` where ``nu != 0``.
"""

from pysph_tpu_torch.sph.equation import Equation


class LaminarViscosity(Equation):
    """Morris-style laminar viscosity."""

    def __init__(self, dest, sources, nu, eta=0.01):
        self.nu = nu
        self.eta = eta
        super(LaminarViscosity, self).__init__(dest, sources)

    def loop(self, d_idx, s_idx, s_m, d_rho, s_rho, d_au, d_av, d_aw,
             DWIJ, XIJ, VIJ, R2IJ, HIJ):
        Fij = DWIJ[0] * XIJ[0] + DWIJ[1] * XIJ[1] + DWIJ[2] * XIJ[2]
        tmp = s_m[s_idx] * 4 * self.nu * Fij / (
            (d_rho[d_idx] + s_rho[s_idx]) *
            (R2IJ + self.eta * HIJ * HIJ))
        d_au[d_idx] += tmp * VIJ[0]
        d_av[d_idx] += tmp * VIJ[1]
        d_aw[d_idx] += tmp * VIJ[2]


class MonaghanSignalViscosityFluids(Equation):
    """Signal-based viscosity."""

    def __init__(self, dest, sources, alpha, h):
        self.alpha = 0.125 * alpha * h
        super(MonaghanSignalViscosityFluids, self).__init__(dest, sources)

    def loop(self, d_idx, s_idx, d_rho, s_rho, s_m, d_au, d_av, d_aw,
             d_cs, s_cs, RIJ, HIJ, VIJ, XIJ, DWIJ):
        nua = self.alpha * d_cs[d_idx]
        nub = self.alpha * s_cs[s_idx]
        vabdotrab = VIJ[0] * XIJ[0] + VIJ[1] * XIJ[1] + VIJ[2] * XIJ[2]
        eta = nua * nub / (nua * d_rho[d_idx] + nub * s_rho[s_idx])
        force = -16 * eta * vabdotrab / (HIJ * (RIJ + 0.01 * HIJ * HIJ))
        d_au[d_idx] += -s_m[s_idx] * force * DWIJ[0]
        d_av[d_idx] += -s_m[s_idx] * force * DWIJ[1]
        d_aw[d_idx] += -s_m[s_idx] * force * DWIJ[2]


class ClearyArtificialViscosity(Equation):
    """Cleary's artificial viscosity, Monaghan 2005 eq. (8.2, 8.8-8.9)."""

    def __init__(self, dest, sources, dim, alpha=1.0):
        self.alpha = alpha
        self.factor = 20.0 if dim == 3 else 16.0
        super(ClearyArtificialViscosity, self).__init__(dest, sources)

    def initialize(self, d_idx, d_au, d_av, d_aw):
        d_au[d_idx] = 0.0
        d_av[d_idx] = 0.0
        d_aw[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_m, s_m, d_rho, s_rho, d_h, s_h,
             d_cs, s_cs, d_au, d_av, d_aw, XIJ, VIJ, R2IJ, EPS, DWIJ):
        mua = 0.125 * self.alpha * d_h[d_idx] * d_cs[d_idx] * d_rho[d_idx]
        mub = 0.125 * self.alpha * s_h[s_idx] * s_cs[s_idx] * s_rho[s_idx]
        dot = VIJ[0] * XIJ[0] + VIJ[1] * XIJ[1] + VIJ[2] * XIJ[2]
        eta = mua * mub / (d_rho[d_idx] * s_rho[s_idx] * (mua + mub))
        piab = -s_m[s_idx] * self.factor * eta * (dot / (R2IJ + EPS))
        d_au[d_idx] += piab * DWIJ[0]
        d_av[d_idx] += piab * DWIJ[1]
        d_aw[d_idx] += piab * DWIJ[2]


class LaminarViscosityDeltaSPH(Equation):
    """Laminar viscosity in delta-SPH form, Sun 2017 section 2."""

    def __init__(self, dest, sources, dim, rho0, nu):
        self.dim = dim
        self.rho0 = rho0
        self.nu = nu
        super(LaminarViscosityDeltaSPH, self).__init__(dest, sources)

    def loop(self, d_idx, s_idx, s_m, s_rho, d_rho, d_au, d_av, d_aw,
             HIJ, DWIJ, R2IJ, EPS, VIJ, XIJ):
        Vj = s_m[s_idx] / s_rho[s_idx]
        vdotxij = VIJ[0] * XIJ[0] + VIJ[1] * XIJ[1] + VIJ[2] * XIJ[2]
        piij = vdotxij / (R2IJ + EPS)
        fac = (2 * (self.dim + 2) * self.nu * self.rho0 * piij * Vj /
               d_rho[d_idx])
        d_au[d_idx] += fac * DWIJ[0]
        d_av[d_idx] += fac * DWIJ[1]
        d_aw[d_idx] += fac * DWIJ[2]
