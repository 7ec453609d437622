"""Basic WCSPH equations of the main path and of delta-SPH (port of
``pysph_tpu/sph/wc/basic.py``).  ``UpdateSmoothingLengthFerrari``
(``update_h``) and ``PressureGradientUsingNumberDensity`` are not ported
yet (ROADMAP Queue 1 item 28)."""

import torch

from pysph_tpu_torch.sph.equation import MAX, Equation


class TaitEOS(Equation):
    """Tait EOS: p = p0 + B ((rho/rho0)^gamma - 1),
    cs = c0 (rho/rho0)^((gamma-1)/2)."""

    def __init__(self, dest, sources, rho0, c0, gamma, p0=0.0):
        self.rho0 = rho0
        self.rho01 = 1.0 / rho0
        self.c0 = c0
        self.gamma = gamma
        self.gamma1 = 0.5 * (gamma - 1.0)
        self.B = rho0 * c0 * c0 / gamma
        self.p0 = p0
        super(TaitEOS, self).__init__(dest, sources)

    def loop(self, d_idx, d_rho, d_p, d_cs):
        ratio = d_rho[d_idx] * self.rho01
        tmp = ratio ** self.gamma
        d_p[d_idx] = self.p0 + self.B * (tmp - 1.0)
        d_cs[d_idx] = self.c0 * ratio ** self.gamma1


class TaitEOSHGCorrection(Equation):
    """Tait EOS with the Hughes-Graham correction: rho is clamped to at
    least rho0 (for boundaries)."""

    def __init__(self, dest, sources, rho0, c0, gamma):
        self.rho0 = rho0
        self.rho01 = 1.0 / rho0
        self.c0 = c0
        self.gamma = gamma
        self.gamma1 = 0.5 * (gamma - 1.0)
        self.B = rho0 * c0 * c0 / gamma
        super(TaitEOSHGCorrection, self).__init__(dest, sources)

    def loop(self, d_idx, d_rho, d_p, d_cs):
        d_rho[d_idx] = torch.clamp(d_rho[d_idx], min=self.rho0)
        ratio = d_rho[d_idx] * self.rho01
        tmp = ratio ** self.gamma
        d_p[d_idx] = self.B * (tmp - 1.0)
        d_cs[d_idx] = self.c0 * ratio ** self.gamma1


class MomentumEquation(Equation):
    """Monaghan momentum equation with artificial viscosity and, with
    ``tensile_correction``, Monaghan's tensile instability correction;
    also accumulates the per-particle CFL/force timestep factors
    dt_cfl/dt_force."""

    def __init__(self, dest, sources, c0, alpha=1.0, beta=1.0, gx=0.0,
                 gy=0.0, gz=0.0, tensile_correction=False):
        self.alpha = alpha
        self.beta = beta
        self.gx = gx
        self.gy = gy
        self.gz = gz
        self.c0 = c0
        self.tensile_correction = tensile_correction
        super(MomentumEquation, self).__init__(dest, sources)
        # the correction reads WIJ and WDP: only its loop asks for them
        if tensile_correction:
            self.loop = self._loop_tensile

    def initialize(self, d_idx, d_au, d_av, d_aw, d_dt_cfl):
        d_au[d_idx] = 0.0
        d_av[d_idx] = 0.0
        d_aw[d_idx] = 0.0
        d_dt_cfl[d_idx] = 0.0

    def _core(self, d_idx, s_idx, d_rho, d_cs, d_p, s_rho, s_cs, s_p,
              VIJ, XIJ, HIJ, R2IJ, RHOIJ1, RINV, EPS, d_dt_cfl):
        """The pressure terms and the artificial viscosity: returns
        (p_i / rho_i^2, p_j / rho_j^2, piij)."""
        rhoi21 = 1.0 / (d_rho[d_idx] * d_rho[d_idx])
        rhoj21 = 1.0 / (s_rho[s_idx] * s_rho[s_idx])

        vijdotxij = VIJ[0] * XIJ[0] + VIJ[1] * XIJ[1] + VIJ[2] * XIJ[2]

        cij = 0.5 * (d_cs[d_idx] + s_cs[s_idx])
        muij = (HIJ * vijdotxij) / (R2IJ + EPS)
        piij = (-self.alpha * cij * muij +
                self.beta * muij * muij) * RHOIJ1
        piij = torch.where(vijdotxij < 0, piij, 0.0)

        # CFL timestep factor (max-accumulated over neighbours);
        # 1/R2IJ = RINV*RINV
        _dt_cfl = torch.where(
            R2IJ > 1e-12,
            torch.abs(HIJ * vijdotxij) * RINV * RINV + self.c0, 0.0)
        d_dt_cfl[d_idx] = MAX(_dt_cfl, d_dt_cfl[d_idx])

        return d_p[d_idx] * rhoi21, s_p[s_idx] * rhoj21, piij

    def loop(self, d_idx, s_idx, d_rho, d_cs, d_p, d_au, d_av, d_aw,
             s_m, s_rho, s_cs, s_p, VIJ, XIJ, HIJ, R2IJ, RHOIJ1, RINV,
             EPS, DWIJ, d_dt_cfl):
        tmpi, tmpj, piij = self._core(
            d_idx, s_idx, d_rho, d_cs, d_p, s_rho, s_cs, s_p, VIJ, XIJ,
            HIJ, R2IJ, RHOIJ1, RINV, EPS, d_dt_cfl)
        tmp = tmpi + tmpj
        d_au[d_idx] += -s_m[s_idx] * (tmp + piij) * DWIJ[0]
        d_av[d_idx] += -s_m[s_idx] * (tmp + piij) * DWIJ[1]
        d_aw[d_idx] += -s_m[s_idx] * (tmp + piij) * DWIJ[2]

    def _loop_tensile(self, d_idx, s_idx, d_rho, d_cs, d_p, d_au, d_av,
                      d_aw, s_m, s_rho, s_cs, s_p, VIJ, XIJ, HIJ, R2IJ,
                      RHOIJ1, RINV, EPS, DWIJ, WIJ, WDP, d_dt_cfl):
        tmpi, tmpj, piij = self._core(
            d_idx, s_idx, d_rho, d_cs, d_p, s_rho, s_cs, s_p, VIJ, XIJ,
            HIJ, R2IJ, RHOIJ1, RINV, EPS, d_dt_cfl)
        fij = WIJ / WDP
        fij = fij * fij
        fij = fij * fij
        Ri = torch.where(d_p[d_idx] > 0, 0.01 * tmpi, 0.2 * torch.abs(tmpi))
        Rj = torch.where(s_p[s_idx] > 0, 0.01 * tmpj, 0.2 * torch.abs(tmpj))

        tmp = (tmpi + tmpj) + (Ri + Rj) * fij
        d_au[d_idx] += -s_m[s_idx] * (tmp + piij) * DWIJ[0]
        d_av[d_idx] += -s_m[s_idx] * (tmp + piij) * DWIJ[1]
        d_aw[d_idx] += -s_m[s_idx] * (tmp + piij) * DWIJ[2]

    def post_loop(self, d_idx, d_au, d_av, d_aw, d_dt_force):
        d_au[d_idx] += self.gx
        d_av[d_idx] += self.gy
        d_aw[d_idx] += self.gz
        d_dt_force[d_idx] = (d_au[d_idx] * d_au[d_idx] +
                             d_av[d_idx] * d_av[d_idx] +
                             d_aw[d_idx] * d_aw[d_idx])


class MomentumEquationDeltaSPH(Equation):
    """delta-SPH momentum equation, Marrone 2011 eqn (5b) viscous
    term."""

    def __init__(self, dest, sources, rho0, c0, alpha=1.0):
        self.alpha = alpha
        self.c0 = c0
        self.rho0 = rho0
        super(MomentumEquationDeltaSPH, self).__init__(dest, sources)

    def loop(self, d_idx, s_idx, d_rho, d_au, d_av, d_aw, s_m, s_rho,
             VIJ, XIJ, HIJ, R2IJ, EPS, DWIJ):
        Vj = s_m[s_idx] / s_rho[s_idx]
        vijdotxij = VIJ[0] * XIJ[0] + VIJ[1] * XIJ[1] + VIJ[2] * XIJ[2]
        fac = self.alpha * HIJ * self.c0 * self.rho0
        piij = vijdotxij / (R2IJ + EPS)
        tmp = fac * piij * Vj / d_rho[d_idx]
        d_au[d_idx] += tmp * DWIJ[0]
        d_av[d_idx] += tmp * DWIJ[1]
        d_aw[d_idx] += tmp * DWIJ[2]


class ContinuityEquationDeltaSPHPreStep(Equation):
    """Renormalized density gradient, Marrone 2011 eqn (5a); gradrho has
    stride 3."""

    def initialize(self, d_idx, d_gradrho):
        d_gradrho[d_idx * 3 + 0] = 0.0
        d_gradrho[d_idx * 3 + 1] = 0.0
        d_gradrho[d_idx * 3 + 2] = 0.0

    def loop(self, d_idx, s_idx, d_rho, s_rho, s_m, d_gradrho, DWIJ):
        drho = (s_rho[s_idx] - d_rho[d_idx]) * s_m[s_idx] / s_rho[s_idx]
        d_gradrho[d_idx * 3 + 0] += drho * DWIJ[0]
        d_gradrho[d_idx * 3 + 1] += drho * DWIJ[1]
        d_gradrho[d_idx * 3 + 2] += drho * DWIJ[2]


class ContinuityEquationDeltaSPH(Equation):
    """delta-SPH dissipative continuity term, Marrone 2011 eqn (5a)."""

    def __init__(self, dest, sources, c0, delta=0.1):
        self.c0 = c0
        self.delta = delta
        super(ContinuityEquationDeltaSPH, self).__init__(dest, sources)

    def loop(self, d_idx, d_arho, s_idx, s_m, d_rho, s_rho, DWIJ, XIJ,
             R2IJ, HIJ, EPS, d_gradrho, s_gradrho):
        Vj = s_m[s_idx] / s_rho[s_idx]
        fac = -2.0 * (s_rho[s_idx] - d_rho[d_idx]) / (R2IJ + EPS)
        psix = (fac * XIJ[0] - d_gradrho[d_idx * 3 + 0] -
                s_gradrho[s_idx * 3 + 0])
        psiy = (fac * XIJ[1] - d_gradrho[d_idx * 3 + 1] -
                s_gradrho[s_idx * 3 + 1])
        psiz = (fac * XIJ[2] - d_gradrho[d_idx * 3 + 2] -
                s_gradrho[s_idx * 3 + 2])
        psidotdwij = psix * DWIJ[0] + psiy * DWIJ[1] + psiz * DWIJ[2]
        d_arho[d_idx] += self.delta * HIJ * self.c0 * psidotdwij * Vj
