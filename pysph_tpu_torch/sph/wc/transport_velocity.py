"""Transport-velocity wall equations (Adami 2012/2013): the classes of
``pysph_tpu/sph/wc/transport_velocity.py`` that ``GTVFScheme`` emits.
The rest of that module (``SummationDensity``, the TVF momentum and
viscosity terms) comes with taylor_green (ROADMAP Queue 1)."""

import torch

from pysph_tpu_torch.sph.equation import Equation


class VolumeSummation(Equation):
    """Number density V = sum W."""

    def initialize(self, d_idx, d_V):
        d_V[d_idx] = 0.0

    def loop(self, d_idx, d_V, WIJ):
        d_V[d_idx] += WIJ


class SetWallVelocity(Equation):
    """Extrapolate the fluid velocity onto the wall, Adami 2012 eq.
    (22)-(23): ``uf`` is the kernel-weighted fluid velocity, ``ug`` the
    ghost velocity ``2 u - uf``."""

    def initialize(self, d_idx, d_uf, d_vf, d_wf, d_wij):
        d_uf[d_idx] = 0.0
        d_vf[d_idx] = 0.0
        d_wf[d_idx] = 0.0
        d_wij[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_uf, d_vf, d_wf,
             s_u, s_v, s_w, d_wij, WIJ):
        d_wij[d_idx] += WIJ
        d_uf[d_idx] += s_u[s_idx] * WIJ
        d_vf[d_idx] += s_v[s_idx] * WIJ
        d_wf[d_idx] += s_w[s_idx] * WIJ

    def post_loop(self, d_uf, d_vf, d_wf, d_wij, d_idx,
                  d_ug, d_vg, d_wg, d_u, d_v, d_w):
        wij = d_wij[d_idx]
        has = wij > 1e-12
        denom = torch.where(has, wij, 1.0)
        d_uf[d_idx] = torch.where(has, d_uf[d_idx] / denom, d_uf[d_idx])
        d_vf[d_idx] = torch.where(has, d_vf[d_idx] / denom, d_vf[d_idx])
        d_wf[d_idx] = torch.where(has, d_wf[d_idx] / denom, d_wf[d_idx])
        d_ug[d_idx] = 2 * d_u[d_idx] - d_uf[d_idx]
        d_vg[d_idx] = 2 * d_v[d_idx] - d_vf[d_idx]
        d_wg[d_idx] = 2 * d_w[d_idx] - d_wf[d_idx]


class ContinuitySolid(Equation):
    """Continuity contribution of the wall, through its ghost velocity."""

    def loop(self, d_idx, s_idx, d_rho, d_u, d_v, d_w, d_arho,
             s_m, s_rho, s_ug, s_vg, s_wg, DWIJ):
        Vj = s_m[s_idx] / s_rho[s_idx]
        uij = d_u[d_idx] - s_ug[s_idx]
        vij = d_v[d_idx] - s_vg[s_idx]
        wij = d_w[d_idx] - s_wg[s_idx]
        vij_dot_dwij = uij * DWIJ[0] + vij * DWIJ[1] + wij * DWIJ[2]
        d_arho[d_idx] += d_rho[d_idx] * Vj * vij_dot_dwij


class StateEquation(Equation):
    """Generalised weakly-compressible EOS, Adami 2013:
    p = p0 (rho/rho0 - b)."""

    def __init__(self, dest, sources, p0, rho0, b=1.0):
        self.b = b
        self.p0 = p0
        self.rho0 = rho0
        super(StateEquation, self).__init__(dest, sources)

    def loop(self, d_idx, d_p, d_rho):
        d_p[d_idx] = self.p0 * (d_rho[d_idx] / self.rho0 - self.b)


class MomentumEquationArtificialViscosity(Equation):
    """Artificial viscosity, Adami 2012 eq. (11)."""

    def __init__(self, dest, sources, c0, alpha=0.1):
        self.alpha = alpha
        self.c0 = c0
        super(MomentumEquationArtificialViscosity, self).__init__(
            dest, sources)

    def initialize(self, d_idx, d_au, d_av, d_aw):
        d_au[d_idx] = 0.0
        d_av[d_idx] = 0.0
        d_aw[d_idx] = 0.0

    def loop(self, d_idx, s_idx, s_m, d_au, d_av, d_aw,
             RHOIJ1, R2IJ, EPS, DWIJ, VIJ, XIJ, HIJ):
        vijdotrij = (VIJ[0] * XIJ[0] + VIJ[1] * XIJ[1] +
                     VIJ[2] * XIJ[2])
        muij = (HIJ * vijdotrij) / (R2IJ + EPS)
        piij = -self.alpha * self.c0 * muij * s_m[s_idx] * RHOIJ1
        piij = torch.where(vijdotrij < 0, piij, 0.0)
        d_au[d_idx] += -piij * DWIJ[0]
        d_av[d_idx] += -piij * DWIJ[1]
        d_aw[d_idx] += -piij * DWIJ[2]


class SolidWallNoSlipBC(Equation):
    """No-slip wall through the ghost velocities, Adami 2012."""

    def __init__(self, dest, sources, nu):
        self.nu = nu
        super(SolidWallNoSlipBC, self).__init__(dest, sources)

    def initialize(self, d_idx, d_au, d_av, d_aw):
        d_au[d_idx] = 0.0
        d_av[d_idx] = 0.0
        d_aw[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_m, d_rho, s_rho, d_V, s_V,
             d_u, d_v, d_w, d_au, d_av, d_aw, s_ug, s_vg, s_wg,
             DWIJ, R2IJ, EPS, XIJ):
        etai = self.nu * d_rho[d_idx]
        etaj = self.nu * s_rho[s_idx]
        etaij = 2 * (etai * etaj) / (etai + etaj)
        Vi = 1.0 / d_V[d_idx]
        Vj = 1.0 / s_V[s_idx]
        Fij = XIJ[0] * DWIJ[0] + XIJ[1] * DWIJ[1] + XIJ[2] * DWIJ[2]
        tmp = (1.0 / d_m[d_idx] * (Vi * Vi + Vj * Vj) *
               (etaij * Fij / (R2IJ + EPS)))
        d_au[d_idx] += tmp * (d_u[d_idx] - s_ug[s_idx])
        d_av[d_idx] += tmp * (d_v[d_idx] - s_vg[s_idx])
        d_aw[d_idx] += tmp * (d_w[d_idx] - s_wg[s_idx])


class SolidWallPressureBC(Equation):
    """Adami's generalised wall pressure, eq. (27)-(28): the kernel-
    weighted fluid pressure plus the hydrostatic term of the wall's
    acceleration relative to gravity; rho from the EOS."""

    def __init__(self, dest, sources, rho0, p0, b=1.0, gx=0.0, gy=0.0,
                 gz=0.0):
        self.rho0 = rho0
        self.p0 = p0
        self.b = b
        self.gx = gx
        self.gy = gy
        self.gz = gz
        super(SolidWallPressureBC, self).__init__(dest, sources)

    def initialize(self, d_idx, d_p, d_wij):
        d_p[d_idx] = 0.0
        d_wij[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_p, s_p, d_wij, s_rho,
             d_au, d_av, d_aw, WIJ, XIJ):
        gdotxij = ((self.gx - d_au[d_idx]) * XIJ[0] +
                   (self.gy - d_av[d_idx]) * XIJ[1] +
                   (self.gz - d_aw[d_idx]) * XIJ[2])
        d_p[d_idx] += s_p[s_idx] * WIJ + s_rho[s_idx] * gdotxij * WIJ
        d_wij[d_idx] += WIJ

    def post_loop(self, d_idx, d_wij, d_p, d_rho):
        has = d_wij[d_idx] > 1e-14
        denom = torch.where(has, d_wij[d_idx], 1.0)
        d_p[d_idx] = torch.where(has, d_p[d_idx] / denom, d_p[d_idx])
        d_rho[d_idx] = self.rho0 * (d_p[d_idx] / self.p0 + self.b)
