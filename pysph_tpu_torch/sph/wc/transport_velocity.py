"""Transport Velocity Formulation equations (Adami 2012/2013): port of
``pysph_tpu/sph/wc/transport_velocity.py``, the fluid terms of
``TVFScheme`` (the Taylor-Green vortex) and the wall classes that
``GTVFScheme`` and ``TVFScheme`` emit.  ``ops/tvf_pair.py`` runs the
fluid pair terms on the card."""

import math

import torch

from pysph_tpu_torch.sph.equation import Equation


class SummationDensity(Equation):
    """Summation density and number density: ``V = sum W``, ``rho = m
    sum W``."""

    def initialize(self, d_idx, d_V, d_rho):
        d_V[d_idx] = 0.0
        d_rho[d_idx] = 0.0

    def loop(self, d_idx, d_V, d_rho, d_m, WIJ):
        d_V[d_idx] += WIJ
        d_rho[d_idx] += d_m[d_idx] * WIJ


class VolumeFromMassDensity(Equation):
    """V = rho / m."""

    def loop(self, d_idx, d_V, d_rho, d_m):
        d_V[d_idx] = d_rho[d_idx] / d_m[d_idx]


class ContinuityEquation(Equation):
    """TVF continuity, Adami 2012 eq. (6)."""

    def initialize(self, d_idx, d_arho):
        d_arho[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_arho, s_m, s_rho, d_rho, VIJ, DWIJ):
        vijdotdwij = (VIJ[0] * DWIJ[0] + VIJ[1] * DWIJ[1] +
                      VIJ[2] * DWIJ[2])
        d_arho[d_idx] += (d_rho[d_idx] * vijdotdwij * s_m[s_idx] /
                          s_rho[s_idx])


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


class MomentumEquationPressureGradient(Equation):
    """TVF pressure gradient and background pressure, Adami 2013 eq. (8)
    and (13); the body force, damped over ``tdamp`` from ``t = 0``, is
    added after the loop (``t`` is the stage's, a 0-d device tensor in
    the solver's chunks)."""

    def __init__(self, dest, sources, pb, gx=0., gy=0., gz=0.,
                 tdamp=0.0):
        self.pb = pb
        self.gx = gx
        self.gy = gy
        self.gz = gz
        self.tdamp = tdamp
        super(MomentumEquationPressureGradient, self).__init__(
            dest, sources)

    def initialize(self, d_idx, d_au, d_av, d_aw, d_auhat, d_avhat,
                   d_awhat):
        d_au[d_idx] = 0.0
        d_av[d_idx] = 0.0
        d_aw[d_idx] = 0.0
        d_auhat[d_idx] = 0.0
        d_avhat[d_idx] = 0.0
        d_awhat[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_m, d_rho, s_rho, d_au, d_av, d_aw,
             d_p, s_p, d_auhat, d_avhat, d_awhat, d_V, s_V, DWIJ):
        rhoi = d_rho[d_idx]
        rhoj = s_rho[s_idx]
        pij = (rhoj * d_p[d_idx] + rhoi * s_p[s_idx]) / (rhoj + rhoi)
        Vi = 1.0 / d_V[d_idx]
        Vj = 1.0 / s_V[s_idx]
        Vi2 = Vi * Vi
        Vj2 = Vj * Vj
        mi1 = 1.0 / d_m[d_idx]
        tmp = -pij * mi1 * (Vi2 + Vj2)
        d_au[d_idx] += tmp * DWIJ[0]
        d_av[d_idx] += tmp * DWIJ[1]
        d_aw[d_idx] += tmp * DWIJ[2]
        tmp = -self.pb * mi1 * (Vi2 + Vj2)
        d_auhat[d_idx] += tmp * DWIJ[0]
        d_avhat[d_idx] += tmp * DWIJ[1]
        d_awhat[d_idx] += tmp * DWIJ[2]

    def post_loop(self, d_idx, d_au, d_av, d_aw, t):
        if self.tdamp > 0:
            t = torch.as_tensor(t, dtype=torch.float64)
            damping_factor = torch.where(
                t < self.tdamp,
                0.5 * (torch.sin((-0.5 + t / self.tdamp) * math.pi) + 1.0),
                1.0)
        else:
            damping_factor = 1.0
        d_au[d_idx] += self.gx * damping_factor
        d_av[d_idx] += self.gy * damping_factor
        d_aw[d_idx] += self.gz * damping_factor


class MomentumEquationViscosity(Equation):
    """TVF laminar viscosity, Adami 2013 eq. (8), the third term."""

    def __init__(self, dest, sources, nu):
        self.nu = nu
        super(MomentumEquationViscosity, self).__init__(dest, sources)

    def initialize(self, d_idx, d_au, d_av, d_aw):
        d_au[d_idx] = 0.0
        d_av[d_idx] = 0.0
        d_aw[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_rho, s_rho, d_m, d_V, s_V,
             d_au, d_av, d_aw, R2IJ, EPS, DWIJ, VIJ, XIJ):
        etai = self.nu * d_rho[d_idx]
        etaj = self.nu * s_rho[s_idx]
        etaij = 2 * (etai * etaj) / (etai + etaj)
        Fij = DWIJ[0] * XIJ[0] + DWIJ[1] * XIJ[1] + DWIJ[2] * XIJ[2]
        Vi = 1.0 / d_V[d_idx]
        Vj = 1.0 / s_V[s_idx]
        tmp = (1.0 / d_m[d_idx] * (Vi * Vi + Vj * Vj) * etaij * Fij /
               (R2IJ + EPS))
        d_au[d_idx] += tmp * VIJ[0]
        d_av[d_idx] += tmp * VIJ[1]
        d_aw[d_idx] += tmp * VIJ[2]


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


class MomentumEquationArtificialStress(Equation):
    """TVF artificial stress, Adami 2013 eq. (8), the second term: the
    tensor ``A = rho v (x) (vhat - v)``, its mean over the pair
    contracted with ``DWIJ``."""

    def initialize(self, d_idx, d_au, d_av, d_aw):
        d_au[d_idx] = 0.0
        d_av[d_idx] = 0.0
        d_aw[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_rho, d_u, d_v, d_w, d_V,
             d_uhat, d_vhat, d_what, d_au, d_av, d_aw, d_m,
             s_rho, s_u, s_v, s_w, s_V, s_uhat, s_vhat, s_what, DWIJ):
        rhoi = d_rho[d_idx]
        rhoj = s_rho[s_idx]
        ui, vi, wi = d_u[d_idx], d_v[d_idx], d_w[d_idx]
        dui = d_uhat[d_idx] - ui
        dvi = d_vhat[d_idx] - vi
        dwi = d_what[d_idx] - wi
        uj, vj, wj = s_u[s_idx], s_v[s_idx], s_w[s_idx]
        duj = s_uhat[s_idx] - uj
        dvj = s_vhat[s_idx] - vj
        dwj = s_what[s_idx] - wj
        Ax = 0.5 * ((rhoi * ui * dui + rhoj * uj * duj) * DWIJ[0] +
                    (rhoi * ui * dvi + rhoj * uj * dvj) * DWIJ[1] +
                    (rhoi * ui * dwi + rhoj * uj * dwj) * DWIJ[2])
        Ay = 0.5 * ((rhoi * vi * dui + rhoj * vj * duj) * DWIJ[0] +
                    (rhoi * vi * dvi + rhoj * vj * dvj) * DWIJ[1] +
                    (rhoi * vi * dwi + rhoj * vj * dwj) * DWIJ[2])
        Az = 0.5 * ((rhoi * wi * dui + rhoj * wj * duj) * DWIJ[0] +
                    (rhoi * wi * dvi + rhoj * wj * dvj) * DWIJ[1] +
                    (rhoi * wi * dwi + rhoj * wj * dwj) * DWIJ[2])
        Vi = 1.0 / d_V[d_idx]
        Vj = 1.0 / s_V[s_idx]
        tmp = 1.0 / d_m[d_idx] * (Vi * Vi + Vj * Vj)
        d_au[d_idx] += tmp * Ax
        d_av[d_idx] += tmp * Ay
        d_aw[d_idx] += tmp * Az


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
