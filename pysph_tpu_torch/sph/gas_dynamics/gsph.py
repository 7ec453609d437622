"""Godunov SPH (port of ``pysph_tpu/sph/gas_dynamics/gsph.py``):
Inutsuka's I02 scheme and the Iwasaki-Inutsuka (IwIn) monotonicity
variant.

- ``GSPHGradients``: the gradients of p, u, v and w (12 sums of DWI at
  the dest's h) for the linear reconstruction;
- ``GSPHUpdateGhostProps``: a no-op (the periodic grid makes no ghost
  particles);
- ``GSPHAcceleration``: a Riemann problem along each pair's line
  (``riemann_solver.py``, one of 11 solvers), its reconstructed left
  (source) and right (dest) states from the gradients under the
  ``monotonicity`` limiter (0 first order, 1 I02, 2 IwIn), the
  specific-volume integrals of ``interpolation`` (0 delta, 1 linear, 2
  cubic), the hybrid blend with the HLL solver of Sirotkin and Yoh, and
  the ADKE-style thermal conduction where ``g1`` or ``g2`` is set.

The pair branches (``if RIJ < eps``) are ``torch.where`` masks, as the
JAX package's.  The loop reads the step's ``dt`` (the reconstruction's
time centring) and ``t`` (the hybrid blend) as given: Python floats or,
in the solver's chunks, 0-d tensors on the device.  On the kernel engine
both pair sets run in ``gsph_pair`` (``ops/gsph_pair.py``), in the same
IEEE operations.
"""

import math

import torch

from pysph_tpu_torch.sph.equation import Equation
from pysph_tpu_torch.sph.gas_dynamics.riemann_solver import riemann_solve

# interpolation kinds
Delta = 0
Linear = 1
Cubic = 2


def sgn(x):
    """The sign of x, 0 at 0 (``torch.sign``, as ``jnp.sign``)."""
    return torch.sign(x)


def monotonicity_min(x1, x2, x3):
    """min(2|x1|, |x2|, 2|x3|) with the common sign of the three, 0 where
    their signs differ (a 0 among them has sign 0)."""
    a1 = 2.0 * torch.abs(x1)
    a2 = torch.abs(x2)
    a3 = 2.0 * torch.abs(x3)
    s1, s2, s3 = sgn(x1), sgn(x2), sgn(x3)
    m = torch.minimum(torch.minimum(a1, a2), a3)
    same = (s1 == s2) & (s2 == s3)
    return torch.where(same, s1 * m, 0.0)


class GSPHGradients(Equation):
    """The pressure and velocity gradients of the reconstruction."""

    def initialize(self, d_idx, d_px, d_py, d_pz, d_ux, d_uy, d_uz,
                   d_vx, d_vy, d_vz, d_wx, d_wy, d_wz):
        d_px[d_idx] = 0.0
        d_py[d_idx] = 0.0
        d_pz[d_idx] = 0.0
        d_ux[d_idx] = 0.0
        d_uy[d_idx] = 0.0
        d_uz[d_idx] = 0.0
        d_vx[d_idx] = 0.0
        d_vy[d_idx] = 0.0
        d_vz[d_idx] = 0.0
        d_wx[d_idx] = 0.0
        d_wy[d_idx] = 0.0
        d_wz[d_idx] = 0.0

    def loop(self, d_idx, d_px, d_py, d_pz, d_ux, d_uy, d_uz,
             d_vx, d_vy, d_vz, d_wx, d_wy, d_wz, d_p, d_u, d_v, d_w,
             s_idx, s_p, s_u, s_v, s_w, s_rho, s_m, DWI):
        rj1 = 1.0 / s_rho[s_idx]
        pji = s_p[s_idx] - d_p[d_idx]
        uji = s_u[s_idx] - d_u[d_idx]
        vji = s_v[s_idx] - d_v[d_idx]
        wji = s_w[s_idx] - d_w[d_idx]

        tmp = rj1 * s_m[s_idx] * pji
        d_px[d_idx] += tmp * DWI[0]
        d_py[d_idx] += tmp * DWI[1]
        d_pz[d_idx] += tmp * DWI[2]

        tmp = rj1 * s_m[s_idx] * uji
        d_ux[d_idx] += tmp * DWI[0]
        d_uy[d_idx] += tmp * DWI[1]
        d_uz[d_idx] += tmp * DWI[2]

        tmp = rj1 * s_m[s_idx] * vji
        d_vx[d_idx] += tmp * DWI[0]
        d_vy[d_idx] += tmp * DWI[1]
        d_vz[d_idx] += tmp * DWI[2]

        tmp = rj1 * s_m[s_idx] * wji
        d_wx[d_idx] += tmp * DWI[0]
        d_wy[d_idx] += tmp * DWI[1]
        d_wz[d_idx] += tmp * DWI[2]


class GSPHUpdateGhostProps(Equation):
    """The reference's copy into ghost particles: a no-op here (the
    periodic grid's minimum images stand for the ghosts)."""

    def __init__(self, dest, sources=None):
        super(GSPHUpdateGhostProps, self).__init__(dest, sources)

    def initialize(self, d_idx):
        pass


def _blend(blend_alpha, t, tf):
    """exp(-blend_alpha t / tf) of a float or a 0-d tensor t."""
    x = -blend_alpha * t / tf
    return torch.exp(x) if torch.is_tensor(x) else math.exp(x)


class GSPHAcceleration(Equation):
    """The GSPH accelerations from pairwise Riemann problems."""

    def __init__(self, dest, sources, g1=0.0, g2=0.0,
                 monotonicity=0, rsolver=2,
                 interpolation=Linear, interface_zero=True, hybrid=False,
                 blend_alpha=5.0, tf=1.0,
                 gamma=1.4, niter=20, tol=1e-6):
        self.gamma = gamma
        self.niter = niter
        self.tol = tol
        self.g1 = g1
        self.g2 = g2
        self.monotonicity = monotonicity
        self.interpolation = interpolation
        self.rsolver = rsolver
        self.sstar = 0.0
        self.thermal_conduction = 0 if (g1 == 0 and g2 == 0) else 1
        self.interface_zero = interface_zero
        self.hybrid = hybrid
        self.blend_alpha = blend_alpha
        self.tf = tf
        super(GSPHAcceleration, self).__init__(dest, sources)

    def initialize(self, d_idx, d_au, d_av, d_aw, d_ae):
        d_au[d_idx] = 0.0
        d_av[d_idx] = 0.0
        d_aw[d_idx] = 0.0
        d_ae[d_idx] = 0.0

    def loop(self, d_idx, d_m, d_h, d_rho, d_cs, d_div, d_p, d_e,
             d_grhox, d_grhoy, d_grhoz, d_u, d_v, d_w, d_px, d_py, d_pz,
             d_ux, d_uy, d_uz, d_vx, d_vy, d_vz, d_wx, d_wy, d_wz,
             d_au, d_av, d_aw, d_ae,
             s_idx, s_rho, s_m, s_h, s_cs, s_div, s_p, s_e,
             s_grhox, s_grhoy, s_grhoz, s_u, s_v, s_w, s_px, s_py, s_pz,
             s_ux, s_uy, s_uz, s_vx, s_vy, s_vz, s_wx, s_wy, s_wz,
             XIJ, DWIJ, DWI, DWJ, RIJ, RHOIJ, EPS, dt, t):
        g1 = self.g1
        g2 = self.g2

        hi = d_h[d_idx]
        hj = s_h[s_idx]

        near = RIJ < 1e-14
        rinv = 1.0 / torch.where(near, 1.0, RIJ)
        e0 = torch.where(near, 0.0, XIJ[0] * rinv)
        e1 = torch.where(near, 0.0, XIJ[1] * rinv)
        e2 = torch.where(near, 0.0, XIJ[2] * rinv)
        sij = torch.where(near, 1.0 / (RIJ + EPS), rinv)

        # velocities in the local coordinate system (j left, i right)
        vl = s_u[s_idx] * e0 + s_v[s_idx] * e1 + s_w[s_idx] * e2
        vr = d_u[d_idx] * e0 + d_v[d_idx] * e1 + d_w[d_idx] * e2

        # thermal conduction (ADKE style)
        Hi = g1 * hi * d_cs[d_idx] + \
            g2 * hi * hi * (torch.abs(d_div[d_idx]) - d_div[d_idx])

        grhoi_dot_eij = (d_grhox[d_idx] * e0 + d_grhoy[d_idx] * e1 +
                         d_grhoz[d_idx] * e2)
        grhoj_dot_eij = (s_grhox[s_idx] * e0 + s_grhoy[s_idx] * e1 +
                         s_grhoz[s_idx] * e2)

        vij_i, vij_j, sstar = self.interpolate(
            hi, hj, d_rho[d_idx], s_rho[s_idx], RIJ,
            grhoi_dot_eij, grhoj_dot_eij)

        # directional derivatives of the linear reconstruction
        rsi = grhoi_dot_eij
        psi = d_px[d_idx] * e0 + d_py[d_idx] * e1 + d_pz[d_idx] * e2
        vsi = (e0 * e0 * d_ux[d_idx] +
               e0 * e1 * (d_uy[d_idx] + d_vx[d_idx]) +
               e0 * e2 * (d_uz[d_idx] + d_wx[d_idx]) +
               e1 * e1 * d_vy[d_idx] +
               e1 * e2 * (d_vz[d_idx] + d_wy[d_idx]) +
               e2 * e2 * d_wz[d_idx])

        rsj = grhoj_dot_eij
        psj = s_px[s_idx] * e0 + s_py[s_idx] * e1 + s_pz[s_idx] * e2
        vsj = (e0 * e0 * s_ux[s_idx] +
               e0 * e1 * (s_uy[s_idx] + s_vx[s_idx]) +
               e0 * e2 * (s_uz[s_idx] + s_wx[s_idx]) +
               e1 * e1 * s_vy[s_idx] +
               e1 * e2 * (s_vz[s_idx] + s_wy[s_idx]) +
               e2 * e2 * s_wz[s_idx])

        csi = d_cs[d_idx]
        csj = s_cs[s_idx]
        rhoi = d_rho[d_idx]
        rhoj = s_rho[s_idx]
        pi = d_p[d_idx]
        pj = s_p[s_idx]

        if self.monotonicity == 0:          # first order
            zeros = torch.zeros_like(rsi)
            rsi = rsj = psi = psj = vsi = vsj = zeros
        elif self.monotonicity == 1:        # I02
            vzero = (vsi * vsj) < 0
            vsi = torch.where(vzero, 0.0, vsi)
            vsj = torch.where(vzero, 0.0, vsj)
            allzero = torch.minimum(csi, csj) < 3.0 * (vl - vr)
            rsi = torch.where(allzero, 0.0, rsi)
            rsj = torch.where(allzero, 0.0, rsj)
            psi = torch.where(allzero, 0.0, psi)
            psj = torch.where(allzero, 0.0, psj)
            vsi = torch.where(allzero, 0.0, vsi)
            vsj = torch.where(allzero, 0.0, vsj)
        elif self.monotonicity == 2:        # IwIn
            qijr = rhoi - rhoj
            qijp = pi - pj
            qiju = vr - vl

            def iwin(qs, q):
                dl = qs * RIJ
                dlp = 2.0 * dl - q
                return monotonicity_min(q, dl, dlp) * rinv

            rsi_m = iwin(rsi, qijr)
            psi_m = iwin(psi, qijp)
            vsi_m = iwin(vsi, qiju)
            rsj_m = iwin(rsj, qijr)
            psj_m = iwin(psj, qijp)
            vsj_m = iwin(vsj, qiju)
            rsi = torch.where(near, 0.0, rsi_m)
            psi = torch.where(near, 0.0, psi_m)
            vsi = torch.where(near, 0.0, vsi_m)
            rsj = torch.where(near, 0.0, rsj_m)
            psj = torch.where(near, 0.0, psj_m)
            vsj = torch.where(near, 0.0, vsj_m)

        # MUSCL-style reconstruction of the left and right states
        sstar = sstar * 2.0
        fl = 1.0 - csj * dt * sij + sstar
        fr = 1.0 - csi * dt * sij + sstar
        rhol = rhoj + 0.5 * rsj * RIJ * fl
        rhor = rhoi - 0.5 * rsi * RIJ * fr
        rhol = torch.where(rhol < 0, rhoj, rhol)
        rhor = torch.where(rhor < 0, rhoi, rhor)

        pl = pj + 0.5 * psj * RIJ * fl
        pr = pi - 0.5 * psi * RIJ * fr
        pl = torch.where(pl < 0, pj, pl)
        pr = torch.where(pr < 0, pi, pr)

        ul = vl + 0.5 * vsj * RIJ * fl
        ur = vr - 0.5 * vsi * RIJ * fr

        pstar, ustar = riemann_solve(
            self.rsolver, rhol, rhor, pl, pr, ul, ur,
            self.gamma, self.niter, self.tol)

        if self.hybrid:
            blending_factor = _blend(self.blend_alpha, t, self.tf)
            pstar2, ustar2 = riemann_solve(
                10, rhoj, rhoi, pl, pr, vl, vr, self.gamma,
                self.niter, self.tol)
            ustar = ustar + blending_factor * (ustar2 - ustar)
            pstar = pstar + blending_factor * (pstar2 - pstar)

        v0 = ustar * e0
        v1 = ustar * e1
        v2 = ustar * e2

        mj = s_m[s_idx]
        d_au[d_idx] += -mj * pstar * (vij_i * DWI[0] + vij_j * DWJ[0])
        d_av[d_idx] += -mj * pstar * (vij_i * DWI[1] + vij_j * DWJ[1])
        d_aw[d_idx] += -mj * pstar * (vij_i * DWI[2] + vij_j * DWJ[2])

        vstardotdwi = v0 * DWI[0] + v1 * DWI[1] + v2 * DWI[2]
        vstardotdwj = v0 * DWJ[0] + v1 * DWJ[1] + v2 * DWJ[2]

        d_ae[d_idx] += -mj * pstar * (vij_i * vstardotdwi +
                                      vij_j * vstardotdwj)

        if self.thermal_conduction:
            divj = s_div[s_idx]
            Hj = g1 * hj * csj + \
                g2 * hj * hj * (torch.abs(divj) - divj)
            Hij = (Hi + Hj) * (d_e[d_idx] - s_e[s_idx])
            Hij = Hij / (RHOIJ * (RIJ * RIJ + EPS))
            d_ae[d_idx] += mj * Hij * (XIJ[0] * DWIJ[0] +
                                       XIJ[1] * DWIJ[1] +
                                       XIJ[2] * DWIJ[2])

    def interpolate(self, hi, hj, rhoi, rhoj, sij, gri_eij, grj_eij):
        """The specific-volume integrals Vij^2 of each side and the
        interface's position."""
        Vi = 1.0 / rhoi
        Vj = 1.0 / rhoj
        Vip = -gri_eij / (rhoi * rhoi)
        Vjp = -grj_eij / (rhoj * rhoj)
        hij = 0.5 * (hi + hj)
        sstar = torch.zeros_like(sij) + self.sstar

        tiny = sij < 1e-8
        s_safe = torch.where(tiny, 1.0, sij)

        if self.interpolation == 0:
            vij_i2 = 1.0 / (rhoi * rhoi)
            vij_j2 = 1.0 / (rhoj * rhoj)
        elif self.interpolation == 1:
            cij = torch.where(tiny, 0.0, (Vi - Vj) / s_safe)
            dij = 0.5 * (Vi + Vj)
            vij_i2 = 0.25 * hi * hi * cij * cij + dij * dij
            vij_j2 = 0.25 * hj * hj * cij * cij + dij * dij
            if not self.interface_zero:
                vij = 0.5 * (vij_i2 + vij_j2)
                sstar = 0.5 * hij * hij * cij * dij / vij
        elif self.interpolation == 2:
            aij = torch.where(
                tiny, 0.0,
                -2.0 * (Vi - Vj) / (s_safe ** 3) +
                (Vip + Vjp) / (s_safe * s_safe))
            bij = torch.where(tiny, 0.0, 0.5 * (Vip - Vjp) / s_safe)
            cij = torch.where(
                tiny, 0.0,
                1.5 * (Vi - Vj) / s_safe - 0.25 * (Vip + Vjp))
            dij = torch.where(
                tiny, 0.5 * (Vi + Vj),
                0.5 * (Vi + Vj) - 0.125 * (Vip - Vjp) * sij)

            hi2, hj2 = hi * hi, hj * hj
            hi4, hj4 = hi2 * hi2, hj2 * hj2
            hi6, hj6 = hi4 * hi2, hj4 * hj2
            vij_i2 = (15.0 / 64.0 * hi6 * aij * aij +
                      3.0 / 16.0 * hi4 * (2 * aij * cij + bij * bij) +
                      0.25 * hi2 * (2 * bij * dij + cij * cij) +
                      dij * dij)
            vij_j2 = (15.0 / 64.0 * hj6 * aij * aij +
                      3.0 / 16.0 * hj4 * (2 * aij * cij + bij * bij) +
                      0.25 * hj2 * (2 * bij * dij + cij * cij) +
                      dij * dij)
            hij2 = hij * hij
            hij4 = hij2 * hij2
            if not self.interface_zero:
                vij = 0.5 * (vij_i2 + vij_j2)
                sstar = ((15.0 / 32.0) * hij4 * hij2 * aij * bij +
                         (3.0 / 8.0) * hij4 * (aij * dij + bij * cij) +
                         0.5 * hij2 * cij * dij) / vij
        else:
            raise ValueError('Unknown interpolation type %r' %
                             self.interpolation)
        return vij_i2, vij_j2, sstar
