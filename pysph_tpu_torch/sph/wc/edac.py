"""Entropically Damped Artificial Compressibility (EDAC) SPH, Ramachandran
& Puri 2016: port of ``pysph_tpu/sph/wc/edac.py``.

A pressure evolution equation (``EDACEquation``, writing ``ap``) takes
the place of an equation of state.  ``EDACScheme`` has two forms: with a
background pressure (``pb`` not 0: the transport-velocity form, the
Taylor-Green vortex and the lid-driven cavity) its momentum group is
TVF's with this module's ``MomentumEquationPressureGradient`` (the
Basa-Quinlan-Lastiwka correction by the neighbours' mean pressure,
``ComputeAveragePressure``) and ``EDACTVFStep``; without (the external
flow of the 2D dam break) it is this module's ``MomentumEquation`` and
``XSPHCorrection``, with ``EDACStep``.  The walls take their pressure and
velocity from the fluid (``SolidWallPressureBC``, ``SetWallVelocity``,
after ``SourceNumberDensity``).

On the card ``ops/tvf_pair.py`` runs the fluid's pair terms (the
density set ``SummationDensity`` + ``ComputeAveragePressure``, the
momentum set with ``EDACEquation``) and ``ops/gtvf_pair.py`` the wall's
group (its EDAC wall set).  An ``inlet_outlet_manager`` is not ported
(ROADMAP Queue 1 item 28, ``bc/inlet_outlet_manager``)."""

import math

import torch

from pysph_tpu_torch.base.utils import DEFAULT_PROPS, get_particle_array
from pysph_tpu_torch.sph.equation import Equation, Group
from pysph_tpu_torch.sph.integrator_step import IntegratorStep
from pysph_tpu_torch.sph.scheme import Scheme, add_bool_argument

M_PI = math.pi
#: the ROADMAP item of the inlet/outlet manager
IOM_ITEM = 'ROADMAP Queue 1 item 28, bc/inlet_outlet_manager'

EDAC_PROPS = ('ap', 'au', 'av', 'aw', 'ax', 'ay', 'az',
              'x0', 'y0', 'z0', 'u0', 'v0', 'w0', 'p0', 'V')


def get_particle_array_edac(constants=None, **props):
    pa = get_particle_array(constants=constants,
                            additional_props=EDAC_PROPS, **props)
    pa.set_output_arrays(['x', 'y', 'z', 'u', 'v', 'w', 'rho', 'p',
                          'au', 'av', 'aw', 'ap', 'm', 'h'])
    return pa


EDAC_SOLID_PROPS = ('ap', 'p0', 'wij', 'uf', 'vf', 'wf', 'ug', 'vg',
                    'wg', 'ax', 'ay', 'az', 'V')


def get_particle_array_edac_solid(constants=None, **props):
    pa = get_particle_array(constants=constants,
                            additional_props=EDAC_SOLID_PROPS, **props)
    pa.set_output_arrays(['x', 'y', 'z', 'u', 'v', 'w', 'rho', 'p', 'h'])
    return pa


def _damping(t, tdamp):
    """The body force's factor, ramped from 0 over ``tdamp`` (``t``: the
    stage's, a 0-d device tensor in the solver's chunks)."""
    if tdamp > 0:
        t = torch.as_tensor(t, dtype=torch.float64)
        return torch.where(
            t < tdamp, 0.5 * (torch.sin((-0.5 + t / tdamp) * M_PI) + 1.0),
            1.0)
    return 1.0


class ComputeAveragePressure(Equation):
    """The mean pressure of the neighbours, for the Basa-Quinlan-Lastiwka
    correction: ``pavg`` sums ``s_p`` and ``nnbr`` counts every pair in
    support (``W = 0`` at its edge included), then divides."""

    def initialize(self, d_idx, d_pavg, d_nnbr):
        d_pavg[d_idx] = 0.0
        d_nnbr[d_idx] = 0.0

    def loop(self, d_idx, d_pavg, s_idx, s_p, d_nnbr, WIJ):
        d_pavg[d_idx] += s_p[s_idx]
        # pair-shaped, so that the pair engine adds one a pair
        d_nnbr[d_idx] += 1.0 + 0.0 * WIJ

    def post_loop(self, d_idx, d_pavg, d_nnbr):
        n = d_nnbr[d_idx]
        d_pavg[d_idx] = torch.where(
            n > 0, d_pavg[d_idx] / torch.where(n > 0, n, 1.0),
            d_pavg[d_idx])


class EDACStep(IntegratorStep):
    """Predictor-corrector step of (u, x, p) from the start of the step;
    positions with ``ax ay az`` (XSPH)."""

    def initialize(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
                   d_u0, d_v0, d_w0, d_u, d_v, d_w, d_p0, d_p):
        d_x0[d_idx] = d_x[d_idx]
        d_y0[d_idx] = d_y[d_idx]
        d_z0[d_idx] = d_z[d_idx]
        d_u0[d_idx] = d_u[d_idx]
        d_v0[d_idx] = d_v[d_idx]
        d_w0[d_idx] = d_w[d_idx]
        d_p0[d_idx] = d_p[d_idx]

    def stage1(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
               d_u0, d_v0, d_w0, d_u, d_v, d_w, d_p0, d_p, d_au, d_av,
               d_aw, d_ax, d_ay, d_az, d_ap, dt):
        dtb2 = 0.5 * dt
        d_u[d_idx] = d_u0[d_idx] + dtb2 * d_au[d_idx]
        d_v[d_idx] = d_v0[d_idx] + dtb2 * d_av[d_idx]
        d_w[d_idx] = d_w0[d_idx] + dtb2 * d_aw[d_idx]
        d_x[d_idx] = d_x0[d_idx] + dtb2 * d_ax[d_idx]
        d_y[d_idx] = d_y0[d_idx] + dtb2 * d_ay[d_idx]
        d_z[d_idx] = d_z0[d_idx] + dtb2 * d_az[d_idx]
        d_p[d_idx] = d_p0[d_idx] + dtb2 * d_ap[d_idx]

    def stage2(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
               d_u0, d_v0, d_w0, d_u, d_v, d_w, d_p0, d_p, d_au, d_av,
               d_aw, d_ax, d_ay, d_az, d_ap, dt):
        d_u[d_idx] = d_u0[d_idx] + dt * d_au[d_idx]
        d_v[d_idx] = d_v0[d_idx] + dt * d_av[d_idx]
        d_w[d_idx] = d_w0[d_idx] + dt * d_aw[d_idx]
        d_x[d_idx] = d_x0[d_idx] + dt * d_ax[d_idx]
        d_y[d_idx] = d_y0[d_idx] + dt * d_ay[d_idx]
        d_z[d_idx] = d_z0[d_idx] + dt * d_az[d_idx]
        d_p[d_idx] = d_p0[d_idx] + dt * d_ap[d_idx]


class SolidWallPressureBC(Equation):
    """Adami's wall pressure for EDAC: the kernel-weighted fluid
    pressure and the hydrostatic term of the wall's acceleration against
    gravity, over ``wij`` (``SourceNumberDensity``'s, before it)."""

    def __init__(self, dest, sources, gx=0.0, gy=0.0, gz=0.0):
        self.gx = gx
        self.gy = gy
        self.gz = gz
        super(SolidWallPressureBC, self).__init__(dest, sources)

    def initialize(self, d_idx, d_p):
        d_p[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_p, s_p, s_rho,
             d_au, d_av, d_aw, WIJ, XIJ):
        gdotxij = ((self.gx - d_au[d_idx]) * XIJ[0] +
                   (self.gy - d_av[d_idx]) * XIJ[1] +
                   (self.gz - d_aw[d_idx]) * XIJ[2])
        d_p[d_idx] += s_p[s_idx] * WIJ + s_rho[s_idx] * gdotxij * WIJ

    def post_loop(self, d_idx, d_wij, d_p):
        has = d_wij[d_idx] > 1e-14
        d_p[d_idx] = torch.where(
            has, d_p[d_idx] / torch.where(has, d_wij[d_idx], 1.0),
            d_p[d_idx])


class ClampWallPressure(Equation):
    """The wall pressure clamped to non-negative values."""

    def post_loop(self, d_idx, d_p):
        d_p[d_idx] = torch.clamp(d_p[d_idx], min=0.0)


class SourceNumberDensity(Equation):
    """``wij``, the number density of the sources."""

    def initialize(self, d_idx, d_wij):
        d_wij[d_idx] = 0.0

    def loop(self, d_idx, d_wij, WIJ):
        d_wij[d_idx] += WIJ


class SetWallVelocity(Equation):
    """The fluid velocity extrapolated onto the wall (``uf``) and the
    ghost velocity ``2 u - uf``, over ``SourceNumberDensity``'s
    ``wij``."""

    def initialize(self, d_idx, d_uf, d_vf, d_wf):
        d_uf[d_idx] = 0.0
        d_vf[d_idx] = 0.0
        d_wf[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_uf, d_vf, d_wf, s_u, s_v, s_w, WIJ):
        d_uf[d_idx] += s_u[s_idx] * WIJ
        d_vf[d_idx] += s_v[s_idx] * WIJ
        d_wf[d_idx] += s_w[s_idx] * WIJ

    def post_loop(self, d_uf, d_vf, d_wf, d_wij, d_idx,
                  d_ug, d_vg, d_wg, d_u, d_v, d_w):
        has = d_wij[d_idx] > 1e-12
        denom = torch.where(has, d_wij[d_idx], 1.0)
        d_uf[d_idx] = torch.where(has, d_uf[d_idx] / denom, d_uf[d_idx])
        d_vf[d_idx] = torch.where(has, d_vf[d_idx] / denom, d_vf[d_idx])
        d_wf[d_idx] = torch.where(has, d_wf[d_idx] / denom, d_wf[d_idx])
        d_ug[d_idx] = 2 * d_u[d_idx] - d_uf[d_idx]
        d_vg[d_idx] = 2 * d_v[d_idx] - d_vf[d_idx]
        d_wg[d_idx] = 2 * d_w[d_idx] - d_wf[d_idx]


def _reflect(u, v, w, wij, xn, yn, zn):
    """Shepard-normalise (u, v, w) where ``wij`` holds, then reflect its
    component along the normal (xn, yn, zn)."""
    has = wij > 1e-14
    denom = torch.where(has, wij, 1.0)
    u = torch.where(has, u / denom, u)
    v = torch.where(has, v / denom, v)
    w = torch.where(has, w / denom, w)
    projection = u * xn + v * yn + w * zn
    return (u - 2 * projection * xn, v - 2 * projection * yn,
            w - 2 * projection * zn)


class NoSlipVelocityExtrapolation(Equation):
    """The fluid velocity Shepard-extrapolated onto an inviscid wall,
    its normal component reflected."""

    def initialize(self, d_idx, d_u, d_v, d_w):
        d_u[d_idx] = 0.0
        d_v[d_idx] = 0.0
        d_w[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_u, d_v, d_w, s_u, s_v, s_w, WIJ):
        d_u[d_idx] += s_u[s_idx] * WIJ
        d_v[d_idx] += s_v[s_idx] * WIJ
        d_w[d_idx] += s_w[s_idx] * WIJ

    def post_loop(self, d_idx, d_wij, d_u, d_v, d_w, d_xn, d_yn, d_zn):
        d_u[d_idx], d_v[d_idx], d_w[d_idx] = _reflect(
            d_u[d_idx], d_v[d_idx], d_w[d_idx], d_wij[d_idx], d_xn[d_idx],
            d_yn[d_idx], d_zn[d_idx])


class NoSlipAdvVelocityExtrapolation(Equation):
    """``NoSlipVelocityExtrapolation`` for the advection velocity
    ``uhat``."""

    def initialize(self, d_idx, d_uhat, d_vhat, d_what):
        d_uhat[d_idx] = 0.0
        d_vhat[d_idx] = 0.0
        d_what[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_uhat, d_vhat, d_what, s_uhat,
             s_vhat, s_what, WIJ):
        d_uhat[d_idx] += s_uhat[s_idx] * WIJ
        d_vhat[d_idx] += s_vhat[s_idx] * WIJ
        d_what[d_idx] += s_what[s_idx] * WIJ

    def post_loop(self, d_idx, d_wij, d_uhat, d_vhat, d_what, d_xn,
                  d_yn, d_zn):
        d_uhat[d_idx], d_vhat[d_idx], d_what[d_idx] = _reflect(
            d_uhat[d_idx], d_vhat[d_idx], d_what[d_idx], d_wij[d_idx],
            d_xn[d_idx], d_yn[d_idx], d_zn[d_idx])


class MomentumEquation(Equation):
    """The pressure gradient in number-density form (Hu & Adams 2006)
    and the body force, damped over ``tdamp``."""

    def __init__(self, dest, sources, c0, gx=0.0, gy=0.0, gz=0.0,
                 tdamp=0.0):
        self.gx = gx
        self.gy = gy
        self.gz = gz
        self.c0 = c0
        self.tdamp = tdamp
        super(MomentumEquation, self).__init__(dest, sources)

    def initialize(self, d_idx, d_au, d_av, d_aw):
        d_au[d_idx] = 0.0
        d_av[d_idx] = 0.0
        d_aw[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_m, d_rho, d_p, d_V, d_au, d_av,
             d_aw, s_rho, s_p, s_V, DWIJ):
        rhoi = d_rho[d_idx]
        rhoj = s_rho[s_idx]
        pij = (rhoj * d_p[d_idx] + rhoi * s_p[s_idx]) / (rhoj + rhoi)
        Vi = 1.0 / d_V[d_idx]
        Vj = 1.0 / s_V[s_idx]
        tmp = -pij / d_m[d_idx] * (Vi * Vi + Vj * Vj)
        d_au[d_idx] += tmp * DWIJ[0]
        d_av[d_idx] += tmp * DWIJ[1]
        d_aw[d_idx] += tmp * DWIJ[2]

    def post_loop(self, d_idx, d_au, d_av, d_aw, t):
        fac = _damping(t, self.tdamp)
        d_au[d_idx] += fac * self.gx
        d_av[d_idx] += fac * self.gy
        d_aw[d_idx] += fac * self.gz


class EDACEquation(Equation):
    """The pressure evolution equation: ``rho_i / rho_j cs^2 m_j v_ij .
    DWIJ`` and a viscous damping of the pressure with ``nu``."""

    def __init__(self, dest, sources, cs, nu, rho0):
        self.cs = cs
        self.nu = nu
        self.rho0 = rho0
        super(EDACEquation, self).__init__(dest, sources)

    def initialize(self, d_idx, d_ap):
        d_ap[d_idx] = 0.0

    def loop(self, d_idx, d_m, d_rho, d_ap, d_p, d_V, s_idx, s_m,
             s_rho, s_p, s_V, DWIJ, VIJ, XIJ, R2IJ, EPS):
        Vi = 1.0 / d_V[d_idx]
        Vj = 1.0 / s_V[s_idx]
        etai = d_rho[d_idx]
        etaj = s_rho[s_idx]
        etaij = 2 * self.nu * (etai * etaj) / (etai + etaj)
        vijdotdwij = (DWIJ[0] * VIJ[0] + DWIJ[1] * VIJ[1] +
                      DWIJ[2] * VIJ[2])
        d_ap[d_idx] += (d_rho[d_idx] / s_rho[s_idx] * self.cs *
                        self.cs * s_m[s_idx] * vijdotdwij)
        xijdotdwij = (DWIJ[0] * XIJ[0] + DWIJ[1] * XIJ[1] +
                      DWIJ[2] * XIJ[2])
        tmp = (1.0 / d_m[d_idx] * (Vi * Vi + Vj * Vj) * etaij *
               xijdotdwij / (R2IJ + EPS))
        d_ap[d_idx] += tmp * (d_p[d_idx] - s_p[s_idx])


class MomentumEquationPressureGradient(Equation):
    """TVF's pressure gradient with the Basa-Quinlan-Lastiwka correction:
    ``p - pavg`` on both sides (the dest's ``pavg``), and the background
    pressure ``pb`` in ``auhat``."""

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
             d_p, d_pavg, s_p, d_auhat, d_avhat, d_awhat, d_V, s_V,
             DWIJ):
        rhoi = d_rho[d_idx]
        rhoj = s_rho[s_idx]
        pavg = d_pavg[d_idx]
        pij = (rhoj * (d_p[d_idx] - pavg) +
               rhoi * (s_p[s_idx] - pavg)) / (rhoj + rhoi)
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
        fac = _damping(t, self.tdamp)
        d_au[d_idx] += self.gx * fac
        d_av[d_idx] += self.gy * fac
        d_aw[d_idx] += self.gz * fac


class EDACTVFStep(IntegratorStep):
    """The transport-velocity form's step: ``EDACStep`` with positions
    advanced by ``uhat = u + dt auhat``."""

    def initialize(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
                   d_u0, d_v0, d_w0, d_u, d_v, d_w, d_p0, d_p):
        d_x0[d_idx] = d_x[d_idx]
        d_y0[d_idx] = d_y[d_idx]
        d_z0[d_idx] = d_z[d_idx]
        d_u0[d_idx] = d_u[d_idx]
        d_v0[d_idx] = d_v[d_idx]
        d_w0[d_idx] = d_w[d_idx]
        d_p0[d_idx] = d_p[d_idx]

    def stage1(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
               d_u0, d_v0, d_w0, d_u, d_v, d_w, d_p0, d_p, d_au,
               d_av, d_auhat, d_avhat, d_awhat, d_uhat, d_vhat,
               d_what, d_aw, d_ap, dt):
        dtb2 = 0.5 * dt
        d_u[d_idx] = d_u0[d_idx] + dtb2 * d_au[d_idx]
        d_v[d_idx] = d_v0[d_idx] + dtb2 * d_av[d_idx]
        d_w[d_idx] = d_w0[d_idx] + dtb2 * d_aw[d_idx]
        d_uhat[d_idx] = d_u[d_idx] + dtb2 * d_auhat[d_idx]
        d_vhat[d_idx] = d_v[d_idx] + dtb2 * d_avhat[d_idx]
        d_what[d_idx] = d_w[d_idx] + dtb2 * d_awhat[d_idx]
        d_x[d_idx] = d_x0[d_idx] + dtb2 * d_uhat[d_idx]
        d_y[d_idx] = d_y0[d_idx] + dtb2 * d_vhat[d_idx]
        d_z[d_idx] = d_z0[d_idx] + dtb2 * d_what[d_idx]
        d_p[d_idx] = d_p0[d_idx] + dtb2 * d_ap[d_idx]

    def stage2(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
               d_u0, d_v0, d_w0, d_u, d_v, d_w, d_p0, d_p, d_au, d_av,
               d_aw, d_auhat, d_avhat, d_awhat, d_uhat, d_vhat, d_what,
               d_ap, dt):
        d_u[d_idx] = d_u0[d_idx] + dt * d_au[d_idx]
        d_v[d_idx] = d_v0[d_idx] + dt * d_av[d_idx]
        d_w[d_idx] = d_w0[d_idx] + dt * d_aw[d_idx]
        d_uhat[d_idx] = d_u[d_idx] + dt * d_auhat[d_idx]
        d_vhat[d_idx] = d_v[d_idx] + dt * d_avhat[d_idx]
        d_what[d_idx] = d_w[d_idx] + dt * d_awhat[d_idx]
        d_x[d_idx] = d_x0[d_idx] + dt * d_uhat[d_idx]
        d_y[d_idx] = d_y0[d_idx] + dt * d_vhat[d_idx]
        d_z[d_idx] = d_z0[d_idx] + dt * d_what[d_idx]
        d_p[d_idx] = d_p0[d_idx] + dt * d_ap[d_idx]


class EDACScheme(Scheme):
    """The EDAC scheme: the transport-velocity form where ``pb`` is not 0
    (``use_tvf``), else the external-flow form; ``PECIntegrator`` with
    ``EDACTVFStep`` or ``EDACStep`` and ``QuinticSpline`` by default.  The
    pressure equation's viscosity is ``art_nu = edac_alpha h c0 / 8``
    where that is positive, else ``nu``."""

    def __init__(self, fluids, solids, dim, c0, nu, rho0, pb=0.0,
                 gx=0.0, gy=0.0, gz=0.0, tdamp=0.0, eps=0.0, h=0.0,
                 edac_alpha=0.5, alpha=0.0, bql=True, clamp_p=False,
                 inlet_outlet_manager=None, inviscid_solids=None):
        self.c0 = c0
        self.nu = nu
        self.rho0 = rho0
        self.gx = gx
        self.gy = gy
        self.gz = gz
        self.tdamp = tdamp
        self.dim = dim
        self.eps = eps
        self.fluids = fluids
        self.solids = solids
        self.pb = pb
        self.solver = None
        self.bql = bql
        self.clamp_p = clamp_p
        self.edac_alpha = edac_alpha
        self.alpha = alpha
        self.h = h
        self.inlet_outlet_manager = inlet_outlet_manager
        self.inviscid_solids = inviscid_solids or []
        self.attributes_changed()

    def add_user_options(self, group):
        group.add_argument('--alpha', action='store', type=float,
                           dest='alpha', default=None,
                           help='Artificial viscosity alpha.')
        group.add_argument('--edac-alpha', action='store', type=float,
                           dest='edac_alpha', default=None,
                           help='Alpha for the EDAC viscosity.')
        add_bool_argument(group, 'clamp-pressure', dest='clamp_p',
                          help='Clamp boundary pressure non-negative.',
                          default=None)
        add_bool_argument(group, 'use-bql', dest='bql',
                          help='Use the Basa-Quinlan-Lastiwka '
                               'correction.', default=None)
        group.add_argument('--tdamp', action='store', type=float,
                           dest='tdamp', default=None,
                           help='Acceleration damping time.')

    def consume_user_options(self, options):
        data = dict((var, self._smart_getattr(options, var))
                    for var in ('alpha', 'edac_alpha', 'clamp_p', 'bql',
                                'tdamp'))
        self.configure(**data)

    def attributes_changed(self):
        if self.pb is not None:
            self.use_tvf = abs(self.pb) > 1e-14
        if self.h is not None and self.c0 is not None:
            self.art_nu = self.edac_alpha * self.h * self.c0 / 8

    def _check_iom(self):
        if self.inlet_outlet_manager is not None:
            raise NotImplementedError(
                'EDACScheme: an inlet_outlet_manager is not ported yet '
                '(%s)' % IOM_ITEM)

    def configure_solver(self, kernel=None, integrator_cls=None,
                         extra_steppers=None, **kw):
        from pysph_tpu_torch.base.kernels import QuinticSpline
        from pysph_tpu_torch.sph.integrator import PECIntegrator
        from pysph_tpu_torch.solver.solver import Solver
        self._check_iom()
        if kernel is None:
            kernel = QuinticSpline(dim=self.dim)
        steppers = dict(extra_steppers or {})
        step_cls = EDACTVFStep if self.use_tvf else EDACStep
        cls = integrator_cls if integrator_cls is not None else \
            PECIntegrator
        for fluid in self.fluids:
            if fluid not in steppers:
                steppers[fluid] = step_cls()
        integrator = cls(**steppers)
        self.solver = Solver(dim=self.dim, integrator=integrator,
                             kernel=kernel, **kw)

    def get_equations(self):
        self._check_iom()
        if self.use_tvf:
            return self._get_internal_flow_equations()
        return self._get_external_flow_equations()

    def setup_properties(self, particles, clean=True):
        self._check_iom()
        particle_arrays = dict((p.name, p) for p in particles)
        tvf_fluid_props = set([
            'uhat', 'vhat', 'what', 'ap', 'auhat', 'avhat', 'awhat',
            'V', 'p0', 'u0', 'v0', 'w0', 'x0', 'y0', 'z0', 'pavg',
            'nnbr'])
        extra = tvf_fluid_props if self.use_tvf else set(EDAC_PROPS)
        all_fluid_props = set(DEFAULT_PROPS).union(extra)
        for fluid in self.fluids:
            pa = particle_arrays[fluid]
            self._ensure_properties(pa, all_fluid_props, clean)
            pa.set_output_arrays(['x', 'y', 'z', 'u', 'v', 'w', 'rho',
                                  'p', 'm', 'h', 'V'])
            if 'pavg' in pa.properties:
                pa.add_output_arrays(['pavg'])
        tvf_solid_props = ['V', 'wij', 'ax', 'ay', 'az', 'uf', 'vf',
                           'wf', 'ug', 'vg', 'wg']
        if self.inviscid_solids:
            tvf_solid_props += ['xn', 'yn', 'zn', 'uhat', 'vhat',
                                'what']
        extra = tvf_solid_props if self.use_tvf else \
            set(EDAC_SOLID_PROPS)
        all_solid_props = set(DEFAULT_PROPS).union(extra)
        for solid in (self.solids + self.inviscid_solids):
            pa = particle_arrays[solid]
            self._ensure_properties(pa, all_solid_props, clean)
            pa.set_output_arrays(['x', 'y', 'z', 'u', 'v', 'w', 'rho',
                                  'p', 'm', 'h', 'V'])

    def _get_edac_nu(self):
        return self.art_nu if self.art_nu > 0 else self.nu

    def _wall_groups(self, fluids, all, clamp):
        """The walls' equations of the first group: for each solid its
        number density, volume, pressure and velocity (the pressure
        clamped with ``clamp``), for each inviscid solid its extrapolated
        velocities instead of the wall velocity."""
        from pysph_tpu_torch.sph.wc.transport_velocity import (
            VolumeSummation)
        eqs = []
        for solid in self.solids:
            eqs.extend([
                SourceNumberDensity(dest=solid, sources=fluids),
                VolumeSummation(dest=solid, sources=all),
                SolidWallPressureBC(dest=solid, sources=fluids,
                                    gx=self.gx, gy=self.gy, gz=self.gz),
                SetWallVelocity(dest=solid, sources=fluids),
            ])
            if clamp:
                eqs.append(ClampWallPressure(dest=solid, sources=None))
        for solid in self.inviscid_solids:
            eqs.extend([
                SourceNumberDensity(dest=solid, sources=fluids),
                NoSlipVelocityExtrapolation(dest=solid, sources=fluids),
            ])
            if self.use_tvf:
                eqs.append(NoSlipAdvVelocityExtrapolation(
                    dest=solid, sources=fluids))
            eqs.extend([
                VolumeSummation(dest=solid, sources=all),
                SolidWallPressureBC(dest=solid, sources=fluids,
                                    gx=self.gx, gy=self.gy, gz=self.gz),
            ])
        return eqs

    def _viscous(self, fluid, fluids):
        """The artificial viscosity, the viscosity and the no-slip wall
        that the fluid's momentum group takes."""
        from pysph_tpu_torch.sph.wc.transport_velocity import (
            MomentumEquationArtificialViscosity,
            MomentumEquationViscosity, SolidWallNoSlipBC)
        eqs = []
        if self.alpha > 0.0:
            eqs.append(MomentumEquationArtificialViscosity(
                dest=fluid, sources=fluids + self.solids,
                alpha=self.alpha, c0=self.c0))
        if self.nu > 0.0:
            eqs.append(MomentumEquationViscosity(
                dest=fluid, sources=fluids, nu=self.nu))
        if len(self.solids) > 0 and self.nu > 0.0:
            eqs.append(SolidWallNoSlipBC(
                dest=fluid, sources=self.solids, nu=self.nu))
        return eqs

    def _get_internal_flow_equations(self):
        from pysph_tpu_torch.sph.wc.transport_velocity import (
            MomentumEquationArtificialStress, SummationDensity)
        edac_nu = self._get_edac_nu()
        fluids = list(self.fluids)
        all_solids = self.solids + self.inviscid_solids
        all = fluids + all_solids
        equations = []

        group1 = []
        avg_p_group = []
        has_solids = len(all_solids) > 0
        for fluid in fluids:
            group1.append(SummationDensity(dest=fluid, sources=all))
            if self.bql:
                eq = ComputeAveragePressure(dest=fluid, sources=all)
                (avg_p_group if has_solids else group1).append(eq)
        group1.extend(self._wall_groups(fluids, all, clamp=False))
        equations.append(Group(equations=group1, real=False))
        if self.bql and has_solids:
            equations.append(Group(equations=avg_p_group, real=True))

        group2 = []
        for fluid in self.fluids:
            group2.append(MomentumEquationPressureGradient(
                dest=fluid, sources=all, pb=self.pb, gx=self.gx,
                gy=self.gy, gz=self.gz, tdamp=self.tdamp))
            group2.extend(self._viscous(fluid, fluids))
            group2.extend([
                MomentumEquationArtificialStress(dest=fluid, sources=fluids),
                EDACEquation(dest=fluid, sources=all, nu=edac_nu,
                             cs=self.c0, rho0=self.rho0),
            ])
        equations.append(Group(equations=group2))
        return equations

    def _get_external_flow_equations(self):
        from pysph_tpu_torch.sph.basic_equations import XSPHCorrection
        from pysph_tpu_torch.sph.wc.transport_velocity import (
            SummationDensity)
        fluids = list(self.fluids)
        all = fluids + self.solids + self.inviscid_solids
        edac_nu = self._get_edac_nu()
        equations = []

        group1 = [SummationDensity(dest=fluid, sources=all)
                  for fluid in fluids]
        group1.extend(self._wall_groups(fluids, all, clamp=self.clamp_p))
        equations.append(Group(equations=group1, real=False))

        group2 = []
        for fluid in self.fluids:
            group2.append(MomentumEquation(
                dest=fluid, sources=all, gx=self.gx, gy=self.gy,
                gz=self.gz, c0=self.c0, tdamp=self.tdamp))
            group2.extend(self._viscous(fluid, fluids))
            group2.extend([
                EDACEquation(dest=fluid, sources=all, nu=edac_nu,
                             cs=self.c0, rho0=self.rho0),
                XSPHCorrection(dest=fluid, sources=[fluid], eps=self.eps),
            ])
        equations.append(Group(equations=group2))
        return equations
