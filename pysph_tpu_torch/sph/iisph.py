"""Implicit Incompressible SPH (IISPH), Ihmsen et al. 2014: port of
``pysph_tpu/sph/iisph.py``.

The relaxed-Jacobi pressure solve is an iterated group of two
sub-groups (``ComputeDIJPJ``, then ``PressureSolve`` with its wall
term): the evaluator runs sweeps of it until the mean compression,
reduced on the device into the constant ``tmp_comp`` by
``PressureSolve.reduce``, is within ``tolerance`` of ``rho0`` and two
sweeps ran, at most 30 (``sph/acceleration_eval.py::_run_iterated``,
one host read of ``converged`` a sweep).

On the card ``ops/iisph_pair.py`` runs every pair phase of the scheme:
its six phase sets (density, advection, advected density, ``dijpj``,
the pressure sweep, the pressure force), each launch of an eval after
the first that sees all of a dest's sources reading that launch's
neighbour list.  ``NormalizedSummationDensity`` is on no scheme's path
and runs on the torch pair engine.
"""

import torch

from pysph_tpu_torch.sph.equation import Equation, Group
from pysph_tpu_torch.sph.integrator_step import IntegratorStep
from pysph_tpu_torch.sph.scheme import Scheme, add_bool_argument


class IISPHStep(IntegratorStep):
    """Simple Euler-style step for IISPH: the velocity from the advected
    one and the pressure acceleration, then the position."""

    def stage1(self, d_idx, d_x, d_y, d_z, d_u, d_v, d_w,
               d_uadv, d_vadv, d_wadv, d_au, d_av, d_aw,
               d_ax, d_ay, d_az, dt):
        d_u[d_idx] = d_uadv[d_idx] + dt * d_au[d_idx]
        d_v[d_idx] = d_vadv[d_idx] + dt * d_av[d_idx]
        d_w[d_idx] = d_wadv[d_idx] + dt * d_aw[d_idx]
        d_x[d_idx] += dt * d_u[d_idx]
        d_y[d_idx] += dt * d_v[d_idx]
        d_z[d_idx] += dt * d_w[d_idx]


class NumberDensity(Equation):
    def initialize(self, d_idx, d_V):
        d_V[d_idx] = 0.0

    def loop(self, d_idx, d_V, WIJ):
        d_V[d_idx] += WIJ


class SummationDensity(Equation):
    def initialize(self, d_idx, d_rho):
        d_rho[d_idx] = 0.0

    def loop(self, d_idx, d_rho, s_idx, s_m, WIJ):
        d_rho[d_idx] += s_m[s_idx] * WIJ


class SummationDensityBoundary(Equation):
    def __init__(self, dest, sources, rho0):
        self.rho0 = rho0
        super(SummationDensityBoundary, self).__init__(dest, sources)

    def loop(self, d_idx, d_rho, s_idx, s_V, WIJ):
        d_rho[d_idx] += self.rho0 / s_V[s_idx] * WIJ


class NormalizedSummationDensity(Equation):
    def initialize(self, d_idx, d_rho, d_rho_adv, d_rho0, d_V):
        d_rho0[d_idx] = d_rho[d_idx]
        d_rho[d_idx] = 0.0
        d_rho_adv[d_idx] = 0.0
        d_V[d_idx] = 0.0

    def loop(self, d_idx, d_rho, d_rho_adv, d_V, s_idx, s_m, s_rho0,
             WIJ):
        tmp = s_m[s_idx] * WIJ
        d_rho[d_idx] += tmp
        d_rho_adv[d_idx] += tmp / s_rho0[s_idx]
        d_V[d_idx] += WIJ

    def post_loop(self, d_idx, d_rho, d_rho_adv):
        d_rho[d_idx] = d_rho[d_idx] / d_rho_adv[d_idx]


class AdvectionAcceleration(Equation):
    def __init__(self, dest, sources, gx=0.0, gy=0.0, gz=0.0):
        self.gx = gx
        self.gy = gy
        self.gz = gz
        super(AdvectionAcceleration, self).__init__(dest, sources)

    def initialize(self, d_idx, d_au, d_av, d_aw, d_uadv, d_vadv,
                   d_wadv):
        d_au[d_idx] = self.gx
        d_av[d_idx] = self.gy
        d_aw[d_idx] = self.gz
        d_uadv[d_idx] = 0.0
        d_vadv[d_idx] = 0.0
        d_wadv[d_idx] = 0.0

    def post_loop(self, d_idx, d_au, d_av, d_aw, d_uadv, d_vadv,
                  d_wadv, d_u, d_v, d_w, dt):
        d_uadv[d_idx] = d_u[d_idx] + dt * d_au[d_idx]
        d_vadv[d_idx] = d_v[d_idx] + dt * d_av[d_idx]
        d_wadv[d_idx] = d_w[d_idx] + dt * d_aw[d_idx]


class ViscosityAcceleration(Equation):
    def __init__(self, dest, sources, nu):
        self.nu = nu
        super(ViscosityAcceleration, self).__init__(dest, sources)

    def loop(self, d_idx, d_au, d_av, d_aw, s_idx, s_m, EPS,
             VIJ, XIJ, RHOIJ1, R2IJ, DWIJ):
        dwijdotxij = (DWIJ[0] * XIJ[0] + DWIJ[1] * XIJ[1] +
                      DWIJ[2] * XIJ[2])
        fac = 2.0 * self.nu * s_m[s_idx] * RHOIJ1 * dwijdotxij / \
            (R2IJ + EPS)
        d_au[d_idx] += fac * VIJ[0]
        d_av[d_idx] += fac * VIJ[1]
        d_aw[d_idx] += fac * VIJ[2]


class ViscosityAccelerationBoundary(Equation):
    def __init__(self, dest, sources, rho0, nu):
        self.nu = nu
        self.rho0 = rho0
        super(ViscosityAccelerationBoundary, self).__init__(dest, sources)

    def loop(self, d_idx, d_au, d_av, d_aw, d_rho, s_idx, s_V, EPS,
             VIJ, XIJ, R2IJ, DWIJ):
        phi_b = self.rho0 / (s_V[s_idx] * d_rho[d_idx])
        dwijdotxij = (DWIJ[0] * XIJ[0] + DWIJ[1] * XIJ[1] +
                      DWIJ[2] * XIJ[2])
        fac = 2.0 * self.nu * phi_b * dwijdotxij / (R2IJ + EPS)
        d_au[d_idx] += fac * VIJ[0]
        d_av[d_idx] += fac * VIJ[1]
        d_aw[d_idx] += fac * VIJ[2]


class ComputeDII(Equation):
    def initialize(self, d_idx, d_dii0, d_dii1, d_dii2):
        d_dii0[d_idx] = 0.0
        d_dii1[d_idx] = 0.0
        d_dii2[d_idx] = 0.0

    def loop(self, d_idx, d_rho, d_dii0, d_dii1, d_dii2,
             s_idx, s_m, DWIJ):
        rho_1 = 1.0 / d_rho[d_idx]
        fac = -s_m[s_idx] * rho_1 * rho_1
        d_dii0[d_idx] += fac * DWIJ[0]
        d_dii1[d_idx] += fac * DWIJ[1]
        d_dii2[d_idx] += fac * DWIJ[2]


class ComputeDIIBoundary(Equation):
    def __init__(self, dest, sources, rho0):
        self.rho0 = rho0
        super(ComputeDIIBoundary, self).__init__(dest, sources)

    def loop(self, d_idx, d_dii0, d_dii1, d_dii2, d_rho,
             s_idx, s_m, s_V, DWIJ):
        rhoi1 = 1.0 / d_rho[d_idx]
        fac = -rhoi1 * rhoi1 * self.rho0 / s_V[s_idx]
        d_dii0[d_idx] += fac * DWIJ[0]
        d_dii1[d_idx] += fac * DWIJ[1]
        d_dii2[d_idx] += fac * DWIJ[2]


class ComputeRhoAdvection(Equation):
    def initialize(self, d_idx, d_rho_adv, d_rho, d_p0, d_p, d_piter,
                   d_aii):
        d_rho_adv[d_idx] = d_rho[d_idx]
        d_p0[d_idx] = d_p[d_idx]
        d_piter[d_idx] = 0.5 * d_p[d_idx]

    def loop(self, d_idx, d_rho, d_rho_adv, d_uadv, d_vadv, d_wadv,
             d_u, d_v, d_w, s_idx, s_m, s_uadv, s_vadv, s_wadv, DWIJ,
             dt):
        vijdotdwij = ((d_uadv[d_idx] - s_uadv[s_idx]) * DWIJ[0] +
                      (d_vadv[d_idx] - s_vadv[s_idx]) * DWIJ[1] +
                      (d_wadv[d_idx] - s_wadv[s_idx]) * DWIJ[2])
        d_rho_adv[d_idx] += dt * s_m[s_idx] * vijdotdwij


class ComputeRhoBoundary(Equation):
    def __init__(self, dest, sources, rho0):
        self.rho0 = rho0
        super(ComputeRhoBoundary, self).__init__(dest, sources)

    def loop(self, d_idx, d_rho, d_rho_adv, d_uadv, d_vadv, d_wadv,
             s_idx, s_u, s_v, s_w, s_V, WIJ, DWIJ, dt):
        phi_b = self.rho0 / s_V[s_idx]
        vijdotdwij = ((d_uadv[d_idx] - s_u[s_idx]) * DWIJ[0] +
                      (d_vadv[d_idx] - s_v[s_idx]) * DWIJ[1] +
                      (d_wadv[d_idx] - s_w[s_idx]) * DWIJ[2])
        d_rho_adv[d_idx] += dt * phi_b * vijdotdwij


class ComputeAII(Equation):
    def initialize(self, d_idx, d_aii):
        d_aii[d_idx] = 0.0

    def loop(self, d_idx, d_aii, d_dii0, d_dii1, d_dii2, d_m, d_rho,
             s_idx, s_m, s_rho, DWIJ):
        rho1 = 1.0 / d_rho[d_idx]
        fac = d_m[d_idx] * rho1 * rho1
        dijdotdwij = ((d_dii0[d_idx] - fac * DWIJ[0]) * DWIJ[0] +
                      (d_dii1[d_idx] - fac * DWIJ[1]) * DWIJ[1] +
                      (d_dii2[d_idx] - fac * DWIJ[2]) * DWIJ[2])
        d_aii[d_idx] += s_m[s_idx] * dijdotdwij


class ComputeAIIBoundary(Equation):
    """The wall's contribution to ``aii``."""

    def __init__(self, dest, sources, rho0):
        self.rho0 = rho0
        super(ComputeAIIBoundary, self).__init__(dest, sources)

    def loop(self, d_idx, d_m, d_aii, d_dii0, d_dii1, d_dii2, d_rho,
             s_idx, s_m, s_V, DWIJ):
        phi_b = self.rho0 / s_V[s_idx]
        rho1 = 1.0 / d_rho[d_idx]
        fac = d_m[d_idx] * rho1 * rho1
        dijdotdwij = ((d_dii0[d_idx] - fac * DWIJ[0]) * DWIJ[0] +
                      (d_dii1[d_idx] - fac * DWIJ[1]) * DWIJ[1] +
                      (d_dii2[d_idx] - fac * DWIJ[2]) * DWIJ[2])
        d_aii[d_idx] += phi_b * dijdotdwij


class ComputeDIJPJ(Equation):
    def initialize(self, d_idx, d_dijpj0, d_dijpj1, d_dijpj2):
        d_dijpj0[d_idx] = 0.0
        d_dijpj1[d_idx] = 0.0
        d_dijpj2[d_idx] = 0.0

    def loop(self, d_idx, d_dijpj0, d_dijpj1, d_dijpj2,
             s_idx, s_m, s_rho, s_piter, DWIJ):
        rho1 = 1.0 / s_rho[s_idx]
        fac = -s_m[s_idx] * rho1 * rho1 * s_piter[s_idx]
        d_dijpj0[d_idx] += fac * DWIJ[0]
        d_dijpj1[d_idx] += fac * DWIJ[1]
        d_dijpj2[d_idx] += fac * DWIJ[2]


class PressureSolve(Equation):
    """One relaxed-Jacobi sweep.  ``reduce`` writes the compressed
    particles' count and their compression's sum into ``tmp_comp`` on the
    device, and ``converged`` compares their mean with ``rho0``."""

    def __init__(self, dest, sources, rho0, omega=0.5,
                 tolerance=1e-2, debug=False):
        self.rho0 = rho0
        self.omega = omega
        self.debug = debug
        self.tolerance = tolerance
        super(PressureSolve, self).__init__(dest, sources)

    def initialize(self, d_idx, d_p, d_compression):
        d_p[d_idx] = 0.0
        d_compression[d_idx] = 0.0

    def loop(self, d_idx, d_p, d_piter, d_rho, d_m, d_dijpj0, d_dijpj1,
             d_dijpj2, s_idx, s_m, s_dii0, s_dii1, s_dii2,
             s_piter, s_dijpj0, s_dijpj1, s_dijpj2, DWIJ):
        rho1 = 1.0 / d_rho[d_idx]
        fac = d_m[d_idx] * rho1 * rho1 * d_piter[d_idx]
        djkpk0 = s_dijpj0[s_idx] - fac * DWIJ[0]
        djkpk1 = s_dijpj1[s_idx] - fac * DWIJ[1]
        djkpk2 = s_dijpj2[s_idx] - fac * DWIJ[2]
        tmp0 = d_dijpj0[d_idx] - s_dii0[s_idx] * s_piter[s_idx] - djkpk0
        tmp1 = d_dijpj1[d_idx] - s_dii1[s_idx] * s_piter[s_idx] - djkpk1
        tmp2 = d_dijpj2[d_idx] - s_dii2[s_idx] * s_piter[s_idx] - djkpk2
        tmpdotdwij = (tmp0 * DWIJ[0] + tmp1 * DWIJ[1] + tmp2 * DWIJ[2])
        d_p[d_idx] += s_m[s_idx] * tmpdotdwij

    def post_loop(self, d_idx, d_piter, d_p0, d_p, d_aii, d_rho_adv,
                  d_rho, d_compression, dt):
        dt2 = dt * dt
        tmp = self.rho0 - d_rho_adv[d_idx] - d_p[d_idx] * dt2
        dnr = d_aii[d_idx] * dt2
        ok = torch.abs(dnr) > 1e-9
        safe_dnr = torch.where(ok, dnr, 1.0)
        p = torch.where(
            ok, torch.clamp((1.0 - self.omega) * d_piter[d_idx] +
                            self.omega / safe_dnr * tmp, min=0.0),
            0.0)
        d_compression[d_idx] = torch.where(
            p != 0.0, torch.abs(p * dnr - tmp) + self.rho0, self.rho0)
        d_piter[d_idx] = p
        d_p[d_idx] = p

    def reduce(self, dst, t, dt):
        comp = dst.compression[:]
        mask = dst.mask if dst.mask is not None else dst.active
        count = (mask & (comp > 0)).to(comp.dtype).sum()
        total = torch.where(mask, comp, 0.0).sum()
        dst.tmp_comp[0] = count
        dst.tmp_comp[1] = total

    def converged(self, dst):
        count = dst.tmp_comp[0]
        total = dst.tmp_comp[1]
        avg_rho = torch.where(count > 0,
                              total / torch.clamp(count, min=1.0),
                              self.rho0)
        compression = torch.abs(avg_rho - self.rho0) / self.rho0
        return torch.where(compression > self.tolerance, -1.0, 1.0)


class PressureSolveBoundary(Equation):
    def __init__(self, dest, sources, rho0):
        self.rho0 = rho0
        super(PressureSolveBoundary, self).__init__(dest, sources)

    def loop(self, d_idx, d_p, d_rho, d_dijpj0, d_dijpj1, d_dijpj2,
             s_idx, s_V, DWIJ):
        phi_b = self.rho0 / s_V[s_idx]
        dijdotwij = (d_dijpj0[d_idx] * DWIJ[0] +
                     d_dijpj1[d_idx] * DWIJ[1] +
                     d_dijpj2[d_idx] * DWIJ[2])
        d_p[d_idx] += phi_b * dijdotwij


class PressureForce(Equation):
    def initialize(self, d_idx, d_au, d_av, d_aw):
        d_au[d_idx] = 0.0
        d_av[d_idx] = 0.0
        d_aw[d_idx] = 0.0

    def loop(self, d_idx, d_rho, d_p, d_au, d_av, d_aw,
             s_idx, s_m, s_rho, s_p, DWIJ):
        rhoi1 = 1.0 / d_rho[d_idx]
        rhoj1 = 1.0 / s_rho[s_idx]
        fac = -s_m[s_idx] * (d_p[d_idx] * rhoi1 * rhoi1 +
                             s_p[s_idx] * rhoj1 * rhoj1)
        d_au[d_idx] += fac * DWIJ[0]
        d_av[d_idx] += fac * DWIJ[1]
        d_aw[d_idx] += fac * DWIJ[2]

    def post_loop(self, d_idx, d_au, d_av, d_aw,
                  d_uadv, d_vadv, d_wadv, d_dt_cfl, d_dt_force):
        fac = (d_au[d_idx] * d_au[d_idx] + d_av[d_idx] * d_av[d_idx] +
               d_aw[d_idx] * d_aw[d_idx])
        vmag = torch.sqrt(d_uadv[d_idx] * d_uadv[d_idx] +
                          d_vadv[d_idx] * d_vadv[d_idx] +
                          d_wadv[d_idx] * d_wadv[d_idx])
        d_dt_cfl[d_idx] = 2.0 * vmag
        d_dt_force[d_idx] = 2.0 * fac


class PressureForceBoundary(Equation):
    def __init__(self, dest, sources, rho0):
        self.rho0 = rho0
        super(PressureForceBoundary, self).__init__(dest, sources)

    def loop(self, d_idx, d_rho, d_au, d_av, d_aw, d_p, s_idx, s_V,
             DWIJ):
        rho1 = 1.0 / d_rho[d_idx]
        fac = -d_p[d_idx] * rho1 * rho1 * self.rho0 / s_V[s_idx]
        d_au[d_idx] += fac * DWIJ[0]
        d_av[d_idx] += fac * DWIJ[1]
        d_aw[d_idx] += fac * DWIJ[2]


class IISPHScheme(Scheme):
    """The IISPH scheme: ``EulerIntegrator`` with ``IISPHStep`` and
    ``CubicSpline`` by default; walls (``solids``) take part through
    their number density ``V``."""

    def __init__(self, fluids, solids, dim, rho0, nu=0.0,
                 gx=0.0, gy=0.0, gz=0.0, omega=0.5, tolerance=1e-2,
                 debug=False, has_ghosts=False):
        self.fluids = fluids
        self.solids = solids
        self.dim = dim
        self.rho0 = rho0
        self.nu = nu
        self.gx = gx
        self.gy = gy
        self.gz = gz
        self.omega = omega
        self.tolerance = tolerance
        self.debug = debug
        self.has_ghosts = has_ghosts
        self.solver = None

    def add_user_options(self, group):
        group.add_argument(
            '--omega', action='store', type=float, dest='omega',
            default=None, help='Relaxation parameter for Jacobi '
            'iterations.')
        group.add_argument(
            '--tolerance', action='store', type=float, dest='tolerance',
            default=None, help='Convergence tolerance fraction.')
        add_bool_argument(group, 'iisph-debug', dest='debug',
                          help='Debug iteration convergence.',
                          default=None)

    def consume_user_options(self, options):
        data = dict((var, self._smart_getattr(options, var))
                    for var in ('omega', 'tolerance', 'debug'))
        self.configure(**data)

    def configure_solver(self, kernel=None, integrator_cls=None,
                         extra_steppers=None, **kw):
        from pysph_tpu_torch.base.kernels import CubicSpline
        from pysph_tpu_torch.sph.integrator import EulerIntegrator
        from pysph_tpu_torch.solver.solver import Solver
        if kernel is None:
            kernel = CubicSpline(dim=self.dim)
        steppers = dict(extra_steppers or {})
        for fluid in self.fluids:
            if fluid not in steppers:
                steppers[fluid] = IISPHStep()
        cls = integrator_cls if integrator_cls is not None else \
            EulerIntegrator
        integrator = cls(**steppers)
        self.solver = Solver(dim=self.dim, integrator=integrator,
                             kernel=kernel, **kw)

    def get_equations(self):
        equations = []
        if self.solids:
            equations.append(Group(equations=[
                NumberDensity(dest=x, sources=[x])
                for x in self.solids]))
        equations.append(Group(equations=[
            SummationDensity(dest=x, sources=self.fluids)
            for x in self.fluids], real=False))
        if self.solids:
            equations.append(Group(equations=[
                SummationDensityBoundary(dest=x, sources=self.solids,
                                         rho0=self.rho0)
                for x in self.fluids], real=False))

        eq = []
        for fluid in self.fluids:
            eq.append(AdvectionAcceleration(
                dest=fluid, sources=None, gx=self.gx, gy=self.gy,
                gz=self.gz))
            eq.append(ComputeDII(dest=fluid, sources=self.fluids))
            if self.nu > 0.0:
                eq.append(ViscosityAcceleration(
                    dest=fluid, sources=self.fluids, nu=self.nu))
            if self.solids:
                if self.nu > 0.0:
                    eq.append(ViscosityAccelerationBoundary(
                        dest=fluid, sources=self.solids, nu=self.nu,
                        rho0=self.rho0))
                eq.append(ComputeDIIBoundary(
                    dest=fluid, sources=self.solids, rho0=self.rho0))
        equations.append(Group(equations=eq, real=False))

        eq = []
        for fluid in self.fluids:
            eq.append(ComputeRhoAdvection(dest=fluid,
                                          sources=self.fluids))
            eq.append(ComputeAII(dest=fluid, sources=self.fluids))
            if self.solids:
                eq.append(ComputeRhoBoundary(
                    dest=fluid, sources=self.solids, rho0=self.rho0))
                eq.append(ComputeAIIBoundary(
                    dest=fluid, sources=self.solids, rho0=self.rho0))
        equations.append(Group(equations=eq))

        sg1 = Group(equations=[
            ComputeDIJPJ(dest=x, sources=self.fluids)
            for x in self.fluids])
        eq = []
        for fluid in self.fluids:
            eq.append(PressureSolve(
                dest=fluid, sources=self.fluids, rho0=self.rho0,
                omega=self.omega, tolerance=self.tolerance,
                debug=self.debug))
            if self.solids:
                eq.append(PressureSolveBoundary(
                    dest=fluid, sources=self.solids, rho0=self.rho0))
        sg2 = Group(equations=eq)
        equations.append(Group(equations=[sg1, sg2], iterate=True,
                               max_iterations=30, min_iterations=2))

        eq = []
        for fluid in self.fluids:
            eq.append(PressureForce(dest=fluid, sources=self.fluids))
            if self.solids:
                eq.append(PressureForceBoundary(
                    dest=fluid, sources=self.solids, rho0=self.rho0))
        equations.append(Group(equations=eq))
        return equations

    def setup_properties(self, particles, clean=True):
        from pysph_tpu_torch.base.utils import get_particle_array_iisph
        dummy = get_particle_array_iisph()
        props = set(dummy.properties.keys())
        for pa in particles:
            self._ensure_properties(pa, props, clean)
            for c, v in dummy.constants.items():
                if c not in pa.constants:
                    pa.add_constant(c, v)
            pa.set_output_arrays(dummy.output_property_arrays)


class UpdateGhostProps(Equation):
    """The reference's ghost copy; the grid has no mirrored ghosts, so a
    no-op kept for the API."""

    def __init__(self, dest, sources=None):
        super(UpdateGhostProps, self).__init__(dest, sources)

    def initialize(self, d_idx):
        pass


class UpdateGhostPressure(Equation):
    """The reference's ghost pressure copy: a no-op, as
    ``UpdateGhostProps``."""

    def initialize(self, d_idx):
        pass
