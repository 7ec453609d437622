"""Generalized Transport Velocity Formulation, Zhang, Hu & Adams 2017
(port of ``pysph_tpu/sph/wc/gtvf.py``).

Multi-stage: ``GTVFIntegrator`` evaluates two different sets of
equations per step, ``GTVFScheme.get_equations`` returns them as
``MultiStageEquations``.  ``sigma``, ``asigma`` and ``gradvhat`` are
stride-9 properties (3x3 tensors, row-major)."""

import torch

from pysph_tpu_torch.base.utils import get_particle_array
from pysph_tpu_torch.sph.equation import (
    Equation, Group, MultiStageEquations)
from pysph_tpu_torch.sph.integrator import Integrator
from pysph_tpu_torch.sph.integrator_step import IntegratorStep
from pysph_tpu_torch.sph.scheme import Scheme


def get_particle_array_gtvf(constants=None, **props):
    gtvf_props = [
        'uhat', 'vhat', 'what', 'rho0', 'rhodiv', 'p0', 'auhat',
        'avhat', 'awhat', 'arho', 'arho0']
    pa = get_particle_array(constants=constants,
                            additional_props=gtvf_props, **props)
    pa.add_property('gradvhat', stride=9)
    pa.add_property('sigma', stride=9)
    pa.add_property('asigma', stride=9)
    pa.set_output_arrays([
        'x', 'y', 'z', 'u', 'v', 'w', 'rho', 'p', 'h', 'm', 'au',
        'av', 'aw', 'pid', 'gid', 'tag'])
    return pa


class GTVFIntegrator(Integrator):
    """Three stages around two acceleration evaluators; eval 0 keeps the
    neighbour lists of the step (``update_nnps=False``)."""

    def one_timestep(self, t, dt):
        self.stage1()
        self.do_post_stage(dt, 1)
        self.compute_accelerations(0, update_nnps=False)
        self.stage2()
        self.update_domain()
        self.do_post_stage(dt, 2)
        self.compute_accelerations(1)
        self.stage3()
        self.do_post_stage(dt, 3)


class GTVFStep(IntegratorStep):
    """GTVF stepper: half-kick with the transport velocity, drift with
    ``uhat`` (and ``sigma`` with ``asigma``), half-kick."""

    def stage1(self, d_idx, d_u, d_v, d_w, d_au, d_av, d_aw, d_uhat,
               d_vhat, d_what, d_auhat, d_avhat, d_awhat, dt):
        dtb2 = 0.5 * dt
        d_u[d_idx] += dtb2 * d_au[d_idx]
        d_v[d_idx] += dtb2 * d_av[d_idx]
        d_w[d_idx] += dtb2 * d_aw[d_idx]
        d_uhat[d_idx] = d_u[d_idx] + dtb2 * d_auhat[d_idx]
        d_vhat[d_idx] = d_v[d_idx] + dtb2 * d_avhat[d_idx]
        d_what[d_idx] = d_w[d_idx] + dtb2 * d_awhat[d_idx]

    def stage2(self, d_idx, d_uhat, d_vhat, d_what, d_x, d_y, d_z,
               d_rho, d_arho, d_sigma, d_asigma, dt):
        d_rho[d_idx] += dt * d_arho[d_idx]
        for i in range(9):
            d_sigma[d_idx * 9 + i] += dt * d_asigma[d_idx * 9 + i]
        d_x[d_idx] += dt * d_uhat[d_idx]
        d_y[d_idx] += dt * d_vhat[d_idx]
        d_z[d_idx] += dt * d_what[d_idx]

    def stage3(self, d_idx, d_u, d_v, d_w, d_au, d_av, d_aw, dt):
        dtb2 = 0.5 * dt
        d_u[d_idx] += dtb2 * d_au[d_idx]
        d_v[d_idx] += dtb2 * d_av[d_idx]
        d_w[d_idx] += dtb2 * d_aw[d_idx]


class ContinuityEquationGTVF(Equation):
    """Density rate with the transport velocity, eq. (12)."""

    def initialize(self, d_arho, d_idx):
        d_arho[d_idx] = 0.0

    def loop(self, d_idx, s_idx, s_m, d_rho, s_rho, d_uhat, d_vhat,
             d_what, s_uhat, s_vhat, s_what, d_arho, DWIJ):
        uhatij = d_uhat[d_idx] - s_uhat[s_idx]
        vhatij = d_vhat[d_idx] - s_vhat[s_idx]
        whatij = d_what[d_idx] - s_what[s_idx]
        udotdij = (DWIJ[0] * uhatij + DWIJ[1] * vhatij +
                   DWIJ[2] * whatij)
        d_arho[d_idx] += d_rho[d_idx] * s_m[s_idx] / s_rho[s_idx] * \
            udotdij


class CorrectDensity(Equation):
    """Density correction, eq. (13).  A source whose ``rho0`` is 0 (a
    wall: no stepper sets it) makes ``rhodiv`` infinite, and the
    ``min(1, rhodiv)`` leaves rho uncorrected there, as in the
    reference."""

    def initialize(self, d_idx, d_rho, d_rho0, d_rhodiv):
        d_rho0[d_idx] = d_rho[d_idx]
        d_rho[d_idx] = 0.0
        d_rhodiv[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_rho, d_rhodiv, s_m, WIJ, s_rho0):
        d_rho[d_idx] += s_m[s_idx] * WIJ
        d_rhodiv[d_idx] += s_m[s_idx] * WIJ / s_rho0[s_idx]

    def post_loop(self, d_idx, d_rho, d_rhodiv):
        denom = torch.clamp(d_rhodiv[d_idx], max=1.0)
        d_rho[d_idx] = d_rho[d_idx] / torch.where(denom > 0, denom, 1.0)


class MomentumEquationPressureGradient(Equation):
    """GTVF momentum: pressure gradient, eq. (17), and the transport-
    velocity correction, eq. (22), with the kernel gradient at h/2."""

    def __init__(self, dest, sources, pref, gx=0.0, gy=0.0, gz=0.0):
        self.pref = pref
        self.gx = gx
        self.gy = gy
        self.gz = gz
        super(MomentumEquationPressureGradient, self).__init__(
            dest, sources)

    def initialize(self, d_idx, d_au, d_av, d_aw, d_auhat, d_avhat,
                   d_awhat, d_p0, d_p):
        d_au[d_idx] = self.gx
        d_av[d_idx] = self.gy
        d_aw[d_idx] = self.gz
        d_auhat[d_idx] = 0.0
        d_avhat[d_idx] = 0.0
        d_awhat[d_idx] = 0.0
        d_p0[d_idx] = torch.clamp(10 * torch.abs(d_p[d_idx]),
                                  max=self.pref)

    def loop(self, d_rho, s_rho, d_idx, s_idx, d_p, s_p, s_m, d_au,
             d_av, d_aw, DWIJ, d_p0, d_auhat, d_avhat, d_awhat, XIJ,
             RIJ, SPH_KERNEL, HIJ):
        rhoi2 = d_rho[d_idx] * d_rho[d_idx]
        rhoj2 = s_rho[s_idx] * s_rho[s_idx]
        pij = d_p[d_idx] / rhoi2 + s_p[s_idx] / rhoj2
        tmp = -s_m[s_idx] * pij
        d_au[d_idx] += tmp * DWIJ[0]
        d_av[d_idx] += tmp * DWIJ[1]
        d_aw[d_idx] += tmp * DWIJ[2]
        tmp = -d_p0[d_idx] * s_m[s_idx] / rhoi2
        dwijhat = SPH_KERNEL.gradient(XIJ, RIJ, 0.5 * HIJ)
        d_auhat[d_idx] += tmp * dwijhat[0]
        d_avhat[d_idx] += tmp * dwijhat[1]
        d_awhat[d_idx] += tmp * dwijhat[2]


class MomentumEquationViscosity(Equation):
    """GTVF laminar viscosity (the reference's factor 2 fixed)."""

    def __init__(self, dest, sources, nu):
        self.nu = nu
        super(MomentumEquationViscosity, self).__init__(dest, sources)

    def loop(self, d_idx, s_idx, d_rho, s_rho, s_m, d_au, d_av, d_aw,
             VIJ, R2IJ, EPS, DWIJ, XIJ):
        etai = self.nu * d_rho[d_idx]
        etaj = self.nu * s_rho[s_idx]
        etaij = 4 * (etai * etaj) / (etai + etaj)
        xdotdij = DWIJ[0] * XIJ[0] + DWIJ[1] * XIJ[1] + DWIJ[2] * XIJ[2]
        tmp = s_m[s_idx] / (d_rho[d_idx] * s_rho[s_idx])
        fac = tmp * etaij * xdotdij / (R2IJ + EPS)
        d_au[d_idx] += fac * VIJ[0]
        d_av[d_idx] += fac * VIJ[1]
        d_aw[d_idx] += fac * VIJ[2]


class MomentumEquationArtificialStress(Equation):
    """GTVF artificial stress of fluids: the divergence of
    ``v (x) (vhat - v)``."""

    def __init__(self, dest, sources, dim):
        self.dim = dim
        super(MomentumEquationArtificialStress, self).__init__(
            dest, sources)

    def loop(self, d_idx, s_idx, d_rho, s_rho, d_u, d_v, d_w, d_uhat,
             d_vhat, d_what, s_u, s_v, s_w, s_uhat, s_vhat, s_what,
             d_au, d_av, d_aw, s_m, DWIJ):
        rhoi = d_rho[d_idx]
        rhoj = s_rho[s_idx]
        ui = (d_u[d_idx], d_v[d_idx], d_w[d_idx])
        uj = (s_u[s_idx], s_v[s_idx], s_w[s_idx])
        uidif = (d_uhat[d_idx] - d_u[d_idx],
                 d_vhat[d_idx] - d_v[d_idx],
                 d_what[d_idx] - d_w[d_idx])
        ujdif = (s_uhat[s_idx] - s_u[s_idx],
                 s_vhat[s_idx] - s_v[s_idx],
                 s_what[s_idx] - s_w[s_idx])
        res = []
        for i in range(3):
            acc = 0.0
            for j in range(3):
                Aij = ui[i] * uidif[j] / rhoi + uj[i] * ujdif[j] / rhoj
                acc = acc + Aij * DWIJ[j]
            res.append(acc)
        d_au[d_idx] += s_m[s_idx] * res[0]
        d_av[d_idx] += s_m[s_idx] * res[1]
        d_aw[d_idx] += s_m[s_idx] * res[2]


class VelocityGradient(Equation):
    """Gradient of the transport velocity into the stride-9
    ``gradvhat``."""

    def __init__(self, dest, sources, dim):
        self.dim = dim
        super(VelocityGradient, self).__init__(dest, sources)

    def initialize(self, d_idx, d_gradvhat):
        for i in range(9):
            d_gradvhat[9 * d_idx + i] = 0.0

    def loop(self, s_idx, d_idx, s_m, d_uhat, d_vhat, d_what, s_uhat,
             s_vhat, s_what, s_rho, d_gradvhat, DWIJ):
        Vj = s_m[s_idx] / s_rho[s_idx]
        uhatij = (d_uhat[d_idx] - s_uhat[s_idx],
                  d_vhat[d_idx] - s_vhat[s_idx],
                  d_what[d_idx] - s_what[s_idx])
        for i in range(3):
            for j in range(3):
                d_gradvhat[d_idx * 9 + 3 * i + j] += \
                    Vj * uhatij[i] * DWIJ[j]


class DeviatoricStressRate(Equation):
    """Jaumann rate of the deviatoric stress of GTVF solids, eq. (5)."""

    def __init__(self, dest, sources, dim, G):
        self.G = G
        self.dim = dim
        super(DeviatoricStressRate, self).__init__(dest, sources)

    def initialize(self, d_idx, d_sigma, d_asigma, d_gradvhat):
        G = self.G
        dv = [[d_gradvhat[d_idx * 9 + 3 * i + j] for j in range(3)]
              for i in range(3)]
        sig = [[d_sigma[d_idx * 9 + 3 * i + j] for j in range(3)]
               for i in range(3)]
        eps = [[0.5 * (dv[i][j] + dv[j][i]) for j in range(3)]
               for i in range(3)]
        omega = [[0.5 * (dv[i][j] - dv[j][i]) for j in range(3)]
                 for i in range(3)]
        eps_trace = eps[0][0] + eps[1][1] + eps[2][2]
        for i in range(3):
            for j in range(3):
                smo = sum(sig[i][k] * omega[j][k] for k in range(3))
                oms = sum(omega[i][k] * sig[k][j] for k in range(3))
                val = 2 * G * eps[i][j] + smo + oms
                if i == j:
                    val = val - 2 * G * eps_trace / 3.0
                d_asigma[d_idx * 9 + 3 * i + j] = val


class MomentumEquationArtificialStressSolid(Equation):
    """Divergence of the stress of GTVF solids."""

    def __init__(self, dest, sources, dim):
        self.dim = dim
        super(MomentumEquationArtificialStressSolid, self).__init__(
            dest, sources)

    def loop(self, d_idx, s_idx, d_sigma, s_sigma, d_au, d_av, d_aw,
             s_m, DWIJ):
        res = []
        for i in range(3):
            acc = 0.0
            for j in range(3):
                sigmaij = d_sigma[d_idx * 9 + 3 * i + j] + \
                    s_sigma[s_idx * 9 + 3 * i + j]
                acc = acc + sigmaij * DWIJ[j]
            res.append(acc)
        d_au[d_idx] += s_m[s_idx] * res[0]
        d_av[d_idx] += s_m[s_idx] * res[1]
        d_aw[d_idx] += s_m[s_idx] * res[2]


class GTVFScheme(Scheme):
    """The GTVF scheme: fluids with ``GTVFStep``, walls with the Adami
    boundary conditions of ``transport_velocity``."""

    def __init__(self, fluids, solids, dim, rho0, c0, nu, h0, pref,
                 gx=0.0, gy=0.0, gz=0.0, b=1.0, alpha=0.0):
        self.fluids = fluids
        self.solids = solids
        self.dim = dim
        self.rho0 = rho0
        self.c0 = c0
        self.nu = nu
        self.h0 = h0
        self.pref = pref
        self.gx = gx
        self.gy = gy
        self.gz = gz
        self.b = b
        self.alpha = alpha
        self.solver = None

    def configure_solver(self, kernel=None, integrator_cls=None,
                         extra_steppers=None, **kw):
        from pysph_tpu_torch.base.kernels import WendlandQuintic
        from pysph_tpu_torch.solver.solver import Solver
        if kernel is None:
            kernel = WendlandQuintic(dim=self.dim)
        steppers = dict(extra_steppers or {})
        for fluid in self.fluids:
            if fluid not in steppers:
                steppers[fluid] = GTVFStep()
        cls = integrator_cls if integrator_cls is not None else \
            GTVFIntegrator
        self.solver = Solver(dim=self.dim, integrator=cls(**steppers),
                             kernel=kernel, **kw)

    def get_equations(self):
        from pysph_tpu_torch.sph.wc.transport_velocity import (
            ContinuitySolid, MomentumEquationArtificialViscosity,
            SetWallVelocity, SolidWallNoSlipBC, SolidWallPressureBC,
            StateEquation, VolumeSummation)
        all = self.fluids + self.solids
        stage1 = []
        if self.solids:
            stage1.append(Group(equations=[
                SetWallVelocity(dest=solid, sources=self.fluids)
                for solid in self.solids], real=False))
        eq1 = []
        for fluid in self.fluids:
            eq1.append(ContinuityEquationGTVF(dest=fluid,
                                              sources=self.fluids))
            if self.solids:
                eq1.append(ContinuitySolid(dest=fluid,
                                           sources=self.solids))
        stage1.append(Group(equations=eq1, real=False))

        stage2 = []
        stage2.append(Group(equations=[
            CorrectDensity(dest=fluid, sources=all)
            for fluid in self.fluids], real=False))
        stage2.append(Group(equations=[
            StateEquation(dest=fluid, sources=None, p0=self.pref,
                          rho0=self.rho0, b=1.0)
            for fluid in self.fluids], real=False))
        g2_s = []
        for solid in self.solids:
            g2_s.append(VolumeSummation(dest=solid, sources=all))
            g2_s.append(SolidWallPressureBC(
                dest=solid, sources=self.fluids, b=1.0, rho0=self.rho0,
                p0=self.pref, gx=self.gx, gy=self.gy, gz=self.gz))
        if g2_s:
            stage2.append(Group(equations=g2_s, real=False))
        eq4 = []
        for fluid in self.fluids:
            eq4.append(MomentumEquationPressureGradient(
                dest=fluid, sources=all, pref=self.pref, gx=self.gx,
                gy=self.gy, gz=self.gz))
            if self.alpha > 0.0:
                eq4.append(MomentumEquationArtificialViscosity(
                    dest=fluid, sources=all, c0=self.c0,
                    alpha=self.alpha))
            if self.nu > 0.0:
                eq4.append(MomentumEquationViscosity(
                    dest=fluid, sources=all, nu=self.nu))
                if self.solids:
                    eq4.append(SolidWallNoSlipBC(
                        dest=fluid, sources=self.solids, nu=self.nu))
            eq4.append(MomentumEquationArtificialStress(
                dest=fluid, sources=self.fluids, dim=self.dim))
        stage2.append(Group(equations=eq4, real=True))
        return MultiStageEquations([stage1, stage2])

    def setup_properties(self, particles, clean=True):
        particle_arrays = dict((p.name, p) for p in particles)
        dummy = get_particle_array_gtvf(name='junk')
        props = list(dummy.properties.keys())
        props += [dict(name=p, stride=v)
                  for p, v in dummy.stride.items() if v > 1]
        output_props = dummy.output_property_arrays
        for fluid in self.fluids:
            pa = particle_arrays[fluid]
            self._ensure_properties(pa, props, clean)
            pa.set_output_arrays(output_props)
        solid_props = ['uf', 'vf', 'wf', 'vg', 'ug', 'wij', 'wg', 'V']
        props += solid_props
        for solid in self.solids:
            pa = particle_arrays[solid]
            self._ensure_properties(pa, props, clean)
            pa.set_output_arrays(output_props)
