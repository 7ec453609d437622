"""TSPH, the 'traditional SPH' grad-h gas-dynamics scheme of Hopkins'
comparison (port of ``pysph_tpu/sph/gas_dynamics/tsph.py``).

- ``SummationDensity``: the summation density and number density with
  their grad-h terms; with ``density_iterations`` its ``post_loop`` takes
  one Newton-Raphson step of each unconverged particle's h towards ``n =
  (hfact / h)^dim`` (clipped to [0.8 h, 1.2 h], the change measured
  against ``h0``) until that particle's own ``converged`` flag is set,
  and ``converged(dst)`` holds once every particle's is;
- ``IdealGasEOS``: TSPH's own, a ``post_loop``;
- ``VelocityGradDivC1``: the first-order-consistent velocity gradient,
  ``gradv`` times the inverse of ``invtt`` (both stride 9, row-major 3 x
  3), the inverse in closed form (cofactors) on the ``dim x dim`` block,
  the identity where ``|det| <= 1e-12`` (the padded 3 x 3 determinant of
  the JAX package is the block's), and ``divv`` its trace;
- ``BalsaraSwitch``: ``alpha`` from ``divv`` and the curl of ``gradv``;
- ``MomentumAndEnergy``: Monaghan's viscosity on approaching pairs and the
  grad-h pressure terms;
- ``PECStep`` and ``TSPHScheme``.

On the kernel engine the pair terms run in ``tsph_pair``
(``ops/tsph_pair.py``): the iterated density group is a ``SweepPlan``
(each sweep one gated ``tsph_sweep`` launch, ``ops/pair_engine.py::
plan_sweep``), the velocity gradient's and the momentum's sums are its
other two sets, and the ``post_loop`` methods below stay elementwise
torch ops.  The closed-form inverse reads nothing back, so a chunk's CUDA
graph takes it (``torch.linalg``'s ``info`` check would read the card).
"""

import torch

from pysph_tpu_torch.sph.equation import Equation
from pysph_tpu_torch.sph.integrator_step import IntegratorStep
from pysph_tpu_torch.sph.scheme import Scheme, _check_gas_ported

#: ``|det(invtt)|`` at or below which ``VelocityGradDivC1`` takes the
#: identity
DET_MIN = 1e-12


class SummationDensity(Equation):
    """Summation density and number density with the grad-h terms, and,
    with ``density_iterations``, a Newton-Raphson step of each
    unconverged particle's h a sweep."""

    def __init__(self, dest, sources, dim, density_iterations=False,
                 iterate_only_once=False, hfact=1.2, htol=1e-6):
        self.density_iterations = density_iterations
        self.iterate_only_once = iterate_only_once
        self.dim = dim
        self.hfact = hfact
        self.htol = htol
        super(SummationDensity, self).__init__(dest, sources)

    def initialize(self, d_idx, d_rho, d_arho, d_drhosumdh, d_n,
                   d_dndh, d_prevn, d_prevdndh, d_prevdrhosumdh, d_an):
        d_rho[d_idx] = 0.0
        d_arho[d_idx] = 0.0
        d_prevn[d_idx] = d_n[d_idx]
        d_prevdrhosumdh[d_idx] = d_drhosumdh[d_idx]
        d_prevdndh[d_idx] = d_dndh[d_idx]
        d_drhosumdh[d_idx] = 0.0
        d_n[d_idx] = 0.0
        d_an[d_idx] = 0.0
        d_dndh[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_rho, d_arho, d_drhosumdh, s_m, VIJ,
             WI, DWI, GHI, d_n, d_dndh, d_h, d_prevn, d_prevdndh,
             d_prevdrhosumdh, d_an):
        mj = s_m[s_idx]
        vijdotdwij = (VIJ[0] * DWI[0] + VIJ[1] * DWI[1] +
                      VIJ[2] * DWI[2])
        d_rho[d_idx] += mj * WI

        hibynidim = d_h[d_idx] / (d_prevn[d_idx] * self.dim)
        inbrkti = 1 + d_prevdndh[d_idx] * hibynidim
        inprthsi = d_prevdrhosumdh[d_idx] * hibynidim
        fij = 1 - inprthsi / (s_m[s_idx] * inbrkti)
        vijdotdwij_fij = vijdotdwij * fij
        d_arho[d_idx] += mj * vijdotdwij_fij
        d_an[d_idx] += vijdotdwij_fij

        d_drhosumdh[d_idx] += mj * GHI
        d_n[d_idx] += WI
        d_dndh[d_idx] += GHI

    def post_loop(self, d_idx, d_h0, d_h, d_ah, d_converged, d_n,
                  d_dndh, d_an):
        if not self.density_iterations:
            return
        active = d_converged[d_idx] != 1
        hi = d_h[d_idx]
        hi0 = d_h0[d_idx]
        ni = (self.hfact / hi) ** self.dim
        dndhi = -self.dim * d_n[d_idx] / hi
        func = d_n[d_idx] - ni
        dfdh = d_dndh[d_idx] - dndhi
        dfdh = torch.where(dfdh != 0.0, dfdh, 1.0)
        hnew = torch.minimum(torch.maximum(hi - func / dfdh, 0.8 * hi),
                             1.2 * hi)
        diff = torch.abs(hnew - hi) / hi0
        if self.iterate_only_once:
            done = torch.ones_like(active)
        else:
            done = diff < self.htol
        d_h[d_idx] = torch.where(active & ~done, hnew, hi)
        d_ah[d_idx] = torch.where(active & done, d_an[d_idx] / dndhi,
                                  d_ah[d_idx])
        d_converged[d_idx] = torch.where(
            active & done, 1.0,
            torch.where(active, 0.0, d_converged[d_idx]))

    def converged(self, dst):
        if not self.density_iterations:
            return 1.0
        all_done = torch.where(dst.active, dst.converged[:] == 1,
                               True).all()
        return torch.where(all_done, 1.0, -1.0)


class IdealGasEOS(Equation):
    """p = (gamma - 1) rho e, and the sound speed (TSPH's: a
    ``post_loop``)."""

    def __init__(self, dest, sources, gamma):
        self.gamma = gamma
        self.gamma1 = gamma - 1.0
        super(IdealGasEOS, self).__init__(dest, sources)

    def post_loop(self, d_idx, d_p, d_rho, d_e, d_cs):
        d_p[d_idx] = self.gamma1 * d_rho[d_idx] * d_e[d_idx]
        d_cs[d_idx] = torch.sqrt(self.gamma * d_p[d_idx] /
                                 d_rho[d_idx])


def _minor(t, r0, r1, c0, c1):
    return t[:, 3 * r0 + c0] * t[:, 3 * r1 + c1] - \
        t[:, 3 * r0 + c1] * t[:, 3 * r1 + c0]


def inverse_block(tt, dim):
    """The inverse of the ``dim x dim`` block of the row-major 3 x 3
    matrices ``tt`` (n, 9), in closed form (cofactors): ({(r, c): (n,)}
    for r, c < dim, and the determinant), the identity where ``|det| <=
    DET_MIN``."""
    if dim == 1:
        det = tt[:, 0]
        cof = {(0, 0): torch.ones_like(det)}
    elif dim == 2:
        det = _minor(tt, 0, 1, 0, 1)
        cof = {(0, 0): tt[:, 4], (0, 1): -tt[:, 1], (1, 0): -tt[:, 3],
               (1, 1): tt[:, 0]}
    else:
        # the cofactor of (c, r) over the determinant is inverse (r, c)
        c00, c01, c02 = (_minor(tt, 1, 2, 1, 2), -_minor(tt, 1, 2, 0, 2),
                         _minor(tt, 1, 2, 0, 1))
        det = tt[:, 0] * c00 + tt[:, 1] * c01 + tt[:, 2] * c02
        cof = {(0, 0): c00, (1, 0): c01, (2, 0): c02,
               (0, 1): -_minor(tt, 0, 2, 1, 2), (1, 1): _minor(tt, 0, 2, 0, 2),
               (2, 1): -_minor(tt, 0, 2, 0, 1), (0, 2): _minor(tt, 0, 1, 1, 2),
               (1, 2): -_minor(tt, 0, 1, 0, 2), (2, 2): _minor(tt, 0, 1, 0, 1)}
    good = torch.abs(det) > DET_MIN
    safe = torch.where(good, det, 1.0)
    inv = {}
    for (r, c), v in cof.items():
        eye = 1.0 if r == c else 0.0
        inv[r, c] = torch.where(good, v / safe, eye)
    return inv, det


class VelocityGradDivC1(Equation):
    """First-order-consistent velocity gradient: ``gradv`` times the
    inverse of ``invtt`` (reference tsph.py:362)."""

    def __init__(self, dest, sources, dim):
        self.dim = dim
        super(VelocityGradDivC1, self).__init__(dest, sources)

    def initialize(self, d_gradv, d_idx, d_invtt, d_divv):
        d_gradv.assign(0.0)
        d_invtt.assign(0.0)
        d_divv[d_idx] = 0.0

    def loop(self, d_idx, d_invtt, s_m, s_idx, VIJ, DWI, XIJ, d_gradv):
        for row in range(self.dim):
            for col in range(self.dim):
                k = 9 * d_idx + row * 3 + col
                d_invtt[k] += -s_m[s_idx] * XIJ[row] * DWI[col]
                d_gradv[k] += -s_m[s_idx] * VIJ[row] * DWI[col]

    def post_loop(self, d_idx, d_gradv, d_invtt, d_divv):
        dim = self.dim
        gv = d_gradv.whole()
        inv, _ = inverse_block(d_invtt.whole(), dim)
        new = gv.clone()
        div = torch.zeros_like(gv[:, 0])
        for r in range(dim):
            for c in range(dim):
                s = gv[:, 3 * r] * inv[0, c]
                for j in range(1, dim):
                    s = s + gv[:, 3 * r + j] * inv[j, c]
                new[:, 3 * r + c] = s
            div = div + new[:, 4 * r]
        d_divv[d_idx] = div
        d_gradv.assign(new)


class BalsaraSwitch(Equation):
    """Balsara's switch on ``alpha`` (reference tsph.py:429)."""

    def __init__(self, dest, sources, alphaav, fkern):
        self.alphaav = alphaav
        self.fkern = fkern
        super(BalsaraSwitch, self).__init__(dest, sources)

    def post_loop(self, d_h, d_idx, d_cs, d_divv, d_gradv, d_alpha):
        curl = [
            d_gradv[9 * d_idx + 3 * 2 + 1] -
            d_gradv[9 * d_idx + 3 * 1 + 2],
            d_gradv[9 * d_idx + 3 * 0 + 2] -
            d_gradv[9 * d_idx + 3 * 2 + 0],
            d_gradv[9 * d_idx + 3 * 1 + 0] -
            d_gradv[9 * d_idx + 3 * 0 + 1],
        ]
        abscurlv = torch.sqrt(curl[0] ** 2 + curl[1] ** 2 + curl[2] ** 2)
        absdivv = torch.abs(d_divv[d_idx])
        fhi = d_h[d_idx] * self.fkern
        d_alpha[d_idx] = self.alphaav * absdivv / (
            absdivv + abscurlv + 0.0001 * d_cs[d_idx] / fhi)


class MomentumAndEnergy(Equation):
    """grad-h momentum and energy with Monaghan's viscosity
    (reference tsph.py:457)."""

    def __init__(self, dest, sources, dim, fkern, beta=2.0):
        self.beta = beta
        self.dim = dim
        self.fkern = fkern
        super(MomentumAndEnergy, self).__init__(dest, sources)

    def initialize(self, d_idx, d_au, d_av, d_aw, d_ae):
        d_au[d_idx] = 0.0
        d_av[d_idx] = 0.0
        d_aw[d_idx] = 0.0
        d_ae[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_m, s_m, d_p, s_p, d_cs, s_cs,
             d_rho, s_rho, d_au, d_av, d_aw, d_ae, XIJ, VIJ, DWI, DWJ,
             HIJ, d_alpha, s_alpha, R2IJ, RHOIJ1, d_h, d_dndh, d_n,
             d_drhosumdh, s_h, s_dndh, s_n, s_drhosumdh):
        dim = self.dim
        pibrhoi2 = d_p[d_idx] / (d_rho[d_idx] * d_rho[d_idx])
        pjbrhoj2 = s_p[s_idx] / (s_rho[s_idx] * s_rho[s_idx])
        cij = 0.5 * (d_cs[d_idx] + s_cs[s_idx])
        mj = s_m[s_idx]
        hij = self.fkern * HIJ
        vijdotxij = (VIJ[0] * XIJ[0] + VIJ[1] * XIJ[1] +
                     VIJ[2] * XIJ[2])

        # artificial viscosity, only approaching pairs
        appr = vijdotxij <= 0.0
        alpha = 0.5 * (d_alpha[d_idx] + s_alpha[s_idx])
        muij = hij * vijdotxij / (R2IJ + 0.0001 * hij * hij)
        common = torch.where(
            appr, alpha * muij * (cij - self.beta * muij) * mj *
            RHOIJ1 / 2, 0.0)
        avi = [common * (DWI[i] + DWJ[i]) for i in range(3)]
        d_au[d_idx] += avi[0]
        d_av[d_idx] += avi[1]
        d_aw[d_idx] += avi[2]
        d_ae[d_idx] -= 0.5 * (VIJ[0] * avi[0] + VIJ[1] * avi[1] +
                              VIJ[2] * avi[2])

        # grad-h corrected pressure gradient
        hibynidim = d_h[d_idx] / (d_n[d_idx] * dim)
        inbrkti = 1 + d_dndh[d_idx] * hibynidim
        inprthsi = d_drhosumdh[d_idx] * hibynidim
        fij = 1 - inprthsi / (s_m[s_idx] * inbrkti)

        hjbynjdim = s_h[s_idx] / (s_n[s_idx] * dim)
        inbrktj = 1 + s_dndh[s_idx] * hjbynjdim
        inprthsj = s_drhosumdh[s_idx] * hjbynjdim
        fji = 1 - inprthsj / (d_m[d_idx] * inbrktj)

        comi = mj * pibrhoi2 * fij
        comj = mj * pjbrhoj2 * fji
        d_au[d_idx] -= comi * DWI[0] + comj * DWJ[0]
        d_av[d_idx] -= comi * DWI[1] + comj * DWJ[1]
        d_aw[d_idx] -= comi * DWI[2] + comj * DWJ[2]
        vijdotdwi = (VIJ[0] * DWI[0] + VIJ[1] * DWI[1] +
                     VIJ[2] * DWI[2])
        d_ae[d_idx] += comi * vijdotdwi


class PECStep(IntegratorStep):
    """Gas-dynamics PEC modified for TSPH (reference tsph.py:674): h, rho
    and the number density n advance in the predictor."""

    def initialize(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z, d_h,
                   d_u0, d_v0, d_w0, d_u, d_v, d_w, d_e, d_e0, d_h0,
                   d_converged, d_rho, d_rho0, d_n, d_n0):
        d_x0[d_idx] = d_x[d_idx]
        d_y0[d_idx] = d_y[d_idx]
        d_z0[d_idx] = d_z[d_idx]
        d_u0[d_idx] = d_u[d_idx]
        d_v0[d_idx] = d_v[d_idx]
        d_w0[d_idx] = d_w[d_idx]
        d_e0[d_idx] = d_e[d_idx]
        d_h0[d_idx] = d_h[d_idx]
        d_rho0[d_idx] = d_rho[d_idx]
        d_n0[d_idx] = d_n[d_idx]
        d_converged[d_idx] = 0.0

    def stage1(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z, d_u0,
               d_v0, d_w0, d_u, d_v, d_w, d_e0, d_e, d_au, d_av, d_aw,
               d_ae, d_rho, d_rho0, d_arho, d_h, d_h0, d_ah, dt, d_n,
               d_n0, d_an):
        dtb2 = 0.5 * dt
        d_u[d_idx] = d_u0[d_idx] + dtb2 * d_au[d_idx]
        d_v[d_idx] = d_v0[d_idx] + dtb2 * d_av[d_idx]
        d_w[d_idx] = d_w0[d_idx] + dtb2 * d_aw[d_idx]
        d_x[d_idx] = d_x0[d_idx] + dtb2 * d_u[d_idx]
        d_y[d_idx] = d_y0[d_idx] + dtb2 * d_v[d_idx]
        d_z[d_idx] = d_z0[d_idx] + dtb2 * d_w[d_idx]
        d_e[d_idx] = d_e0[d_idx] + dtb2 * d_ae[d_idx]
        d_h[d_idx] = d_h0[d_idx] + dtb2 * d_ah[d_idx]
        d_rho[d_idx] = d_rho0[d_idx] + dtb2 * d_arho[d_idx]
        d_n[d_idx] = d_n0[d_idx] + dtb2 * d_an[d_idx]

    def stage2(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z, d_u0,
               d_v0, d_w0, d_u, d_v, d_w, d_e0, d_e, d_au, d_av, d_aw,
               d_ae, dt):
        d_u[d_idx] = d_u0[d_idx] + dt * d_au[d_idx]
        d_v[d_idx] = d_v0[d_idx] + dt * d_av[d_idx]
        d_w[d_idx] = d_w0[d_idx] + dt * d_aw[d_idx]
        d_x[d_idx] = d_x0[d_idx] + dt * d_u[d_idx]
        d_y[d_idx] = d_y0[d_idx] + dt * d_v[d_idx]
        d_z[d_idx] = d_z0[d_idx] + dt * d_w[d_idx]
        d_e[d_idx] = d_e0[d_idx] + dt * d_ae[d_idx]


class TSPHScheme(Scheme):
    """TSPH: the iterated number-density group (re-binned every sweep,
    at most ``max_density_iterations``), the EOS, the C1 velocity
    gradient with Balsara's switch, then the grad-h momentum and energy.
    ``PECIntegrator`` with ``PECStep`` and ``Gaussian`` by default (the
    kernels define no ``fkern``: 1.0).  Walls (``WallBoundary``) and ghost
    particles (``UpdateGhostProps``) are not ported: ``solids`` and
    ``has_ghosts`` raise."""

    def __init__(self, fluids, solids, dim, gamma, hfact, beta=2.0,
                 fkern=1.0, max_density_iterations=250, alphamax=1.0,
                 density_iteration_tolerance=1e-3, has_ghosts=False):
        self.fluids = fluids
        self.solids = solids
        self.dim = dim
        self.solver = None
        self.gamma = gamma
        self.beta = beta
        self.hfact = hfact
        self.density_iteration_tolerance = density_iteration_tolerance
        self.max_density_iterations = max_density_iterations
        self.has_ghosts = has_ghosts
        self.fkern = fkern
        self.alphamax = alphamax

    def add_user_options(self, group):
        group.add_argument('--alpha-max', action='store', type=float,
                           dest='alphamax', default=None,
                           help='alpha_max for the AV switch.')
        group.add_argument('--beta', action='store', type=float,
                           dest='beta', default=None,
                           help='beta for the artificial viscosity.')
        group.add_argument('--gamma', action='store', type=float,
                           dest='gamma', default=None,
                           help='gamma for the state equation.')

    def consume_user_options(self, options):
        data = dict((var, self._smart_getattr(options, var)) for var in
                    ('gamma', 'alphamax', 'beta'))
        self.configure(**data)

    def configure_solver(self, kernel=None, integrator_cls=None,
                         extra_steppers=None, **kw):
        from pysph_tpu_torch.base.kernels import Gaussian
        from pysph_tpu_torch.sph.integrator import PECIntegrator
        from pysph_tpu_torch.solver.solver import Solver
        _check_gas_ported(self)
        if kernel is None:
            kernel = Gaussian(dim=self.dim)
        self.fkern = getattr(kernel, 'fkern', 1.0)
        steppers = dict(extra_steppers or {})
        for name in self.fluids:
            if name not in steppers:
                steppers[name] = PECStep()
        cls = PECIntegrator if integrator_cls is None else integrator_cls
        integrator = cls(**steppers)
        self.solver = Solver(dim=self.dim, integrator=integrator,
                             kernel=kernel, **kw)

    def get_equations(self):
        from pysph_tpu_torch.sph.equation import Group
        _check_gas_ported(self)
        all_pa = self.fluids + self.solids
        equations = []
        equations.append(Group(equations=[
            SummationDensity(
                dest=f, sources=all_pa, hfact=self.hfact,
                density_iterations=True, dim=self.dim,
                htol=self.density_iteration_tolerance)
            for f in self.fluids],
            update_nnps=True, iterate=True,
            max_iterations=self.max_density_iterations))
        equations.append(Group(equations=[
            IdealGasEOS(dest=f, sources=None, gamma=self.gamma)
            for f in self.fluids]))
        g3 = []
        for f in self.fluids:
            g3.append(VelocityGradDivC1(dest=f, sources=all_pa,
                                        dim=self.dim))
            g3.append(BalsaraSwitch(dest=f, sources=None,
                                    alphaav=self.alphamax,
                                    fkern=self.fkern))
        equations.append(Group(equations=g3))
        equations.append(Group(equations=[
            MomentumAndEnergy(dest=f, sources=all_pa, dim=self.dim,
                              beta=self.beta, fkern=self.fkern)
            for f in self.fluids]))
        return equations

    def setup_properties(self, particles, clean=True):
        import numpy
        _check_gas_ported(self)
        particle_arrays = dict((p.name, p) for p in particles)
        props = ['rho', 'm', 'x', 'y', 'z', 'u', 'v', 'w', 'h', 'cs',
                 'p', 'e', 'au', 'av', 'aw', 'ae', 'pid', 'gid',
                 'tag', 'dwdh', 'h0', 'converged', 'ah', 'arho',
                 'dt_cfl', 'e0', 'rho0', 'u0', 'v0', 'w0', 'x0', 'y0',
                 'z0', 'alpha', 'drhosumdh', 'n', 'dndh', 'prevn',
                 'prevdndh', 'prevdrhosumdh', 'divv', 'an', 'n0']
        output_props = 'rho p u v w x y z e n divv h alpha'.split()
        for fluid in self.fluids:
            pa = particle_arrays[fluid]
            self._ensure_properties(pa, props, clean)
            pa.add_property('orig_idx', type='int')
            pa.add_property('n', data=numpy.asarray(pa.rho) /
                            numpy.asarray(pa.m))
            pa.add_property('gradv', stride=9)
            pa.add_property('invtt', stride=9)
            pa.orig_idx = numpy.arange(pa.get_number_of_particles())
            pa.set_output_arrays(output_props)
