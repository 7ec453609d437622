"""Conservative Reproducing Kernel SPH, Frontiere, Raskin & Owen 2017
(port of ``pysph_tpu/sph/wc/crksph.py``).

The reference's per-particle ``loop_all`` is two phases, as in
``pysph_tpu``: ``CRKSPHPreStep``'s pair phase sums each dest's moments
into the strided temporaries of ``_CRK_TEMPS``, and its ``post_loop``
solves the ``dim x dim`` systems of every particle at once for ``A_i``,
``B_i`` and their gradients, in closed form (``ops/crk_solve.py``:
cofactors, no ``torch.linalg`` call, whose ``info`` check reads the card
and would break a chunk's CUDA graph).  ``CRKSPHSymmetric`` rewrites the
pair symbols ``DWIJ``, ``DWI`` and ``DWJ`` with the corrected kernel
gradients for the equations after it in its group.

On the card the six pair phase sets of ``CRKSPHScheme`` run in
``csrc/crksph_pair.cu`` (``ops/crksph_pair.py``; the first evaluator's
five on one neighbour list) and the ``post_loop`` solve in
``csrc/crk_solve.cu``; the other per-particle phases are torch ops on
the state's device.

What ``pysph_tpu`` chose, kept here:

- ``cwij`` carries ``A_i``: the reference writes the pair factor
  ``A_i (1 + B_i . x_ij)`` into it for the next equation of the same
  pair, and ``SummationDensityCRKSPH`` recomputes that factor instead.
  ``pysph_tpu``'s pair engine takes ``d_cwij[d_idx] = ai`` as one
  per-particle assignment under the group's write mask; here it is the
  equation's ``initialize`` (``ai`` does not change within the group), so
  that the pair engines see a pure sum;
- ``_limiter`` pins ``rij = 1`` where ``|tmprj| <= 1e-30`` (the self pair
  divides 0 by 0 in the reference), and takes ``hi`` in both of its
  denominators, as ``pysph_tpu`` does;
- ``SummationDensityCRKSPH``'s ``post_loop`` divides only where ``rhofac``
  is not 0.
"""

import torch

from pysph_tpu_torch.base.utils import get_particle_array
from pysph_tpu_torch.ops.crk_solve import crk_solve
from pysph_tpu_torch.sph.equation import Equation, Group, MultiStageEquations
from pysph_tpu_torch.sph.integrator import Integrator
from pysph_tpu_torch.sph.integrator_step import IntegratorStep
from pysph_tpu_torch.sph.scheme import Scheme

#: the moments' temporaries and their strides (``pysph_tpu``'s)
_CRK_TEMPS = (('crk_m0', 1), ('crk_m1', 3), ('crk_m2', 9),
              ('crk_gm0', 3), ('crk_gm1', 9), ('crk_gm2', 27),
              ('crk_nnbr', 1))

class CRKSPHPreStep(Equation):
    """Accumulate the CRK moments and solve for A_i, B_i and their
    gradients (reference crksph.py:31)."""

    def __init__(self, dest, sources, dim=2):
        self.dim = dim
        super(CRKSPHPreStep, self).__init__(dest, sources)

    def initialize(self, d_idx, d_crk_m0, d_crk_m1, d_crk_m2, d_crk_gm0,
                   d_crk_gm1, d_crk_gm2, d_crk_nnbr):
        for prop in (d_crk_m0, d_crk_m1, d_crk_m2, d_crk_gm0, d_crk_gm1,
                     d_crk_gm2, d_crk_nnbr):
            prop.assign(0.0)

    def loop(self, d_idx, s_idx, s_V, d_crk_m0, d_crk_m1, d_crk_m2,
             d_crk_gm0, d_crk_gm1, d_crk_gm2, d_crk_nnbr, XIJ, WIJ,
             DWIJ):
        d = self.dim
        V = 1.0 / s_V[s_idx]
        # one count per neighbour, pair-shaped
        d_crk_nnbr[d_idx] += 1.0 + 0.0 * WIJ
        d_crk_m0[d_idx] += V * WIJ
        for alp in range(d):
            d_crk_m1[3 * d_idx + alp] += V * WIJ * XIJ[alp]
            for bet in range(d):
                d_crk_m2[9 * d_idx + d * alp + bet] += \
                    V * WIJ * XIJ[alp] * XIJ[bet]
        for gam in range(d):
            d_crk_gm0[3 * d_idx + gam] += V * DWIJ[gam]
            for alp in range(d):
                fac = 1.0 if alp == gam else 0.0
                d_crk_gm1[9 * d_idx + d * gam + alp] += \
                    V * (XIJ[alp] * DWIJ[gam] + fac * WIJ)
                for bet in range(d):
                    fac2 = 1.0 if bet == gam else 0.0
                    tmp = XIJ[alp] * fac2 + XIJ[bet] * fac
                    d_crk_gm2[27 * d_idx + d * d * gam + d * alp +
                              bet] += \
                        V * (XIJ[alp] * XIJ[bet] * DWIJ[gam] +
                             tmp * WIJ)

    def post_loop(self, d_idx, d_crk_m0, d_crk_m1, d_crk_m2, d_crk_gm0,
                  d_crk_gm1, d_crk_gm2, d_crk_nnbr, d_ai, d_gradai,
                  d_bi, d_gradbi):
        d = self.dim
        n = d_crk_m0.whole().shape[0]
        ai, gradai, bi, gradbi = crk_solve(
            d_crk_m0.whole(), d_crk_m1.whole()[:, :d],
            d_crk_m2.whole()[:, :d * d].reshape(n, d, d),
            d_crk_gm0.whole()[:, :d],
            d_crk_gm1.whole()[:, :d * d].reshape(n, d, d),
            d_crk_gm2.whole()[:, :d ** 3].reshape(n, d, d, d),
            d_crk_nnbr.whole(), d)
        # the first d components (gradbi: its 3 x 3 rows); the others
        # keep their values
        d_ai.assign(ai)
        for view, val in ((d_gradai, gradai), (d_bi, bi)):
            view.assign(torch.cat([val, view.whole()[:, d:]], dim=1))
        g = d_gradbi.whole().reshape(n, 3, 3).clone()
        g[:, :d, :d] = gradbi
        d_gradbi.assign(g.reshape(n, 9))


class CRKSPH(Equation):
    """Apply the CRK correction to DWIJ (reference crksph.py:170); ``cwij``
    takes ``A_i`` (see the module's docstring)."""

    def __init__(self, dest, sources, dim=2, tol=0.5):
        self.dim = dim
        self.tol = tol
        super(CRKSPH, self).__init__(dest, sources)

    def initialize(self, d_idx, d_cwij, d_ai):
        d_cwij[d_idx] = d_ai[d_idx]

    def loop(self, d_idx, s_idx, d_ai, d_gradai, d_bi, d_gradbi, WIJ,
             DWIJ, XIJ, HIJ):
        d = self.dim
        ai = d_ai[d_idx]
        eps = 1.0e-4 * HIJ
        bxij = 0.0
        for alp in range(d):
            bxij = bxij + d_bi[3 * d_idx + alp] * XIJ[alp]
        dbxij = []
        for gam in range(d):
            temp = 0.0
            for alp in range(d):
                temp = temp + \
                    d_gradbi[9 * d_idx + 3 * gam + alp] * XIJ[alp]
            dbxij.append(temp)
        res = []
        for gam in range(d):
            r = (ai * DWIJ[gam] +
                 d_gradai[3 * d_idx + gam] * WIJ) * (1 + bxij)
            r = r + ai * (dbxij[gam] + d_bi[3 * d_idx + gam]) * WIJ
            res.append(r)
        res_mag = sum(torch.abs(res[i]) for i in range(d))
        dwij_mag = sum(torch.abs(DWIJ[i]) for i in range(d))
        change = torch.abs(res_mag - dwij_mag) / (dwij_mag + eps)
        ok = change < self.tol
        for i in range(d):
            DWIJ[i] = torch.where(ok, res[i], DWIJ[i])


class CRKSPHSymmetric(Equation):
    """Symmetrized CRK-corrected kernel gradient; overwrites DWIJ, DWI
    and DWJ for the later equations of the group (reference
    crksph.py:280); ``cwij`` takes ``A_i`` (see the module's
    docstring)."""

    def __init__(self, dest, sources, dim=2, tol=0.5):
        self.dim = dim
        self.tol = tol
        super(CRKSPHSymmetric, self).__init__(dest, sources)

    def initialize(self, d_idx, d_cwij, d_ai):
        d_cwij[d_idx] = d_ai[d_idx]

    def loop(self, d_idx, s_idx, d_ai, d_gradai, d_bi, d_gradbi, s_ai,
             s_gradai, s_bi, s_gradbi, WIJ, DWIJ, XIJ, HIJ, WI, WJ, DWI,
             DWJ):
        d = self.dim
        ai = d_ai[d_idx]
        aj = s_ai[s_idx]
        wij = WI
        wji = WJ
        bxij = 0.0
        bxji = 0.0
        for alp in range(d):
            bxij = bxij + d_bi[3 * d_idx + alp] * XIJ[alp]
            bxji = bxji - s_bi[3 * s_idx + alp] * XIJ[alp]
        dbxij = []
        dbxji = []
        for gam in range(d):
            temp = 0.0
            temp1 = 0.0
            for alp in range(d):
                temp = temp + \
                    d_gradbi[9 * d_idx + 3 * gam + alp] * XIJ[alp]
                temp1 = temp1 - \
                    s_gradbi[9 * s_idx + 3 * gam + alp] * XIJ[alp]
            dbxij.append(temp)
            dbxji.append(temp1)
        for gam in range(d):
            temp = (ai * DWI[gam] +
                    d_gradai[3 * d_idx + gam] * wij) * (1 + bxij)
            temp = temp + ai * (dbxij[gam] +
                                d_bi[3 * d_idx + gam]) * wij
            # the reference's dwji is the gradient wrt x_i at hj: DWJ
            temp1 = (-aj * DWJ[gam] +
                     s_gradai[3 * s_idx + gam] * wji) * (1 + bxji)
            temp1 = temp1 + aj * (dbxji[gam] +
                                  s_bi[3 * s_idx + gam]) * wji
            DWIJ[gam] = 0.5 * (temp - temp1)
            DWI[gam] = temp
            DWJ[gam] = temp1


class NumberDensity(Equation):
    """V_i^{-1} = sum_j W_i (reference crksph.py:391)."""

    def initialize(self, d_idx, d_V):
        d_V[d_idx] = 0.0

    def loop(self, d_idx, d_V, WI):
        d_V[d_idx] += WI


class SummationDensityCRKSPH(Equation):
    """CRK summation density, eq. (76) (reference crksph.py:409)."""

    def initialize(self, d_idx, d_rho, d_rhofac):
        d_rho[d_idx] = 0.0
        d_rhofac[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_m, d_rho, d_rhofac, s_V, WIJ,
             d_ai, d_bi, XIJ):
        # the pair factor A_i (1 + B_i . x_ij), recomputed
        bxij = 0.0
        for alp in range(3):
            bxij = bxij + d_bi[3 * d_idx + alp] * XIJ[alp]
        cwij = d_ai[d_idx] * (1 + bxij)
        Vj = 1.0 / s_V[s_idx]
        fac = Vj * cwij * WIJ
        d_rho[d_idx] += d_m[d_idx] * fac
        d_rhofac[d_idx] += Vj * fac

    def post_loop(self, d_idx, d_rho, d_rhofac):
        rhofac = d_rhofac[d_idx]
        nz = rhofac != 0.0
        denom = torch.where(nz, rhofac, 1.0)
        d_rho[d_idx] = torch.where(nz, d_rho[d_idx] / denom, d_rho[d_idx])


class VelocityGradient(Equation):
    """CRK velocity gradient, eq. (74) (reference crksph.py:444)."""

    def __init__(self, dest, sources, dim):
        self.dim = dim
        super(VelocityGradient, self).__init__(dest, sources)

    def initialize(self, d_idx, d_gradv):
        d_gradv.assign(0.0)

    def loop(self, d_idx, s_idx, s_V, d_gradv, XIJ, DWIJ, VIJ, DWI):
        d = self.dim
        Vj = 1.0 / s_V[s_idx]
        for alp in range(d):
            for bet in range(d):
                d_gradv[9 * d_idx + d * alp + bet] += \
                    -Vj * VIJ[alp] * DWI[bet]


def _limiter(dim, d_gradv, s_gradv, d_idx, s_idx, XIJ, d_h, s_h,
             eta_crit, eta_fold, EPS, VIJU):
    """The artificial viscosity limiter of the momentum and energy
    equations (reference crksph.py:558/685): ``(mui, muj)``, ``rij = 1``
    where ``|tmprj| <= 1e-30``."""
    d = dim
    tmpri = 0.0
    tmprj = 0.0
    for alp in range(d):
        for bet in range(d):
            tmpri = tmpri + d_gradv[9 * d_idx + d * alp + bet] * \
                XIJ[alp] * XIJ[bet]
            tmprj = tmprj + s_gradv[9 * s_idx + d * alp + bet] * \
                XIJ[alp] * XIJ[bet]
    safe = torch.abs(tmprj) > 1e-30
    rij = torch.where(safe, tmpri / torch.where(safe, tmprj, 1.0), 1.0)

    tmprij = torch.clamp(4 * rij / ((1 + rij) * (1 + rij)), max=1.0)
    phiij = torch.clamp(tmprij, min=0.0)

    hi = d_h[d_idx]
    hj = s_h[s_idx]
    tmpxij = XIJ[0] ** 2 + XIJ[1] ** 2 + XIJ[2] ** 2
    tmpxij2 = torch.sqrt(tmpxij)
    etaij = torch.minimum(tmpxij2 / hi, tmpxij2 / hj)
    tmpphi = (etaij - eta_crit) / eta_fold
    phiij = torch.where(etaij < eta_crit,
                        phiij * torch.exp(-tmpphi * tmpphi), phiij)

    uijhat = []
    for alp in range(d):
        s = 0.0
        for bet in range(d):
            s = s + (d_gradv[9 * d_idx + d * alp + bet] +
                     s_gradv[9 * s_idx + d * alp + bet]) * XIJ[bet]
        uijhat.append(VIJU[alp] - 0.5 * phiij * s)

    udotx = sum(uijhat[i] * XIJ[i] for i in range(d))
    mui = torch.clamp(udotx / (tmpxij / hi + EPS * hi), max=0.0)
    muj = torch.clamp(udotx / (tmpxij / hi + EPS * hj), max=0.0)
    return mui, muj


class MomentumEquation(Equation):
    """CRKSPH momentum equation with the limited Monaghan Q
    (reference crksph.py:480)."""

    def __init__(self, dest, sources, dim, gx=0.0, gy=0.0, gz=0.0,
                 cl=2, cq=1, eta_crit=0.3, eta_fold=0.2, tol=0.5):
        self.dim = dim
        self.gx = gx
        self.gy = gy
        self.gz = gz
        self.cl = cl
        self.cq = cq
        self.eta_crit = eta_crit
        self.eta_fold = eta_fold
        self.tol = tol
        super(MomentumEquation, self).__init__(dest, sources)

    def initialize(self, d_idx, d_au, d_av, d_aw):
        d_au[d_idx] = self.gx
        d_av[d_idx] = self.gy
        d_aw[d_idx] = self.gz

    def loop(self, d_idx, s_idx, d_m, d_rho, s_rho, d_p, s_p, d_cs,
             s_cs, d_u, d_v, d_w, s_u, s_v, s_w, d_gradv, s_gradv, d_h,
             s_h, d_au, d_av, d_aw, d_V, s_V, XIJ, DWIJ, EPS):
        viju = (d_u[d_idx] - s_u[s_idx], d_v[d_idx] - s_v[s_idx],
                d_w[d_idx] - s_w[s_idx])
        mui, muj = _limiter(self.dim, d_gradv, s_gradv, d_idx, s_idx,
                            XIJ, d_h, s_h, self.eta_crit,
                            self.eta_fold, EPS, viju)
        ci = d_cs[d_idx]
        cj = s_cs[s_idx]
        Qi = d_rho[d_idx] * (-self.cl * ci * mui + self.cq * mui * mui)
        Qj = s_rho[s_idx] * (-self.cl * cj * muj + self.cq * muj * muj)

        Vi = 1.0 / d_V[d_idx]
        Vj = 1.0 / s_V[s_idx]
        fac = -(1.0 / d_m[d_idx]) * Vi * Vj * \
            (d_p[d_idx] + s_p[s_idx] + Qi + Qj)
        d_au[d_idx] += fac * DWIJ[0]
        d_av[d_idx] += fac * DWIJ[1]
        d_aw[d_idx] += fac * DWIJ[2]


class EnergyEquation(Equation):
    """CRKSPH compatible-energy update (reference crksph.py:635)."""

    def __init__(self, dest, sources, dim, gamma, gx=0.0, gy=0.0,
                 gz=0.0, cl=2, cq=1, eta_crit=0.5, eta_fold=0.2,
                 tol=0.5):
        self.dim = dim
        self.gamma = gamma
        self.gx = gx
        self.gy = gy
        self.gz = gz
        self.cl = cl
        self.cq = cq
        self.eta_crit = eta_crit
        self.eta_fold = eta_fold
        self.tol = tol
        super(EnergyEquation, self).__init__(dest, sources)

    def initialize(self, d_idx, d_ae):
        d_ae[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_ae, d_u0, d_v0, d_w0, s_u0, s_v0,
             s_w0, d_u, d_v, d_w, s_u, s_v, s_w, d_p, d_rho, s_p,
             s_rho, d_m, d_V, s_V, d_cs, s_cs, d_h, s_h, XIJ, d_gradv,
             s_gradv, EPS, DWIJ):
        d = self.dim
        viju = (d_u0[d_idx] - s_u0[s_idx], d_v0[d_idx] - s_v0[s_idx],
                d_w0[d_idx] - s_w0[s_idx])
        mui, muj = _limiter(d, d_gradv, s_gradv, d_idx, s_idx, XIJ,
                            d_h, s_h, self.eta_crit, self.eta_fold,
                            EPS, viju)
        ci = d_cs[d_idx]
        cj = s_cs[s_idx]
        Qi = d_rho[d_idx] * (-self.cl * ci * mui + self.cq * mui * mui)
        Qj = s_rho[s_idx] * (-self.cl * cj * muj + self.cq * muj * muj)

        Vi = 1.0 / d_V[d_idx]
        Vj = 1.0 / s_V[s_idx]
        fac = -(1.0 / d_m[d_idx]) * Vi * Vj * \
            (d_p[d_idx] + s_p[s_idx] + Qi + Qj)

        auij = [fac * DWIJ[i] for i in range(3)]
        delu = [s_u0[s_idx] + s_u[s_idx] - d_u0[d_idx] - d_u[d_idx],
                s_v0[s_idx] + s_v[s_idx] - d_v0[d_idx] - d_v[d_idx],
                s_w0[s_idx] + s_w[s_idx] - d_w0[d_idx] - d_w[d_idx]]
        aeij = sum(delu[i] * auij[i] for i in range(d))

        gamma = self.gamma
        si = d_p[d_idx] / (d_rho[d_idx] ** gamma)
        sj = s_p[s_idx] / (s_rho[s_idx] ** gamma)
        smin = torch.minimum(torch.abs(si), torch.abs(sj))
        smax = torch.maximum(torch.abs(si), torch.abs(sj))
        ssum = torch.where(smin + smax > 0.0, smin + smax, 1.0)
        sdiff = si - sj
        fij = torch.where(sdiff * aeij > 0, smin / ssum,
                          torch.where(sdiff * aeij < 0, smax / ssum, 0.5))
        d_ae[d_idx] += 0.5 * fij * aeij


class StateEquation(Equation):
    """p = (gamma - 1) rho e (reference crksph.py:786)."""

    def __init__(self, dest, sources, gamma):
        self.gamma = gamma
        super(StateEquation, self).__init__(dest, sources)

    def initialize(self, d_idx, d_p, d_rho, d_e):
        d_p[d_idx] = (self.gamma - 1) * d_rho[d_idx] * d_e[d_idx]


class SpeedOfSound(Equation):
    """cs = sqrt(gamma p / rho) (reference crksph.py:804)."""

    def __init__(self, dest, sources=None, gamma=7.0):
        super(SpeedOfSound, self).__init__(dest, sources)
        self.gamma = gamma

    def initialize(self, d_cs, d_idx, d_p, d_rho):
        d_cs[d_idx] = (self.gamma * d_p[d_idx] / d_rho[d_idx]) ** 0.5


class CRKSPHUpdateGhostProps(Equation):
    """Ghost copy (reference crksph.py:813): no mirrored ghosts on the
    grid, a no-op as in ``pysph_tpu``."""

    def __init__(self, dest, sources=None, dim=2):
        super(CRKSPHUpdateGhostProps, self).__init__(dest, sources)
        self.dim = dim

    def initialize(self, d_idx):
        pass


def get_particle_array_crksph(constants=None, **props):
    """CRKSPH particle array factory (reference crksph.py:847)."""
    crksph_props = [
        'e', 'au', 'av', 'aw', 'ae', 'u0', 'v0', 'w0', 'cs', 'V',
        'rhofac', 'x0', 'y0', 'z0', 'rho0', 'ax', 'ay', 'az', 'arho',
    ]
    pa = get_particle_array(additional_props=crksph_props,
                            constants=constants, **props)
    pa.add_property('cwij')
    pa.add_property('ai')
    pa.add_property('bi', stride=3)
    pa.add_property('gradai', stride=3)
    pa.add_property('gradbi', stride=9)
    pa.add_property('gradv', stride=9)
    for name, stride in _CRK_TEMPS:
        pa.add_property(name, stride=stride)
    pa.add_output_arrays(['p', 'V'])
    return pa


class CRKSPHIntegrator(Integrator):
    """Two evaluators a step (reference crksph.py:866): stage1, evaluator
    0, stage2, evaluator 1, stage3, then the periodic wrap."""

    def one_timestep(self, t, dt):
        self.stage1()
        self.do_post_stage(dt, 1)
        self.compute_accelerations(0)
        self.stage2()
        self.do_post_stage(dt, 2)
        self.compute_accelerations(1)
        self.stage3()
        self.do_post_stage(dt, 3)
        self.update_domain()


class CRKSPHStep(IntegratorStep):
    """CRKSPH stepper (reference crksph.py:884)."""

    def stage1(self, d_idx, d_u, d_v, d_w, d_u0, d_v0, d_w0):
        d_u0[d_idx] = d_u[d_idx]
        d_v0[d_idx] = d_v[d_idx]
        d_w0[d_idx] = d_w[d_idx]

    def stage2(self, d_idx, d_u, d_v, d_w, d_au, d_av, d_aw, dt):
        d_u[d_idx] += d_au[d_idx] * dt
        d_v[d_idx] += d_av[d_idx] * dt
        d_w[d_idx] += d_aw[d_idx] * dt

    def stage3(self, d_idx, d_e, d_ae, d_u, d_v, d_w, d_u0, d_v0,
               d_w0, d_x, d_y, d_z, dt):
        d_e[d_idx] += d_ae[d_idx] * dt
        d_x[d_idx] += 0.5 * dt * (d_u[d_idx] + d_u0[d_idx])
        d_y[d_idx] += 0.5 * dt * (d_v[d_idx] + d_v0[d_idx])
        d_z[d_idx] += 0.5 * dt * (d_w[d_idx] + d_w0[d_idx])


class CRKSPHScheme(Scheme):
    """CRKSPH (reference crksph.py:903): ``CRKSPHIntegrator`` with
    ``CRKSPHStep``, ``QuinticSpline`` by default; ``LaminarViscosity`` in
    the momentum group where ``|nu| > 1e-14``.  ``rho0``, ``c0``, ``h0``,
    ``p0`` and ``has_ghosts`` are kept and unused, as in ``pysph_tpu``."""

    def __init__(self, fluids, dim, rho0, c0, nu, h0, p0, gx=0.0,
                 gy=0.0, gz=0.0, cl=2, cq=1, gamma=7.0, eta_crit=0.3,
                 eta_fold=0.2, tol=0.5, has_ghosts=False):
        self.fluids = fluids
        self.solver = None
        self.dim = dim
        self.rho0 = rho0
        self.c0 = c0
        self.h0 = h0
        self.p0 = p0
        self.nu = nu
        self.gx = gx
        self.gy = gy
        self.gz = gz
        self.cl = cl
        self.cq = cq
        self.gamma = gamma
        self.eta_crit = eta_crit
        self.eta_fold = eta_fold
        self.tol = tol
        self.has_ghosts = has_ghosts

    def configure_solver(self, kernel=None, integrator_cls=None,
                         extra_steppers=None, **kw):
        from pysph_tpu_torch.base.kernels import QuinticSpline
        from pysph_tpu_torch.solver.solver import Solver
        if kernel is None:
            kernel = QuinticSpline(dim=self.dim)
        steppers = dict(extra_steppers or {})
        for fluid in self.fluids:
            if fluid not in steppers:
                steppers[fluid] = CRKSPHStep()
        cls = CRKSPHIntegrator if integrator_cls is None else integrator_cls
        integrator = cls(**steppers)
        self.solver = Solver(dim=self.dim, integrator=integrator,
                             kernel=kernel, **kw)

    def get_equations(self):
        from pysph_tpu_torch.sph.wc.viscosity import LaminarViscosity
        fluids = self.fluids
        eos = [eq for fluid in fluids for eq in
               (StateEquation(dest=fluid, sources=None, gamma=self.gamma),
                SpeedOfSound(dest=fluid, sources=None, gamma=self.gamma))]
        stage1 = [Group(equations=eos)]
        stage1.append(Group(equations=[
            NumberDensity(dest=fluid, sources=fluids) for fluid in fluids],
            real=False))
        stage1.append(Group(equations=[
            CRKSPHPreStep(dest=fluid, sources=fluids, dim=self.dim)
            for fluid in fluids], real=False))
        stage1.append(Group(equations=[
            eq for fluid in fluids for eq in
            (CRKSPHSymmetric(dest=fluid, sources=fluids, dim=self.dim,
                             tol=self.tol),
             SummationDensityCRKSPH(dest=fluid, sources=fluids))],
            real=False))
        stage1.append(Group(equations=[
            eq for fluid in fluids for eq in
            (StateEquation(dest=fluid, sources=None, gamma=self.gamma),
             SpeedOfSound(dest=fluid, sources=None, gamma=self.gamma))]))
        stage1.append(Group(equations=[
            eq for fluid in fluids for eq in
            (CRKSPHSymmetric(dest=fluid, sources=fluids, dim=self.dim,
                             tol=self.tol),
             VelocityGradient(dest=fluid, sources=fluids, dim=self.dim))]))
        momentum = []
        for fluid in fluids:
            momentum.append(CRKSPHSymmetric(dest=fluid, sources=fluids,
                                            dim=self.dim, tol=self.tol))
            momentum.append(MomentumEquation(
                dest=fluid, sources=fluids, dim=self.dim, gx=self.gx,
                gy=self.gy, gz=self.gz, cl=self.cl, cq=self.cq,
                eta_crit=self.eta_crit, eta_fold=self.eta_fold))
            if abs(self.nu) > 1e-14:
                momentum.append(LaminarViscosity(
                    dest=fluid, sources=fluids, nu=self.nu))
        stage1.append(Group(equations=momentum))
        stage2 = [Group(equations=[
            eq for fluid in fluids for eq in
            (CRKSPHSymmetric(dest=fluid, sources=fluids, dim=self.dim,
                             tol=self.tol),
             EnergyEquation(dest=fluid, sources=fluids, dim=self.dim,
                            gamma=self.gamma))])]
        return MultiStageEquations([stage1, stage2])

    def setup_properties(self, particles, clean=True):
        import numpy
        particle_arrays = dict((p.name, p) for p in particles)
        dummy = get_particle_array_crksph(name='junk')
        props = list(dummy.properties.keys())
        output_props = list(dummy.output_property_arrays)
        output_props += ['p', 'V', 'e']
        for fluid in self.fluids:
            pa = particle_arrays[fluid]
            for prop in props:
                if prop not in pa.properties:
                    pa.add_property(prop, stride=dummy.stride.get(prop, 1))
            pa.add_property('orig_idx', type='int')
            pa.orig_idx = numpy.arange(pa.get_number_of_particles())
            pa.set_output_arrays(output_props)
