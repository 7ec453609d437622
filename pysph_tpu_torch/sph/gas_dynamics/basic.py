"""Basic equations of compressible gas dynamics (port of
``pysph_tpu/sph/gas_dynamics/basic.py``): those of ``GasDScheme``.

- ``ScaleSmoothingLength``, ``UpdateSmoothingLengthFromVolume``: the
  per-particle h updates of the ``gsph`` adaptive-h scheme;
- ``SummationDensity``: the grad-h summation density; with
  ``density_iterations`` its ``post_loop`` takes one Newton-Raphson step
  of each particle's h towards ``rho = m (k / h)^dim`` until that
  particle's own ``converged`` flag is set, and ``converged(dst)`` holds
  once every particle's is, so the iterated group (``Group(iterate=True,
  update_nnps=True)``) sweeps as the reference's;
- ``IdealGasEOS``: ``p = (gamma - 1) rho e`` and the sound speed;
- ``MPMAccelerations``: the Monaghan-Price-Morris accelerations with the
  grad-h factors ``omega``, signal-velocity viscosity and conduction, a
  ``MAX`` of the signal speed into ``dt_cfl``, and the switches'
  rates ``aalpha1``, ``aalpha2`` in ``post_loop``;
- ``SummationDensityADKE``, ``ADKEAccelerations`` and
  ``ADKEUpdateGhostProps``: ``ADKEScheme``'s, the summation density with
  h reset to ``h0`` in ``initialize`` and, in ``reduce``, the adaptive
  kernel estimate ``h = k (g / rho)^eps h0`` (g the geometric mean of
  rho), and the accelerations with Monaghan's viscosity and the ADKE
  thermal conduction (whose ``g2`` is ``g1``, as the reference's).

On the kernel engine the pair terms of ``SummationDensity`` and
``MPMAccelerations`` run in ``gasd_pair`` (``ops/gasd_pair.py``); their
``initialize`` and ``post_loop`` stay elementwise phases here, but for
the ``mpm`` scheme's iterated density group, whose every sweep
(``initialize``, the sums, ``post_loop``, the count of unconverged
particles) is one ``gasd_sweep`` launch (``ops/pair_engine.py::
plan_sweep``), in the same IEEE operations as the methods below.  The
pair terms of ``SummationDensityADKE`` and ``ADKEAccelerations`` are
``gasd_pair``'s ADKE sets; ``reduce`` runs as torch ops on the device
after the dest's ``post_loop`` and reads nothing back.
"""

import torch

from pysph_tpu_torch.sph.equation import MAX, Equation


class ScaleSmoothingLength(Equation):
    def __init__(self, dest, sources, factor=2.0):
        super(ScaleSmoothingLength, self).__init__(dest, sources)
        self.factor = factor

    def loop(self, d_idx, d_h):
        d_h[d_idx] = d_h[d_idx] * self.factor


class UpdateSmoothingLengthFromVolume(Equation):
    def __init__(self, dest, sources, dim, k=1.2):
        super(UpdateSmoothingLengthFromVolume, self).__init__(dest,
                                                              sources)
        self.k = k
        self.dim1 = 1.0 / dim

    def loop(self, d_idx, d_m, d_rho, d_h):
        d_h[d_idx] = self.k * (d_m[d_idx] / d_rho[d_idx]) ** self.dim1


class SummationDensityADKE(Equation):
    """The ADKE summation density: WIJ at the mean h, after h is reset to
    h0; ``reduce`` sets each particle's h from the geometric mean of
    rho."""

    def __init__(self, dest, sources, k=1.0, eps=0.0):
        self.k = k
        self.eps = eps
        super(SummationDensityADKE, self).__init__(dest, sources)

    def initialize(self, d_idx, d_arho, d_rho, d_h, d_h0):
        d_rho[d_idx] = 0.0
        d_arho[d_idx] = 0.0
        d_h[d_idx] = d_h0[d_idx]

    def loop(self, d_idx, d_rho, d_arho, s_idx, s_m, VIJ, DWI, WIJ):
        d_rho[d_idx] += s_m[s_idx] * WIJ
        vijdotdwij = (VIJ[0] * DWI[0] + VIJ[1] * DWI[1] +
                      VIJ[2] * DWI[2])
        d_arho[d_idx] += s_m[s_idx] * vijdotdwij

    def post_loop(self, d_idx, d_rho, d_arho, d_div, d_logrho):
        d_div[d_idx] = -d_arho[d_idx] / d_rho[d_idx]
        d_arho[d_idx] = 0.0
        d_logrho[d_idx] = torch.log(d_rho[d_idx])

    def reduce(self, dst, t, dt):
        mask = dst.active
        rho = dst.rho[:]
        n = torch.where(mask, 1.0, 0.0).to(rho.dtype).sum()
        sum_logrho = torch.where(mask, dst.logrho[:], 0.0).sum()
        g = torch.exp(sum_logrho / torch.clamp(n, min=1.0))
        lamda = self.k * (g / torch.where(mask, rho, 1.0)) ** self.eps
        dst.h[:] = torch.where(mask, lamda * dst.h0[:], dst.h[:])


class SummationDensity(Equation):
    """Summation density with the grad-h terms, and, with
    ``density_iterations``, a Newton-Raphson step of each unconverged
    particle's h a sweep."""

    def __init__(self, dest, sources, dim, density_iterations=False,
                 iterate_only_once=False, k=1.2, htol=1e-6):
        self.density_iterations = density_iterations
        self.iterate_only_once = iterate_only_once
        self.dim = dim
        self.k = k
        self.htol = htol
        super(SummationDensity, self).__init__(dest, sources)

    def initialize(self, d_idx, d_rho, d_div, d_grhox, d_grhoy,
                   d_grhoz, d_arho, d_dwdh):
        d_rho[d_idx] = 0.0
        d_div[d_idx] = 0.0
        d_grhox[d_idx] = 0.0
        d_grhoy[d_idx] = 0.0
        d_grhoz[d_idx] = 0.0
        d_arho[d_idx] = 0.0
        d_dwdh[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_rho, d_grhox, d_grhoy, d_grhoz,
             d_arho, d_dwdh, s_m, VIJ, WI, DWI, GHI):
        mj = s_m[s_idx]
        vijdotdwij = (VIJ[0] * DWI[0] + VIJ[1] * DWI[1] +
                      VIJ[2] * DWI[2])
        d_rho[d_idx] += mj * WI
        d_arho[d_idx] += mj * vijdotdwij
        d_grhox[d_idx] += mj * DWI[0]
        d_grhoy[d_idx] += mj * DWI[1]
        d_grhoz[d_idx] += mj * DWI[2]
        d_dwdh[d_idx] += mj * GHI

    def post_loop(self, d_idx, d_arho, d_rho, d_div, d_omega, d_dwdh,
                  d_h0, d_h, d_m, d_ah, d_converged):
        if self.density_iterations:
            active = d_converged[d_idx] != 1
            mi = d_m[d_idx]
            hi = d_h[d_idx]
            hi0 = d_h0[d_idx]
            rho = d_rho[d_idx]
            rhoi = mi / (hi / self.k) ** self.dim
            dhdrhoi = -hi / (self.dim * rho)
            omegai = 1.0 - dhdrhoi * d_dwdh[d_idx]
            omegai = torch.where(omegai < 0, 1.0, omegai)
            gradhi = 1.0 / omegai
            func = rhoi - rho
            dfdh = omegai / dhdrhoi
            hnew = hi - func / dfdh
            hnew = torch.minimum(torch.maximum(hnew, 0.8 * hi), 1.2 * hi)
            hnew = torch.where((hnew <= 1e-6) | (gradhi < 1e-6),
                               self.k * (mi / rho) ** (1.0 / self.dim),
                               hnew)
            diff = torch.abs(hnew - hi) / hi0
            if self.iterate_only_once:
                done = torch.ones_like(active)
            else:
                done = (diff < self.htol) & (omegai > 0)
            # each particle is updated until its own flag converges
            d_omega[d_idx] = torch.where(active, gradhi, d_omega[d_idx])
            d_h[d_idx] = torch.where(active & ~done, hnew, hi)
            d_arho[d_idx] = torch.where(
                active & done, d_arho[d_idx] * gradhi, d_arho[d_idx])
            d_ah[d_idx] = torch.where(
                active & done, d_arho[d_idx] * dhdrhoi, d_ah[d_idx])
            d_converged[d_idx] = torch.where(
                active & done, 1.0,
                torch.where(active, 0.0, d_converged[d_idx]))
        d_div[d_idx] = -d_arho[d_idx] / d_rho[d_idx]

    def converged(self, dst):
        if not self.density_iterations:
            return 1.0
        all_done = torch.where(dst.active, dst.converged[:] == 1,
                               True).all()
        return torch.where(all_done, 1.0, -1.0)


class IdealGasEOS(Equation):
    """p = (gamma - 1) rho e."""

    def __init__(self, dest, sources, gamma):
        self.gamma = gamma
        self.gamma1 = gamma - 1.0
        super(IdealGasEOS, self).__init__(dest, sources)

    def loop(self, d_idx, d_p, d_rho, d_e, d_cs):
        d_p[d_idx] = self.gamma1 * d_rho[d_idx] * d_e[d_idx]
        d_cs[d_idx] = torch.sqrt(self.gamma *
                                 torch.clamp(d_p[d_idx], min=0.0) /
                                 d_rho[d_idx])


class MPMAccelerations(Equation):
    """Monaghan-Price-Morris accelerations with the grad-h terms and
    signal-velocity viscosity and conduction."""

    def __init__(self, dest, sources, beta=2.0, update_alpha1=False,
                 update_alpha2=False, alpha1_min=0.1, alpha2_min=0.1,
                 sigma=0.1):
        self.beta = beta
        self.sigma = sigma
        self.update_alpha1 = update_alpha1
        self.update_alpha2 = update_alpha2
        self.alpha1_min = alpha1_min
        self.alpha2_min = alpha2_min
        super(MPMAccelerations, self).__init__(dest, sources)

    def initialize(self, d_idx, d_au, d_av, d_aw, d_ae, d_am,
                   d_aalpha1, d_aalpha2, d_del2e, d_dt_cfl):
        d_au[d_idx] = 0.0
        d_av[d_idx] = 0.0
        d_aw[d_idx] = 0.0
        d_ae[d_idx] = 0.0
        d_aalpha1[d_idx] = 0.0
        d_aalpha2[d_idx] = 0.0
        d_del2e[d_idx] = 0.0
        d_dt_cfl[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_m, s_m, d_p, s_p, d_cs, s_cs,
             d_e, s_e, d_rho, s_rho, d_au, d_av, d_aw, d_ae,
             d_omega, s_omega, XIJ, VIJ, DWI, DWJ, DWIJ, HIJ,
             d_del2e, d_alpha1, s_alpha1, d_alpha2, s_alpha2,
             EPS, RIJ, R2IJ, RHOIJ, d_dt_cfl):
        p_i = d_p[d_idx]
        pj = s_p[s_idx]
        pibrhoi2 = p_i / (d_rho[d_idx] * d_rho[d_idx])
        pjbrhoj2 = pj / (s_rho[s_idx] * s_rho[s_idx])
        cij = 0.5 * (d_cs[d_idx] + s_cs[s_idx])
        mj = s_m[s_idx]

        # the normalised interaction vector: the reference rewrites XIJ,
        # here a copy, so that no other equation of the phase sees it
        near = RIJ < 1e-8
        safe_r = torch.where(near, 1.0, RIJ)
        xij = [torch.where(near, 0.0, XIJ[i] / safe_r) for i in range(3)]

        dot = VIJ[0] * xij[0] + VIJ[1] * xij[1] + VIJ[2] * xij[2]
        Fij = xij[0] * DWIJ[0] + xij[1] * DWIJ[1] + xij[2] * DWIJ[2]
        pdiff = torch.abs(p_i - pj)
        vsig1 = 0.5 * torch.clamp(2 * cij - self.beta * dot, min=0.0)
        vsig2 = torch.sqrt(pdiff / RHOIJ)

        d_dt_cfl[d_idx] = MAX(cij + self.beta * dot, d_dt_cfl[d_idx])

        alpha1 = 0.5 * (d_alpha1[d_idx] + s_alpha1[s_idx])
        compressing = dot <= 0.0
        visc = torch.where(compressing,
                           mj / RHOIJ * alpha1 * vsig1 * dot, 0.0)
        d_au[d_idx] += visc * DWIJ[0]
        d_av[d_idx] += visc * DWIJ[1]
        d_aw[d_idx] += visc * DWIJ[2]
        d_ae[d_idx] += torch.where(
            compressing,
            -0.5 * mj / RHOIJ * alpha1 * vsig1 * dot * dot * Fij, 0.0)

        omegai = d_omega[d_idx]
        omegaj = s_omega[s_idx]
        d_au[d_idx] += -mj * (pibrhoi2 * omegai * DWI[0] +
                              pjbrhoj2 * omegaj * DWJ[0])
        d_av[d_idx] += -mj * (pibrhoi2 * omegai * DWI[1] +
                              pjbrhoj2 * omegaj * DWJ[1])
        d_aw[d_idx] += -mj * (pibrhoi2 * omegai * DWI[2] +
                              pjbrhoj2 * omegaj * DWJ[2])
        vijdotdwi = (VIJ[0] * DWI[0] + VIJ[1] * DWI[1] +
                     VIJ[2] * DWI[2])
        d_ae[d_idx] += mj * pibrhoi2 * omegai * vijdotdwi

        alpha2 = 0.5 * (d_alpha2[d_idx] + s_alpha2[s_idx])
        eij = d_e[d_idx] - s_e[s_idx]
        d_ae[d_idx] += mj / RHOIJ * alpha2 * vsig2 * eij * Fij
        d_del2e[d_idx] += mj / s_rho[s_idx] * eij / (RIJ + EPS) * Fij

    def post_loop(self, d_idx, d_h, d_cs, d_alpha1, d_aalpha1, d_div,
                  d_del2e, d_e, d_alpha2, d_aalpha2):
        hi = d_h[d_idx]
        tau = hi / (self.sigma * d_cs[d_idx])
        if self.update_alpha1:
            S1 = torch.clamp(-d_div[d_idx], min=0.0)
            d_aalpha1[d_idx] = (self.alpha1_min - d_alpha1[d_idx]) / \
                tau + S1
        if self.update_alpha2:
            S2 = 0.01 * hi * torch.abs(d_del2e[d_idx]) / \
                torch.sqrt(torch.clamp(d_e[d_idx], min=1e-30))
            d_aalpha2[d_idx] = (self.alpha2_min - d_alpha2[d_idx]) / \
                tau + S2


class ADKEAccelerations(Equation):
    """The ADKE accelerations: the pressure gradient with Monaghan's
    artificial viscosity and the ADKE thermal conduction.  ``g2`` is set
    to ``g1``, as the reference's (ROADMAP Queue 3: reproduced on
    purpose)."""

    def __init__(self, dest, sources, alpha, beta, g1, g2, k, eps):
        self.alpha = alpha
        self.beta = beta
        self.g1 = g1
        self.g2 = g1
        self.k = k
        self.eps = eps
        super(ADKEAccelerations, self).__init__(dest, sources)

    def initialize(self, d_idx, d_au, d_av, d_aw, d_ae):
        d_au[d_idx] = 0.0
        d_av[d_idx] = 0.0
        d_aw[d_idx] = 0.0
        d_ae[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_au, d_av, d_aw, d_ae, d_p, s_p,
             d_rho, s_rho, d_m, s_m, d_cs, s_cs, s_e, d_e, s_h, d_h,
             s_div, d_div, DWIJ, HIJ, XIJ, VIJ, R2IJ, EPS, RHOIJ,
             RHOIJ1):
        pibrhoi2 = d_p[d_idx] / (d_rho[d_idx] * d_rho[d_idx])
        pjbrhoj2 = s_p[s_idx] / (s_rho[s_idx] * s_rho[s_idx])
        cij = 0.5 * (d_cs[d_idx] + s_cs[s_idx])
        mj = s_m[s_idx]
        hi = d_h[d_idx]
        hj = s_h[s_idx]
        divi = d_div[d_idx]
        divj = s_div[s_idx]
        eij = d_e[d_idx] - s_e[s_idx]
        Hi = self.g1 * hi * d_cs[d_idx] + \
            self.g2 * hi * hi * (torch.abs(divi) - divi)
        Hj = self.g1 * hj * s_cs[s_idx] + \
            self.g2 * hj * hj * (torch.abs(divj) - divj)
        Hij = (Hi + Hj) * eij / (RHOIJ * (R2IJ + EPS))
        xijdotvij = (XIJ[0] * VIJ[0] + XIJ[1] * VIJ[1] +
                     XIJ[2] * VIJ[2])
        muij = HIJ * xijdotvij / (R2IJ + EPS)
        piij = muij * (self.beta * muij - self.alpha * cij) * RHOIJ1
        piij = torch.where(xijdotvij < 0, piij, 0.0)
        tmpv = pibrhoi2 + pjbrhoj2 + piij
        d_au[d_idx] += -mj * tmpv * DWIJ[0]
        d_av[d_idx] += -mj * tmpv * DWIJ[1]
        d_aw[d_idx] += -mj * tmpv * DWIJ[2]
        vijdotdwij = (VIJ[0] * DWIJ[0] + VIJ[1] * DWIJ[1] +
                      VIJ[2] * DWIJ[2])
        xijdotdwij = (XIJ[0] * DWIJ[0] + XIJ[1] * DWIJ[1] +
                      XIJ[2] * DWIJ[2])
        d_ae[d_idx] += 0.5 * mj * (tmpv * vijdotdwij +
                                   2 * xijdotdwij * Hij)


class ADKEUpdateGhostProps(Equation):
    """The reference's copy into ghost particles: a no-op here (the
    periodic grid's minimum images stand for the ghosts)."""

    def __init__(self, dest, sources=None, dim=2):
        super(ADKEUpdateGhostProps, self).__init__(dest, sources)
        self.dim = dim

    def initialize(self, d_idx):
        pass
