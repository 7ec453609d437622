"""Integrator steps (port of ``pysph_tpu/sph/integrator_step.py``: its
16 step classes).

Stage methods use the same per-particle DSL as equation ``initialize``:
arguments request particle properties by name and assignments are batched
over all particles by the engine.  A stage may call a helper method of
its step with the views it was given (``PEFRLStep._drift`` / ``_kick``):
the helper's writes go through the same views.
"""


class IntegratorStep(object):
    """Subclass and implement ``initialize``, ``stage1``, ... using the
    same conventions as equations (PySPH integrator_step.py:10)."""

    def __repr__(self):
        return '%s()' % (self.__class__.__name__,)


class EulerStep(IntegratorStep):
    """Simple first-order step (PySPH integrator_step.py:21)."""

    def stage1(self, d_idx, d_u, d_v, d_w, d_au, d_av, d_aw, d_x, d_y,
               d_z, d_rho, d_arho, dt):
        d_u[d_idx] += dt * d_au[d_idx]
        d_v[d_idx] += dt * d_av[d_idx]
        d_w[d_idx] += dt * d_aw[d_idx]
        d_x[d_idx] += dt * d_u[d_idx]
        d_y[d_idx] += dt * d_v[d_idx]
        d_z[d_idx] += dt * d_w[d_idx]
        d_rho[d_idx] += dt * d_arho[d_idx]


class WCSPHStep(IntegratorStep):
    """Standard predictor-corrector for WCSPH (PySPH
    integrator_step.py:38).  Positions advance with the XSPH advection
    velocity (ax, ay, az); usable in PEC or EPEC mode."""

    def initialize(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
                   d_u0, d_v0, d_w0, d_u, d_v, d_w, d_rho0, d_rho):
        d_x0[d_idx] = d_x[d_idx]
        d_y0[d_idx] = d_y[d_idx]
        d_z0[d_idx] = d_z[d_idx]
        d_u0[d_idx] = d_u[d_idx]
        d_v0[d_idx] = d_v[d_idx]
        d_w0[d_idx] = d_w[d_idx]
        d_rho0[d_idx] = d_rho[d_idx]

    def stage1(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
               d_u0, d_v0, d_w0, d_u, d_v, d_w, d_rho0, d_rho, d_au,
               d_av, d_aw, d_ax, d_ay, d_az, d_arho, dt):
        dtb2 = 0.5 * dt
        d_u[d_idx] = d_u0[d_idx] + dtb2 * d_au[d_idx]
        d_v[d_idx] = d_v0[d_idx] + dtb2 * d_av[d_idx]
        d_w[d_idx] = d_w0[d_idx] + dtb2 * d_aw[d_idx]
        d_x[d_idx] = d_x0[d_idx] + dtb2 * d_ax[d_idx]
        d_y[d_idx] = d_y0[d_idx] + dtb2 * d_ay[d_idx]
        d_z[d_idx] = d_z0[d_idx] + dtb2 * d_az[d_idx]
        d_rho[d_idx] = d_rho0[d_idx] + dtb2 * d_arho[d_idx]

    def stage2(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
               d_u0, d_v0, d_w0, d_u, d_v, d_w, d_rho0, d_rho, d_au,
               d_av, d_aw, d_ax, d_ay, d_az, d_arho, dt):
        d_u[d_idx] = d_u0[d_idx] + dt * d_au[d_idx]
        d_v[d_idx] = d_v0[d_idx] + dt * d_av[d_idx]
        d_w[d_idx] = d_w0[d_idx] + dt * d_aw[d_idx]
        d_x[d_idx] = d_x0[d_idx] + dt * d_ax[d_idx]
        d_y[d_idx] = d_y0[d_idx] + dt * d_ay[d_idx]
        d_z[d_idx] = d_z0[d_idx] + dt * d_az[d_idx]
        d_rho[d_idx] = d_rho0[d_idx] + dt * d_arho[d_idx]


class WCSPHTVDRK3Step(IntegratorStep):
    """TVD RK3 stepper for WCSPH (PySPH integrator_step.py:96)."""

    def initialize(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
                   d_u0, d_v0, d_w0, d_u, d_v, d_w, d_rho0, d_rho):
        d_x0[d_idx] = d_x[d_idx]
        d_y0[d_idx] = d_y[d_idx]
        d_z0[d_idx] = d_z[d_idx]
        d_u0[d_idx] = d_u[d_idx]
        d_v0[d_idx] = d_v[d_idx]
        d_w0[d_idx] = d_w[d_idx]
        d_rho0[d_idx] = d_rho[d_idx]

    def stage1(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
               d_u0, d_v0, d_w0, d_u, d_v, d_w, d_rho0, d_rho,
               d_au, d_av, d_aw, d_ax, d_ay, d_az, d_arho, dt):
        d_u[d_idx] = d_u0[d_idx] + dt * d_au[d_idx]
        d_v[d_idx] = d_v0[d_idx] + dt * d_av[d_idx]
        d_w[d_idx] = d_w0[d_idx] + dt * d_aw[d_idx]
        d_x[d_idx] = d_x0[d_idx] + dt * d_ax[d_idx]
        d_y[d_idx] = d_y0[d_idx] + dt * d_ay[d_idx]
        d_z[d_idx] = d_z0[d_idx] + dt * d_az[d_idx]
        d_rho[d_idx] = d_rho0[d_idx] + dt * d_arho[d_idx]

    def stage2(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
               d_u0, d_v0, d_w0, d_u, d_v, d_w, d_rho0, d_rho,
               d_au, d_av, d_aw, d_ax, d_ay, d_az, d_arho, dt):
        d_u[d_idx] = 0.75 * d_u0[d_idx] + 0.25 * (d_u[d_idx] +
                                                  dt * d_au[d_idx])
        d_v[d_idx] = 0.75 * d_v0[d_idx] + 0.25 * (d_v[d_idx] +
                                                  dt * d_av[d_idx])
        d_w[d_idx] = 0.75 * d_w0[d_idx] + 0.25 * (d_w[d_idx] +
                                                  dt * d_aw[d_idx])
        d_x[d_idx] = 0.75 * d_x0[d_idx] + 0.25 * (d_x[d_idx] +
                                                  dt * d_ax[d_idx])
        d_y[d_idx] = 0.75 * d_y0[d_idx] + 0.25 * (d_y[d_idx] +
                                                  dt * d_ay[d_idx])
        d_z[d_idx] = 0.75 * d_z0[d_idx] + 0.25 * (d_z[d_idx] +
                                                  dt * d_az[d_idx])
        d_rho[d_idx] = 0.75 * d_rho0[d_idx] + 0.25 * (d_rho[d_idx] +
                                                      dt * d_arho[d_idx])

    def stage3(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
               d_u0, d_v0, d_w0, d_u, d_v, d_w, d_rho0, d_rho,
               d_au, d_av, d_aw, d_ax, d_ay, d_az, d_arho, dt):
        f1 = 1.0 / 3.0
        f2 = 2.0 / 3.0
        d_u[d_idx] = f1 * d_u0[d_idx] + f2 * (d_u[d_idx] + dt * d_au[d_idx])
        d_v[d_idx] = f1 * d_v0[d_idx] + f2 * (d_v[d_idx] + dt * d_av[d_idx])
        d_w[d_idx] = f1 * d_w0[d_idx] + f2 * (d_w[d_idx] + dt * d_aw[d_idx])
        d_x[d_idx] = f1 * d_x0[d_idx] + f2 * (d_x[d_idx] + dt * d_ax[d_idx])
        d_y[d_idx] = f1 * d_y0[d_idx] + f2 * (d_y[d_idx] + dt * d_ay[d_idx])
        d_z[d_idx] = f1 * d_z0[d_idx] + f2 * (d_z[d_idx] + dt * d_az[d_idx])
        d_rho[d_idx] = f1 * d_rho0[d_idx] + f2 * (d_rho[d_idx] +
                                                  dt * d_arho[d_idx])


class TransportVelocityStep(IntegratorStep):
    """TVF integrator (Adami 2013, JCP 241; PySPH
    integrator_step.py:257).  Run in PEC mode only."""

    def stage1(self, d_idx, d_u, d_v, d_w, d_au, d_av, d_aw, d_uhat,
               d_auhat, d_vhat, d_avhat, d_what, d_awhat, d_x, d_y, d_z,
               dt):
        dtb2 = 0.5 * dt
        d_u[d_idx] += dtb2 * d_au[d_idx]
        d_v[d_idx] += dtb2 * d_av[d_idx]
        d_w[d_idx] += dtb2 * d_aw[d_idx]
        d_uhat[d_idx] = d_u[d_idx] + dtb2 * d_auhat[d_idx]
        d_vhat[d_idx] = d_v[d_idx] + dtb2 * d_avhat[d_idx]
        d_what[d_idx] = d_w[d_idx] + dtb2 * d_awhat[d_idx]
        d_x[d_idx] += dt * d_uhat[d_idx]
        d_y[d_idx] += dt * d_vhat[d_idx]
        d_z[d_idx] += dt * d_what[d_idx]

    def stage2(self, d_idx, d_u, d_v, d_w, d_au, d_av, d_aw, d_vmag2, dt):
        dtb2 = 0.5 * dt
        d_u[d_idx] += dtb2 * d_au[d_idx]
        d_v[d_idx] += dtb2 * d_av[d_idx]
        d_w[d_idx] += dtb2 * d_aw[d_idx]
        d_vmag2[d_idx] = (d_u[d_idx] * d_u[d_idx] +
                          d_v[d_idx] * d_v[d_idx] +
                          d_w[d_idx] * d_w[d_idx])


class AdamiVerletStep(IntegratorStep):
    """Verlet integration of Adami 2012, JCP 231 (PySPH
    integrator_step.py:302).  PEC or EPEC."""

    def stage1(self, d_idx, d_u, d_v, d_w, d_au, d_av, d_aw, d_x, d_y,
               d_z, dt):
        dtb2 = 0.5 * dt
        d_u[d_idx] += dtb2 * d_au[d_idx]
        d_v[d_idx] += dtb2 * d_av[d_idx]
        d_w[d_idx] += dtb2 * d_aw[d_idx]
        d_x[d_idx] += dtb2 * d_u[d_idx]
        d_y[d_idx] += dtb2 * d_v[d_idx]
        d_z[d_idx] += dtb2 * d_w[d_idx]

    def stage2(self, d_idx, d_u, d_v, d_w, d_au, d_av, d_aw, d_x, d_y,
               d_z, d_rho, d_arho, d_vmag2, dt):
        dtb2 = 0.5 * dt
        d_x[d_idx] += dtb2 * d_u[d_idx]
        d_y[d_idx] += dtb2 * d_v[d_idx]
        d_z[d_idx] += dtb2 * d_w[d_idx]
        d_u[d_idx] += dtb2 * d_au[d_idx]
        d_v[d_idx] += dtb2 * d_av[d_idx]
        d_w[d_idx] += dtb2 * d_aw[d_idx]
        d_rho[d_idx] += dt * d_arho[d_idx]
        d_vmag2[d_idx] = (d_u[d_idx] * d_u[d_idx] +
                          d_v[d_idx] * d_v[d_idx] +
                          d_w[d_idx] * d_w[d_idx])


class VerletSymplecticWCSPHStep(IntegratorStep):
    """Symplectic 2nd-order integrator, Monaghan 2005 eq. (5.39-5.41)
    (PySPH integrator_step.py:595).  Density via summation."""

    def stage1(self, d_idx, d_x, d_y, d_z, d_u, d_v, d_w, dt):
        dtb2 = 0.5 * dt
        d_x[d_idx] += dtb2 * d_u[d_idx]
        d_y[d_idx] += dtb2 * d_v[d_idx]
        d_z[d_idx] += dtb2 * d_w[d_idx]

    def stage2(self, d_idx, d_x, d_y, d_z, d_ax, d_ay, d_az,
               d_u, d_v, d_w, d_au, d_av, d_aw, dt):
        dtb2 = 0.5 * dt
        d_u[d_idx] += dt * d_au[d_idx]
        d_v[d_idx] += dt * d_av[d_idx]
        d_w[d_idx] += dt * d_aw[d_idx]
        d_x[d_idx] += dtb2 * d_ax[d_idx]
        d_y[d_idx] += dtb2 * d_ay[d_idx]
        d_z[d_idx] += dtb2 * d_az[d_idx]


class VelocityVerletSymplecticWCSPHStep(IntegratorStep):
    """Kick-drift-kick Verlet, Monaghan 2005 eq. (5.51-5.53)
    (PySPH integrator_step.py:646)."""

    def stage1(self, d_idx, d_u, d_v, d_w, d_au, d_av, d_aw, dt):
        dtb2 = 0.5 * dt
        d_u[d_idx] += dtb2 * d_au[d_idx]
        d_v[d_idx] += dtb2 * d_av[d_idx]
        d_w[d_idx] += dtb2 * d_aw[d_idx]

    def stage2(self, d_idx, d_x, d_y, d_z, d_u, d_v, d_w,
               d_au, d_av, d_aw, dt):
        dtb2 = 0.5 * dt
        d_x[d_idx] += dt * d_u[d_idx]
        d_y[d_idx] += dt * d_v[d_idx]
        d_z[d_idx] += dt * d_w[d_idx]
        d_u[d_idx] += dtb2 * d_au[d_idx]
        d_v[d_idx] += dtb2 * d_av[d_idx]
        d_w[d_idx] += dtb2 * d_aw[d_idx]


class InletOutletStep(IntegratorStep):
    """Advect inlet/outlet particles with their own velocity
    (PySPH integrator_step.py:687)."""

    def stage1(self, d_idx, d_x, d_y, d_z, d_u, d_v, d_w, dt):
        dtb2 = 0.5 * dt
        d_x[d_idx] += dtb2 * d_u[d_idx]
        d_y[d_idx] += dtb2 * d_v[d_idx]
        d_z[d_idx] += dtb2 * d_w[d_idx]

    def stage2(self, d_idx, d_x, d_y, d_z, d_u, d_v, d_w, dt):
        dtb2 = 0.5 * dt
        d_x[d_idx] += dtb2 * d_u[d_idx]
        d_y[d_idx] += dtb2 * d_v[d_idx]
        d_z[d_idx] += dtb2 * d_w[d_idx]


class LeapFrogStep(IntegratorStep):
    """Leap-frog with the XSPH correction carried in ax/ay/az
    (PySPH integrator_step.py:708)."""

    def stage1(self, d_idx, d_x, d_y, d_z, d_u, d_v, d_w, d_ax, d_ay,
               d_az, dt):
        d_x[d_idx] += 0.5 * dt * (d_u[d_idx] + d_ax[d_idx])
        d_y[d_idx] += 0.5 * dt * (d_v[d_idx] + d_ay[d_idx])
        d_z[d_idx] += 0.5 * dt * (d_w[d_idx] + d_az[d_idx])

    def stage2(self, d_idx, d_x, d_y, d_z, d_u, d_au, d_v, d_av,
               d_w, d_aw, d_ax, d_ay, d_az, d_rho, d_arho, d_e, d_ae, dt):
        d_u[d_idx] += dt * d_au[d_idx]
        d_v[d_idx] += dt * d_av[d_idx]
        d_w[d_idx] += dt * d_aw[d_idx]
        d_rho[d_idx] += dt * d_arho[d_idx]
        d_e[d_idx] += dt * d_ae[d_idx]
        d_x[d_idx] += 0.5 * dt * (d_u[d_idx] + d_ax[d_idx])
        d_y[d_idx] += 0.5 * dt * (d_v[d_idx] + d_ay[d_idx])
        d_z[d_idx] += 0.5 * dt * (d_w[d_idx] + d_az[d_idx])


# Coefficients of the PEFRL scheme (Omelyan, Mryglod & Folk 2002).
_PEFRL_XI = 0.1786178958448091
_PEFRL_LAMBDA = -0.2123418310626054
_PEFRL_CHI = -0.06626458266981849


class PEFRLStep(IntegratorStep):
    """4th-order Position-Extended Forest-Ruth-Like stepper
    (PySPH integrator_step.py:738)."""

    def _drift(self, d_idx, d_x, d_y, d_z, d_u, d_v, d_w,
               d_ax, d_ay, d_az, fac, dt):
        d_x[d_idx] += fac * dt * (d_u[d_idx] + d_ax[d_idx])
        d_y[d_idx] += fac * dt * (d_v[d_idx] + d_ay[d_idx])
        d_z[d_idx] += fac * dt * (d_w[d_idx] + d_az[d_idx])

    def _kick(self, d_idx, d_u, d_v, d_w, d_au, d_av, d_aw,
              d_rho, d_arho, d_e, d_ae, fac, dt):
        d_u[d_idx] += fac * dt * d_au[d_idx]
        d_v[d_idx] += fac * dt * d_av[d_idx]
        d_w[d_idx] += fac * dt * d_aw[d_idx]
        d_rho[d_idx] += fac * dt * d_arho[d_idx]
        d_e[d_idx] += fac * dt * d_ae[d_idx]

    def stage1(self, d_idx, d_x, d_y, d_z, d_u, d_v, d_w, d_ax, d_ay,
               d_az, dt):
        self._drift(d_idx, d_x, d_y, d_z, d_u, d_v, d_w,
                    d_ax, d_ay, d_az, _PEFRL_XI, dt)

    def stage2(self, d_idx, d_x, d_y, d_z, d_u, d_au, d_v, d_av,
               d_w, d_aw, d_ax, d_ay, d_az, d_rho, d_arho, d_e, d_ae, dt):
        self._kick(d_idx, d_u, d_v, d_w, d_au, d_av, d_aw, d_rho,
                   d_arho, d_e, d_ae, (1.0 - 2.0 * _PEFRL_LAMBDA) / 2.0, dt)
        self._drift(d_idx, d_x, d_y, d_z, d_u, d_v, d_w,
                    d_ax, d_ay, d_az, _PEFRL_CHI, dt)

    def stage3(self, d_idx, d_x, d_y, d_z, d_u, d_au, d_v, d_av,
               d_w, d_aw, d_ax, d_ay, d_az, d_rho, d_arho, d_e, d_ae, dt):
        self._kick(d_idx, d_u, d_v, d_w, d_au, d_av, d_aw, d_rho,
                   d_arho, d_e, d_ae, _PEFRL_LAMBDA, dt)
        self._drift(d_idx, d_x, d_y, d_z, d_u, d_v, d_w, d_ax, d_ay,
                    d_az, 1.0 - 2.0 * (_PEFRL_XI + _PEFRL_CHI), dt)

    def stage4(self, d_idx, d_x, d_y, d_z, d_u, d_au, d_v, d_av,
               d_w, d_aw, d_ax, d_ay, d_az, d_rho, d_arho, d_e, d_ae, dt):
        self._kick(d_idx, d_u, d_v, d_w, d_au, d_av, d_aw, d_rho,
                   d_arho, d_e, d_ae, _PEFRL_LAMBDA, dt)
        self._drift(d_idx, d_x, d_y, d_z, d_u, d_v, d_w,
                    d_ax, d_ay, d_az, _PEFRL_CHI, dt)

    def stage5(self, d_idx, d_x, d_y, d_z, d_u, d_au, d_v, d_av,
               d_w, d_aw, d_ax, d_ay, d_az, d_rho, d_arho, d_e, d_ae, dt):
        self._kick(d_idx, d_u, d_v, d_w, d_au, d_av, d_aw, d_rho,
                   d_arho, d_e, d_ae, (1.0 - 2.0 * _PEFRL_LAMBDA) / 2.0, dt)
        self._drift(d_idx, d_x, d_y, d_z, d_u, d_v, d_w,
                    d_ax, d_ay, d_az, _PEFRL_XI, dt)


class GasDFluidStep(IntegratorStep):
    """Predictor-corrector for gas dynamics with grad-h bookkeeping
    (PySPH integrator_step.py:351)."""

    def initialize(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z, d_h,
                   d_u0, d_v0, d_w0, d_u, d_v, d_w, d_e, d_e0, d_h0,
                   d_converged, d_omega, d_rho, d_rho0, d_alpha1,
                   d_alpha2, d_alpha10, d_alpha20):
        d_x0[d_idx] = d_x[d_idx]
        d_y0[d_idx] = d_y[d_idx]
        d_z0[d_idx] = d_z[d_idx]
        d_u0[d_idx] = d_u[d_idx]
        d_v0[d_idx] = d_v[d_idx]
        d_w0[d_idx] = d_w[d_idx]
        d_e0[d_idx] = d_e[d_idx]
        d_h0[d_idx] = d_h[d_idx]
        d_rho0[d_idx] = d_rho[d_idx]
        d_converged[d_idx] = 0.0
        d_omega[d_idx] = 1.0
        d_alpha10[d_idx] = d_alpha1[d_idx]
        d_alpha20[d_idx] = d_alpha2[d_idx]

    def stage1(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
               d_u0, d_v0, d_w0, d_u, d_v, d_w, d_e0, d_e, d_au, d_av,
               d_aw, d_ae, d_rho, d_rho0, d_arho, d_h, d_h0, d_ah,
               d_alpha1, d_aalpha1, d_alpha10,
               d_alpha2, d_aalpha2, d_alpha20, dt):
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
        d_alpha1[d_idx] = d_alpha10[d_idx] + dtb2 * d_aalpha1[d_idx]
        d_alpha2[d_idx] = d_alpha20[d_idx] + dtb2 * d_aalpha2[d_idx]

    def stage2(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
               d_u0, d_v0, d_w0, d_u, d_v, d_w, d_e0, d_e, d_au, d_av,
               d_alpha1, d_aalpha1, d_alpha10,
               d_alpha2, d_aalpha2, d_alpha20, d_aw, d_ae, dt):
        d_u[d_idx] = d_u0[d_idx] + dt * d_au[d_idx]
        d_v[d_idx] = d_v0[d_idx] + dt * d_av[d_idx]
        d_w[d_idx] = d_w0[d_idx] + dt * d_aw[d_idx]
        d_x[d_idx] = d_x0[d_idx] + dt * d_u[d_idx]
        d_y[d_idx] = d_y0[d_idx] + dt * d_v[d_idx]
        d_z[d_idx] = d_z0[d_idx] + dt * d_w[d_idx]
        d_e[d_idx] = d_e0[d_idx] + dt * d_ae[d_idx]
        d_alpha1[d_idx] = d_alpha10[d_idx] + dt * d_aalpha1[d_idx]
        d_alpha2[d_idx] = d_alpha20[d_idx] + dt * d_aalpha2[d_idx]


class GSPHStep(IntegratorStep):
    """Godunov SPH step (PySPH integrator_step.py:431)."""

    def stage1(self, d_idx, d_x, d_y, d_z, d_u, d_v, d_w, d_e,
               d_au, d_av, d_aw, d_ae, dt):
        dtb2 = dt * 0.5
        ustar = d_u[d_idx] + dtb2 * d_au[d_idx]
        vstar = d_v[d_idx] + dtb2 * d_av[d_idx]
        wstar = d_w[d_idx] + dtb2 * d_aw[d_idx]
        d_u[d_idx] += dt * d_au[d_idx]
        d_v[d_idx] += dt * d_av[d_idx]
        d_w[d_idx] += dt * d_aw[d_idx]
        d_e[d_idx] += dt * (d_ae[d_idx] - ustar * d_au[d_idx] -
                            vstar * d_av[d_idx] - wstar * d_aw[d_idx])
        d_x[d_idx] += dt * ustar
        d_y[d_idx] += dt * vstar
        d_z[d_idx] += dt * wstar


class ADKEStep(IntegratorStep):
    """Predictor-corrector for the ADKE gas-dynamics scheme
    (PySPH integrator_step.py:452)."""

    def initialize(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
                   d_u0, d_v0, d_w0, d_u, d_v, d_w, d_e, d_e0,
                   d_rho, d_rho0):
        d_x0[d_idx] = d_x[d_idx]
        d_y0[d_idx] = d_y[d_idx]
        d_z0[d_idx] = d_z[d_idx]
        d_u0[d_idx] = d_u[d_idx]
        d_v0[d_idx] = d_v[d_idx]
        d_w0[d_idx] = d_w[d_idx]
        d_e0[d_idx] = d_e[d_idx]
        d_rho0[d_idx] = d_rho[d_idx]

    def stage1(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
               d_u0, d_v0, d_w0, d_u, d_v, d_w, d_e0, d_e, d_au, d_av,
               d_aw, d_ae, d_rho, d_rho0, d_arho, dt):
        dtb2 = 0.5 * dt
        d_u[d_idx] = d_u0[d_idx] + dtb2 * d_au[d_idx]
        d_v[d_idx] = d_v0[d_idx] + dtb2 * d_av[d_idx]
        d_w[d_idx] = d_w0[d_idx] + dtb2 * d_aw[d_idx]
        d_x[d_idx] = d_x0[d_idx] + dtb2 * d_u[d_idx]
        d_y[d_idx] = d_y0[d_idx] + dtb2 * d_v[d_idx]
        d_z[d_idx] = d_z0[d_idx] + dtb2 * d_w[d_idx]
        d_e[d_idx] = d_e0[d_idx] + dtb2 * d_ae[d_idx]

    def stage2(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
               d_u0, d_v0, d_w0, d_u, d_v, d_w, d_e0, d_e, d_au, d_av,
               d_aw, d_ae, dt):
        d_u[d_idx] = d_u0[d_idx] + dt * d_au[d_idx]
        d_v[d_idx] = d_v0[d_idx] + dt * d_av[d_idx]
        d_w[d_idx] = d_w0[d_idx] + dt * d_aw[d_idx]
        d_x[d_idx] = d_x0[d_idx] + dt * d_u[d_idx]
        d_y[d_idx] = d_y0[d_idx] + dt * d_v[d_idx]
        d_z[d_idx] = d_z0[d_idx] + dt * d_w[d_idx]
        d_e[d_idx] = d_e0[d_idx] + dt * d_ae[d_idx]


class SolidMechStep(IntegratorStep):
    """Predictor-corrector for solid mechanics: WCSPH-style stepping of
    positions/velocities/density/energy plus the six deviatoric stress
    components (PySPH integrator_step.py:173)."""

    def initialize(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
                   d_u0, d_v0, d_w0, d_u, d_v, d_w, d_rho0, d_rho,
                   d_s00, d_s01, d_s02, d_s11, d_s12, d_s22,
                   d_s000, d_s010, d_s020, d_s110, d_s120, d_s220,
                   d_e0, d_e):
        d_x0[d_idx] = d_x[d_idx]
        d_y0[d_idx] = d_y[d_idx]
        d_z0[d_idx] = d_z[d_idx]
        d_u0[d_idx] = d_u[d_idx]
        d_v0[d_idx] = d_v[d_idx]
        d_w0[d_idx] = d_w[d_idx]
        d_rho0[d_idx] = d_rho[d_idx]
        d_e0[d_idx] = d_e[d_idx]
        d_s000[d_idx] = d_s00[d_idx]
        d_s010[d_idx] = d_s01[d_idx]
        d_s020[d_idx] = d_s02[d_idx]
        d_s110[d_idx] = d_s11[d_idx]
        d_s120[d_idx] = d_s12[d_idx]
        d_s220[d_idx] = d_s22[d_idx]

    def stage1(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
               d_u0, d_v0, d_w0, d_u, d_v, d_w, d_rho0, d_rho, d_au,
               d_av, d_aw, d_ax, d_ay, d_az, d_arho, d_e, d_e0, d_ae,
               d_s00, d_s01, d_s02, d_s11, d_s12, d_s22,
               d_s000, d_s010, d_s020, d_s110, d_s120, d_s220,
               d_as00, d_as01, d_as02, d_as11, d_as12, d_as22, dt):
        dtb2 = 0.5 * dt
        d_u[d_idx] = d_u0[d_idx] + dtb2 * d_au[d_idx]
        d_v[d_idx] = d_v0[d_idx] + dtb2 * d_av[d_idx]
        d_w[d_idx] = d_w0[d_idx] + dtb2 * d_aw[d_idx]
        d_x[d_idx] = d_x0[d_idx] + dtb2 * d_ax[d_idx]
        d_y[d_idx] = d_y0[d_idx] + dtb2 * d_ay[d_idx]
        d_z[d_idx] = d_z0[d_idx] + dtb2 * d_az[d_idx]
        d_rho[d_idx] = d_rho0[d_idx] + dtb2 * d_arho[d_idx]
        d_e[d_idx] = d_e0[d_idx] + dtb2 * d_ae[d_idx]
        d_s00[d_idx] = d_s000[d_idx] + dtb2 * d_as00[d_idx]
        d_s01[d_idx] = d_s010[d_idx] + dtb2 * d_as01[d_idx]
        d_s02[d_idx] = d_s020[d_idx] + dtb2 * d_as02[d_idx]
        d_s11[d_idx] = d_s110[d_idx] + dtb2 * d_as11[d_idx]
        d_s12[d_idx] = d_s120[d_idx] + dtb2 * d_as12[d_idx]
        d_s22[d_idx] = d_s220[d_idx] + dtb2 * d_as22[d_idx]

    def stage2(self, d_idx, d_x0, d_y0, d_z0, d_x, d_y, d_z,
               d_u0, d_v0, d_w0, d_u, d_v, d_w, d_rho0, d_rho, d_au,
               d_av, d_aw, d_ax, d_ay, d_az, d_arho, d_e, d_ae, d_e0,
               d_s00, d_s01, d_s02, d_s11, d_s12, d_s22,
               d_s000, d_s010, d_s020, d_s110, d_s120, d_s220,
               d_as00, d_as01, d_as02, d_as11, d_as12, d_as22, dt):
        d_u[d_idx] = d_u0[d_idx] + dt * d_au[d_idx]
        d_v[d_idx] = d_v0[d_idx] + dt * d_av[d_idx]
        d_w[d_idx] = d_w0[d_idx] + dt * d_aw[d_idx]
        d_x[d_idx] = d_x0[d_idx] + dt * d_ax[d_idx]
        d_y[d_idx] = d_y0[d_idx] + dt * d_ay[d_idx]
        d_z[d_idx] = d_z0[d_idx] + dt * d_az[d_idx]
        d_rho[d_idx] = d_rho0[d_idx] + dt * d_arho[d_idx]
        d_e[d_idx] = d_e0[d_idx] + dt * d_ae[d_idx]
        d_s00[d_idx] = d_s000[d_idx] + dt * d_as00[d_idx]
        d_s01[d_idx] = d_s010[d_idx] + dt * d_as01[d_idx]
        d_s02[d_idx] = d_s020[d_idx] + dt * d_as02[d_idx]
        d_s11[d_idx] = d_s110[d_idx] + dt * d_as11[d_idx]
        d_s12[d_idx] = d_s120[d_idx] + dt * d_as12[d_idx]
        d_s22[d_idx] = d_s220[d_idx] + dt * d_as22[d_idx]


class TwoStageRigidBodyStep(IntegratorStep):
    """Two-stage rigid-body kinematics
    (PySPH integrator_step.py:506)."""

    def initialize(self, d_idx, d_x, d_y, d_z, d_x0, d_y0, d_z0, d_u,
                   d_v, d_w, d_u0, d_v0, d_w0):
        d_u0[d_idx] = d_u[d_idx]
        d_v0[d_idx] = d_v[d_idx]
        d_w0[d_idx] = d_w[d_idx]
        d_x0[d_idx] = d_x[d_idx]
        d_y0[d_idx] = d_y[d_idx]
        d_z0[d_idx] = d_z[d_idx]

    def stage1(self, d_idx, d_x, d_y, d_z, d_x0, d_y0, d_z0, d_u, d_v,
               d_w, d_u0, d_v0, d_w0, d_au, d_av, d_aw, dt):
        dtb2 = 0.5 * dt
        d_u[d_idx] = d_u0[d_idx] + dtb2 * d_au[d_idx]
        d_v[d_idx] = d_v0[d_idx] + dtb2 * d_av[d_idx]
        d_w[d_idx] = d_w0[d_idx] + dtb2 * d_aw[d_idx]
        d_x[d_idx] = d_x0[d_idx] + dtb2 * 0.5 * (d_u[d_idx] +
                                                 d_u0[d_idx])
        d_y[d_idx] = d_y0[d_idx] + dtb2 * 0.5 * (d_v[d_idx] +
                                                 d_v0[d_idx])
        d_z[d_idx] = d_z0[d_idx] + dtb2 * 0.5 * (d_w[d_idx] +
                                                 d_w0[d_idx])

    def stage2(self, d_idx, d_x, d_y, d_z, d_x0, d_y0, d_z0, d_u, d_v,
               d_w, d_u0, d_v0, d_w0, d_au, d_av, d_aw, dt):
        d_u[d_idx] = d_u0[d_idx] + dt * d_au[d_idx]
        d_v[d_idx] = d_v0[d_idx] + dt * d_av[d_idx]
        d_w[d_idx] = d_w0[d_idx] + dt * d_aw[d_idx]
        d_x[d_idx] = d_x0[d_idx] + dt * 0.5 * (d_u[d_idx] +
                                               d_u0[d_idx])
        d_y[d_idx] = d_y0[d_idx] + dt * 0.5 * (d_v[d_idx] +
                                               d_v0[d_idx])
        d_z[d_idx] = d_z0[d_idx] + dt * 0.5 * (d_w[d_idx] +
                                               d_w0[d_idx])


class OneStageRigidBodyStep(IntegratorStep):
    """One-stage rigid-body kinematics
    (PySPH integrator_step.py:559)."""

    def initialize(self, d_idx, d_x, d_y, d_z, d_x0, d_y0, d_z0, d_u,
                   d_v, d_w, d_u0, d_v0, d_w0):
        d_u0[d_idx] = d_u[d_idx]
        d_v0[d_idx] = d_v[d_idx]
        d_w0[d_idx] = d_w[d_idx]
        d_x0[d_idx] = d_x[d_idx]
        d_y0[d_idx] = d_y[d_idx]
        d_z0[d_idx] = d_z[d_idx]

    def stage1(self, d_idx):
        pass

    def stage2(self, d_idx, d_x, d_y, d_z, d_u, d_v, d_w, d_u0, d_v0,
               d_w0, d_au, d_av, d_aw, dt):
        d_u[d_idx] += dt * d_au[d_idx]
        d_v[d_idx] += dt * d_av[d_idx]
        d_w[d_idx] += dt * d_aw[d_idx]
        d_x[d_idx] += dt * 0.5 * (d_u[d_idx] + d_u0[d_idx])
        d_y[d_idx] += dt * 0.5 * (d_v[d_idx] + d_v0[d_idx])
        d_z[d_idx] += dt * 0.5 * (d_w[d_idx] + d_w0[d_idx])
