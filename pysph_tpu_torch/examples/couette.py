"""Couette flow between a moving and a fixed plate.

Port of ``pysph_tpu/examples/couette.py``: a channel of width 1,
periodic in x (0.4 long), between two walls of five layers each
(``channel``), the top one moving at ``Vmax``; ``TVFScheme`` with the
Adami walls, ``QuinticSpline``, PEC, a fixed dt.  The flow starts at rest
and tends to the line ``u(y) = Vmax y / Ly``.  Its sizes are the
reference's module constants: dx = 0.05, 160 fluid and 80 channel
particles, dt = 0.03125, tf = 100 (3,200 steps).  On an NVIDIA card:

    python -m pysph_tpu_torch.examples.couette -d <dir>

(on the CPU: ``--device cpu``).  ``post_process`` compares u(y) of the
last dump with the exact line and writes ``results.npz``.
"""

import os

import numpy as np

from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.utils import get_particle_array
from pysph_tpu_torch.examples.poiseuille import profile_error
from pysph_tpu_torch.solver.application import Application
from pysph_tpu_torch.sph.scheme import TVFScheme

Re = 0.0125
d = 0.5
Ly = 2 * d
Lx = 0.4 * Ly
rho0 = 1.0
nu = 0.01
Vmax = nu * Re / (2 * d)
c0 = 10 * Vmax
p0 = c0 * c0 * rho0

dx = 0.05
ghost_extent = 5 * dx
hdx = 1.0
h0 = hdx * dx
dt_cfl = 0.25 * h0 / (c0 + Vmax)
dt_viscous = 0.125 * h0 ** 2 / nu
tf = 100.0
dt = min(dt_cfl, dt_viscous, 1.0)


class CouetteFlow(Application):
    def create_domain(self):
        return DomainManager(xmin=0, xmax=Lx, periodic_in_x=True)

    def create_scheme(self):
        s = TVFScheme(['fluid'], ['channel'], dim=2, rho0=rho0,
                      c0=c0, nu=nu, p0=p0, pb=p0, h0=dx * hdx)
        s.configure_solver(tf=tf, dt=dt)
        return s

    def create_particles(self):
        _x = np.arange(dx / 2, Lx, dx)
        _y = np.arange(dx / 2, Ly, dx)
        x, y = np.meshgrid(_x, _y)
        fx, fy = x.ravel(), y.ravel()

        _yt = np.arange(Ly + dx / 2, Ly + dx / 2 + ghost_extent, dx)
        _yb = np.arange(-dx / 2, -dx / 2 - ghost_extent, -dx)
        x, y = np.meshgrid(_x, np.concatenate([_yt, _yb]))
        cx, cy = x.ravel(), y.ravel()

        channel = get_particle_array(name='channel', x=cx, y=cy,
                                     rho=rho0 * np.ones_like(cx))
        fluid = get_particle_array(name='fluid', x=fx, y=fy,
                                   rho=rho0 * np.ones_like(fx))
        if not self.options.quiet:
            print('Couette flow :: Re = %g, nfluid = %d, nchannel = %d, '
                  'dt = %g' % (Re, fluid.get_number_of_particles(),
                               channel.get_number_of_particles(), dt))
        self.scheme.setup_properties([fluid, channel])
        volume = dx * dx
        for pa in (fluid, channel):
            pa.m[:] = volume * rho0
            pa.V[:] = 1.0 / volume
            pa.h[:] = hdx * dx
        channel.u[:] = np.where(np.asarray(channel.y) > d, Vmax, 0.0)
        return [fluid, channel]

    def post_process(self, info_fname_or_dir='.'):
        """Compare u(y) of the last dump with the exact line: prints max
        |u - ue| over max |ue| and writes ``results.npz`` (y, u, ue);
        returns (y, u, ue)."""
        from pysph_tpu_torch.solver.output import load
        files = self.output_files
        if not files:
            return
        fluid = load(files[-1])['arrays']['fluid']
        y = np.asarray(fluid.y)
        u = np.asarray(fluid.u)
        ue = Vmax * y / Ly
        err = profile_error(u, ue)
        np.savez(os.path.join(self.output_dir, 'results.npz'), y=y, u=u,
                 ue=ue)
        print('max relative error vs exact profile: %.4f' % err)
        return y, u, ue


if __name__ == '__main__':
    app = CouetteFlow()
    app.run()
    app.post_process(app.info_filename)
