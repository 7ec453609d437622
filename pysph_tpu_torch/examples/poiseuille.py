"""Poiseuille flow between parallel plates driven by a body force.

Port of ``pysph_tpu/examples/poiseuille.py``: a channel of width 1,
periodic in x (0.4 long), between two walls of five layers each
(``channel``), under the body force ``gx = fx``; ``TVFScheme`` with the
Adami walls, ``QuinticSpline``, PEC, a fixed dt.  The flow starts at
rest and tends to the parabola ``u(y) = fx / (2 nu) y (1 - y)``.  Its
sizes are the reference's module constants: dx = 1/60, 1,440 fluid and
240 channel particles, dt = 3.47e-3, tf = 100 (some 28,800 steps).  On
an NVIDIA card:

    python -m pysph_tpu_torch.examples.poiseuille -d <dir>

(on the CPU: ``--device cpu``).  ``post_process`` compares u(y) of the
last dump with the exact parabola and writes ``results.npz``.  The
fluid's pair phases run on ``tvf_pair`` (its momentum group with the
no-slip wall, linked to the summation density), the channel's on
``gtvf_pair``.
"""

import os

import numpy as np

from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.utils import get_particle_array
from pysph_tpu_torch.solver.application import Application
from pysph_tpu_torch.sph.scheme import TVFScheme

dx = 1.0 / 60.0
ghost_extent = 5 * dx
hdx = 1.0
h0 = hdx * dx


class PoiseuilleFlow(Application):
    def initialize(self):
        self.d = 0.5
        self.Ly = 2 * self.d
        self.Lx = 0.4 * self.Ly
        self.rho0 = 1.0
        self.nu = 0.01

    def add_user_options(self, group):
        group.add_argument('--re', action='store', type=float,
                           dest='re', default=0.0125,
                           help='Reynolds number of the flow.')

    def consume_user_options(self):
        self.re = self.options.re
        self.Vmax = self.nu * self.re / (2 * self.d)
        self.c0 = 10 * self.Vmax
        self.p0 = self.c0 ** 2 * self.rho0
        self.fx = self.Vmax * 2 * self.nu / (self.d ** 2)
        dt_cfl = 0.25 * h0 / (self.c0 + self.Vmax)
        dt_viscous = 0.125 * h0 ** 2 / self.nu
        dt_force = 0.25 * np.sqrt(h0 / self.fx)
        self.dt = min(dt_cfl, dt_viscous, dt_force)

    def create_scheme(self):
        return TVFScheme(['fluid'], ['channel'], dim=2,
                         rho0=self.rho0, c0=None, nu=self.nu, p0=None,
                         pb=None, h0=h0, gx=None)

    def configure_scheme(self):
        scheme = self.scheme
        scheme.configure(c0=self.c0, p0=self.p0, pb=self.p0,
                         gx=self.fx)
        scheme.configure_solver(tf=100.0, dt=self.dt)
        self.scheme.get_solver().set_print_freq(1000)
        if not self.options.quiet:
            print('dt = %g' % self.dt)

    def create_domain(self):
        return DomainManager(xmin=0, xmax=self.Lx, periodic_in_x=True)

    def create_particles(self):
        Lx, Ly = self.Lx, self.Ly
        _x = np.arange(dx / 2, Lx, dx)
        _y = np.arange(dx / 2, Ly, dx)
        x, y = np.meshgrid(_x, _y)
        fx, fy = x.ravel(), y.ravel()

        _yt = np.arange(Ly + dx / 2, Ly + dx / 2 + ghost_extent, dx)
        _yb = np.arange(-dx / 2, -dx / 2 - ghost_extent, -dx)
        x, y = np.meshgrid(_x, np.concatenate([_yt, _yb]))
        cx, cy = x.ravel(), y.ravel()

        channel = get_particle_array(name='channel', x=cx, y=cy)
        fluid = get_particle_array(name='fluid', x=fx, y=fy)
        if not self.options.quiet:
            print('Poiseuille flow :: Re = %g, nfluid = %d, nchannel = %d'
                  % (self.re, fluid.get_number_of_particles(),
                     channel.get_number_of_particles()))
        self.scheme.setup_properties([fluid, channel])
        volume = dx * dx
        for pa in (fluid, channel):
            pa.m[:] = volume * self.rho0
            pa.rho[:] = self.rho0
            pa.V[:] = 1.0 / volume
            pa.h[:] = hdx * dx
        return [fluid, channel]

    def post_process(self, info_fname_or_dir='.'):
        """Compare u(y) of the last dump with the exact parabola: prints
        max |u - ue| over max |ue| and writes ``results.npz`` (y, u,
        ue); returns (y, u, ue)."""
        from pysph_tpu_torch.solver.output import load
        files = self.output_files
        if not files:
            return
        fluid = load(files[-1])['arrays']['fluid']
        y = np.asarray(fluid.y)
        u = np.asarray(fluid.u)
        ue = 0.5 * self.fx / self.nu * y * (2 * self.d - y)
        err = profile_error(u, ue)
        np.savez(os.path.join(self.output_dir, 'results.npz'), y=y, u=u,
                 ue=ue)
        print('max relative error vs exact profile: %.4f' % err)
        return y, u, ue


def profile_error(u, ue):
    """max |u - ue| over max |ue|: ``post_process``'s error."""
    return float(np.abs(u - ue).max() / max(np.abs(ue).max(), 1e-12))


if __name__ == '__main__':
    app = PoiseuilleFlow()
    app.run()
    app.post_process(app.info_filename)
