"""Lid-driven cavity with the transport-velocity formulation.

Port of ``pysph_tpu/examples/cavity.py``: a unit box of fluid inside five
layers of wall (``solid``), the lid (the wall above y = 1) moving at
``Umax``; ``--scheme tvf`` (the default: ``TVFScheme`` with the Adami
walls, ``QuinticSpline``, PEC, a fixed dt) on an open grid.  ``--nx``
(default 50) sets dx = 1 / nx and ``--re`` (default 100) the viscosity.
At ``--nx 400`` (a convergence study's resolution) it holds 160,000
fluid and 8,921 wall particles and steps at dt = 5.68e-5.  On an NVIDIA
card:

    python -m pysph_tpu_torch.examples.cavity --nx 400 --max-steps 200 \\
        --disable-output

(on the CPU: ``--device cpu``).  The fluid's pair phases run on
``tvf_pair`` (the density and the momentum group, the no-slip wall among
its terms, as a linked pair), the wall's on ``gtvf_pair``.  ``--scheme
edac`` raises ``NotImplementedError`` naming its ROADMAP item;
``post_process`` (the centreline profiles through the reference's
``Interpolator``) raises it where there are dumps to process.
"""

import numpy as np

from pysph_tpu_torch.base.utils import get_particle_array
from pysph_tpu_torch.solver.application import Application
from pysph_tpu_torch.sph.scheme import (
    NotPortedScheme, SchemeChooser, TVFScheme)

L = 1.0
Umax = 1.0
c0 = 10 * Umax
rho0 = 1.0
p0 = c0 * c0 * rho0
hdx = 1.0

#: the ROADMAP items of what the port lacks here
EDAC_ITEM = 'ROADMAP Queue 1 item 35'
INTERPOLATOR_ITEM = 'ROADMAP Queue 1 item 30'


class LidDrivenCavity(Application):
    def add_user_options(self, group):
        group.add_argument('--nx', action='store', type=int,
                           dest='nx', default=50,
                           help='Number of points along x.')
        group.add_argument('--re', action='store', type=float,
                           dest='re', default=100,
                           help='Reynolds number.')
        self.n_avg = 5
        group.add_argument('--n-vel-avg', action='store', type=int,
                           dest='n_avg', default=None,
                           help='Average velocities over these many '
                                'saved timesteps.')

    def consume_user_options(self):
        nx = self.options.nx
        if self.options.n_avg is not None:
            self.n_avg = self.options.n_avg
        self.dx = L / nx
        self.re = self.options.re
        h0 = hdx * self.dx
        self.nu = Umax * L / self.re
        dt_cfl = 0.25 * h0 / (c0 + Umax)
        dt_viscous = 0.125 * h0 ** 2 / self.nu
        self.tf = 10.0
        self.dt = min(dt_cfl, dt_viscous, 1.0)

    def create_scheme(self):
        tvf = TVFScheme(['fluid'], ['solid'], dim=2, rho0=rho0,
                        c0=c0, nu=None, p0=p0, pb=p0, h0=hdx)
        return SchemeChooser(default='tvf', tvf=tvf,
                             edac=NotPortedScheme('edac', EDAC_ITEM))

    def configure_scheme(self):
        h0 = hdx * self.dx
        self.scheme.configure(h0=h0, nu=self.nu)
        self.scheme.configure_solver(tf=self.tf, dt=self.dt)
        self.scheme.get_solver().set_print_freq(500)

    def create_particles(self):
        dx = self.dx
        ghost_extent = 5 * dx
        _x = np.arange(-ghost_extent - dx / 2,
                       L + ghost_extent + dx / 2, dx)
        x, y = np.meshgrid(_x, _x)
        x = x.ravel()
        y = y.ravel()

        inside = (x > 0.0) & (x < L) & (y > 0.0) & (y < L)
        fluid = get_particle_array(name='fluid', x=x[inside],
                                   y=y[inside])
        solid = get_particle_array(name='solid', x=x[~inside],
                                   y=y[~inside])
        if not self.options.quiet:
            print('Lid driven cavity :: Re = %d, dt = %g' %
                  (self.re, self.dt))

        volume = dx * dx
        for pa in (fluid, solid):
            pa.m[:] = volume * rho0
            pa.rho[:] = rho0
            pa.h[:] = hdx * dx
        solid.u[:] = np.where(np.asarray(solid.y) > L, Umax, 0.0)
        solid.v[:] = 0.0
        self.scheme.setup_properties([fluid, solid])
        fluid.V[:] = 1.0 / volume
        solid.V[:] = 1.0 / volume
        return [fluid, solid]

    def post_process(self, info_fname_or_dir='.'):
        """The reference's centreline velocity profiles, averaged over the
        last ``n_avg`` dumps, interpolate the dumps with
        ``tools/interpolator.py``, which the port lacks: raises
        ``NotImplementedError`` where there are dumps (returns None where
        there are none, as the reference does)."""
        if not self.output_files:
            return
        raise NotImplementedError(
            'cavity post_process needs the Interpolator, not ported yet '
            '(%s)' % INTERPOLATOR_ITEM)


if __name__ == '__main__':
    app = LidDrivenCavity()
    app.run()
    app.post_process(app.info_filename)
