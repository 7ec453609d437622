"""Incompressible flow past a periodic array of cylinders (Ellero & Adams,
IJNME 86 (2011) 1027-1040; Adami, Hu & Adams, JCP 241 (2013) 292-307).

Port of ``pysph_tpu/examples/periodic_cylinders.py``: a channel of width
L = 0.12, periodic in x, with a cylinder of radius 0.02 at its centre;
the cylinder and the two walls are one array (``solid``); the body force
``gx = fx`` drives the flow; ``TVFScheme`` with the Adami walls,
``QuinticSpline``, PEC, a fixed dt.  Its sizes are the reference's
module constants: nx = 100 (dx = 1.2e-3, h = 1.2 dx), tf = 2.5 a / Umax.
On an NVIDIA card:

    python -m pysph_tpu_torch.examples.periodic_cylinders -d <dir>

(on the CPU: ``--device cpu``).  ``post_process`` prints the fluid's
largest u of the last dump and writes ``results.npz``.
"""

import os

import numpy as np

from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.utils import get_particle_array
from pysph_tpu_torch.solver.application import Application
from pysph_tpu_torch.sph.scheme import TVFScheme

L = 0.12
Umax = 1.2e-4
a = 0.02              # cylinder radius
fx = 2.5e-4
c0 = 0.02
rho0 = 1000.0
p0 = c0 * c0 * rho0
pb = p0
nu = 0.1 / rho0

nx = 100
dx = L / nx
ghost_extent = 5 * 1.5 * dx
hdx = 1.2
h0 = hdx * dx
dt_cfl = 0.25 * h0 / (c0 + Umax)
dt_viscous = 0.125 * h0 ** 2 / nu
dt_force = 0.25 * np.sqrt(h0 / abs(fx))

T = a / Umax
tf = 2.5 * T
dt = 0.5 * min(dt_cfl, dt_viscous, dt_force)


class PeriodicCylinders(Application):
    def create_domain(self):
        return DomainManager(xmin=0, xmax=L, periodic_in_x=True)

    def create_scheme(self):
        return TVFScheme(['fluid'], ['solid'], dim=2, rho0=rho0,
                         c0=c0, nu=nu, p0=p0, pb=pb, h0=h0, gx=fx)

    def configure_scheme(self):
        self.scheme.configure_solver(tf=tf, dt=dt)
        self.scheme.get_solver().set_print_freq(500)

    def create_particles(self):
        cx = cy = 0.5 * L
        _x = np.arange(dx / 2, L, dx)
        _y = np.arange(-ghost_extent, L + ghost_extent, dx)
        x, y = np.meshgrid(_x, _y)
        x, y = x.ravel(), y.ravel()

        r2 = (x - cx) ** 2 + (y - cy) ** 2
        in_cyl = r2 <= a * a
        in_channel = (y > 0.0) & (y < L) & ~in_cyl
        # the solid: the cylinder and the channel's top and bottom walls
        solid_mask = in_cyl | (y <= 0.0) | (y >= L)

        fluid = get_particle_array(name='fluid', x=x[in_channel],
                                   y=y[in_channel])
        solid = get_particle_array(name='solid', x=x[solid_mask],
                                   y=y[solid_mask])
        if not self.options.quiet:
            print('Periodic cylinders: %d fluid, %d solid' % (
                fluid.get_number_of_particles(),
                solid.get_number_of_particles()))
        self.scheme.setup_properties([fluid, solid])
        volume = dx * dx
        for pa in (fluid, solid):
            pa.m[:] = volume * rho0
            pa.rho[:] = rho0
            pa.V[:] = 1.0 / volume
            pa.h[:] = h0
        return [fluid, solid]

    def post_process(self, info_fname_or_dir='.'):
        """The fluid's largest and mean u of the last dump, into
        ``results.npz`` (umax, umean)."""
        from pysph_tpu_torch.solver.output import load
        files = self.output_files
        if not files:
            return
        fluid = load(files[-1])['arrays']['fluid']
        u = np.asarray(fluid.u)
        np.savez(os.path.join(self.output_dir, 'results.npz'),
                 umax=u.max(), umean=u.mean())
        print('umax = %g (expected O(%g))' % (u.max(), Umax))


if __name__ == '__main__':
    app = PeriodicCylinders()
    app.run()
    app.post_process(app.info_filename)
