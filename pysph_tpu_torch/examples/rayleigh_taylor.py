"""Rayleigh-Taylor instability: a heavy fluid layer on top of a lighter
one in a closed box under gravity.

Port of ``pysph_tpu/examples/rayleigh_taylor.py``: two fluids (``fluid1``
above the interface y = 1 - 0.15 sin(2 pi x), rho 1.8; ``fluid2`` below
it, rho 1), a box of 1 x 2 closed by five layers of wall (``solid``),
``gy = -1``, Re = 420; ``TVFScheme`` with the Adami walls,
``QuinticSpline``, PEC, a fixed dt, on an open grid.  Its sizes are the
reference's module constants: nx = 50 (dx = 0.02, h = 1.2 dx), 5,000
fluid and 1,200 wall particles, tf = 25.  On an NVIDIA card:

    python -m pysph_tpu_torch.examples.rayleigh_taylor -d <dir>

(on the CPU: ``--device cpu``).  Each fluid's pair phases run on
``tvf_pair`` (a linked pair over the three arrays), the wall's on
``gtvf_pair``.  ``post_process`` tracks the lowest y of the heavy phase
over the dumps and writes ``results.npz``.
"""

import os

import numpy as np

from pysph_tpu_torch.base.utils import get_particle_array
from pysph_tpu_torch.solver.application import Application
from pysph_tpu_torch.sph.scheme import TVFScheme

gy = -1.0
Lx = 1.0
Ly = 2.0
Re = 420
Vmax = np.sqrt(0.5 * Ly * abs(gy))
nu = Vmax * Ly / Re

rho1 = 1.8     # upper (heavy) phase
rho2 = 1.0     # lower (light) phase

Fr = 0.01
c0 = Vmax / Fr
p1 = c0 ** 2 * rho1
p2 = c0 ** 2 * rho2

nx = 50
dx = Lx / nx
ghost_extent = 5 * dx
hdx = 1.2
h0 = hdx * dx
dt_cfl = 0.25 * h0 / (c0 + Vmax)
dt_viscous = 0.125 * h0 ** 2 / nu
dt_force = 0.25 * np.sqrt(h0 / abs(gy))

tf = 25.0
dt = 0.5 * min(dt_cfl, dt_viscous, dt_force)


class RayleighTaylor(Application):
    def create_scheme(self):
        return TVFScheme(
            ['fluid1', 'fluid2'], ['solid'], dim=2, rho0=rho1, c0=c0,
            nu=nu, p0=p1, pb=p1, h0=h0, gy=gy)

    def configure_scheme(self):
        self.scheme.configure_solver(tf=tf, dt=dt)
        self.scheme.get_solver().set_print_freq(500)

    def create_particles(self):
        _x = np.arange(-ghost_extent - dx / 2,
                       Lx + ghost_extent + dx / 2, dx)
        _y = np.arange(-ghost_extent - dx / 2,
                       Ly + ghost_extent + dx / 2, dx)
        x, y = np.meshgrid(_x, _y)
        x, y = x.ravel(), y.ravel()

        inside = (x > 0.0) & (x < Lx) & (y > 0.0) & (y < Ly)
        sx, sy = x[~inside], y[~inside]
        fx, fy = x[inside], y[inside]

        # the perturbed interface splits the fluid into a heavy top and
        # a light bottom
        upper = fy > 1.0 - 0.15 * np.sin(2 * np.pi * fx)
        solid = get_particle_array(name='solid', x=sx, y=sy)
        fluid1 = get_particle_array(name='fluid1', x=fx[upper],
                                    y=fy[upper])
        fluid2 = get_particle_array(name='fluid2', x=fx[~upper],
                                    y=fy[~upper])
        if not self.options.quiet:
            print('Rayleigh-Taylor: %d upper, %d lower, %d solid' % (
                fluid1.get_number_of_particles(),
                fluid2.get_number_of_particles(),
                solid.get_number_of_particles()))

        self.scheme.setup_properties([fluid1, fluid2, solid])
        volume = dx * dx
        for pa, rho in ((fluid1, rho1), (fluid2, rho2),
                        (solid, rho1)):
            pa.m[:] = volume * rho
            pa.rho[:] = rho
            pa.V[:] = 1.0 / volume
            pa.h[:] = h0
        return [fluid1, fluid2, solid]

    def post_process(self, info_fname_or_dir='.'):
        """The penetration of the heavy phase's spike: the lowest y of
        ``fluid1`` at each dump, into ``results.npz`` (t, spike_y);
        returns (t, ymin)."""
        from pysph_tpu_torch.solver.output import load
        files = self.output_files
        if not files:
            return
        t, ymin = [], []
        for f in files:
            data = load(f)
            t.append(float(data['solver_data']['t']))
            ymin.append(float(np.min(np.asarray(
                data['arrays']['fluid1'].y))))
        np.savez(os.path.join(self.output_dir, 'results.npz'),
                 t=np.asarray(t), spike_y=np.asarray(ymin))
        return t, ymin


if __name__ == '__main__':
    app = RayleighTaylor()
    app.run()
    app.post_process(app.info_filename)
