"""Two-dimensional dam break over a dry bed (Gomez-Gesteira et al. 2010).

Port of ``pysph_tpu/examples/dam_break_2d.py``: a 1 m x 2 m water column
in a 4 m x 4 m tank with four wall layers.  ``--scheme wcsph`` (the
default: WCSPH with the Hughes-Graham corrected walls, ``PECIntegrator``,
``WendlandQuintic``, adaptive dt, 50 damped steps) and ``--scheme gtvf``
(the generalised transport-velocity formulation, two evaluators per
step) are ported; on an NVIDIA card:

    python -m pysph_tpu_torch.examples.dam_break_2d \\
        --dx 0.004 --max-steps 200 --disable-output
    python -m pysph_tpu_torch.examples.dam_break_2d --scheme gtvf \\
        --dx 0.004 --max-steps 200 --disable-output

``edac`` and ``iisph`` need their schemes; each raises
``NotImplementedError`` naming its ROADMAP item.
"""

import numpy as np

from pysph_tpu_torch.base.kernels import WendlandQuintic
from pysph_tpu_torch.base.utils import get_particle_array
from pysph_tpu_torch.solver.application import Application
from pysph_tpu_torch.sph.scheme import (
    NotPortedScheme, SchemeChooser, WCSPHScheme)
from pysph_tpu_torch.sph.wc.gtvf import GTVFScheme
from pysph_tpu_torch.tools.geometry import get_2d_block, get_2d_tank

fluid_column_height = 2.0
fluid_column_width = 1.0
container_height = 4.0
container_width = 4.0
nu = 0.0
g = 9.81
ro = 1000.0
vref = np.sqrt(2 * 9.81 * fluid_column_height)
co = 10.0 * vref
gamma = 7.0
alpha = 0.1
beta = 0.0
hdx = 1.3


class DamBreak2D(Application):
    def add_user_options(self, group):
        group.add_argument('--dx', action='store', type=float, dest='dx',
                           default=0.03, help='Particle spacing.')
        group.add_argument('--hdx', action='store', type=float,
                           dest='hdx', default=hdx, help='h = hdx * dx.')

    def consume_user_options(self):
        self.hdx = self.options.hdx
        self.dx = self.options.dx
        self.h = self.hdx * self.dx

    def create_scheme(self):
        wcsph = WCSPHScheme(
            ['fluid'], ['boundary'], dim=2, rho0=ro, c0=co, h0=None,
            hdx=hdx, gy=-g, alpha=alpha, beta=beta, gamma=gamma,
            hg_correction=True)
        gtvf = GTVFScheme(
            fluids=['fluid'], solids=['boundary'], dim=2, nu=nu,
            rho0=ro, gy=-g, h0=None, c0=co, pref=None)
        return SchemeChooser(
            default='wcsph', wcsph=wcsph,
            edac=NotPortedScheme('edac', 'ROADMAP Queue 1 item 35'),
            iisph=NotPortedScheme('iisph', 'ROADMAP Queue 1 item 26'),
            gtvf=gtvf)

    def configure_scheme(self):
        dt = 0.125 * self.h / co
        kw = dict(tf=2.5, output_at_times=[0.4, 0.6, 0.8, 1.0])
        if self.options.scheme == 'wcsph':
            from pysph_tpu_torch.sph.integrator import PECIntegrator
            self.scheme.configure(h0=self.h, hdx=self.hdx)
            self.scheme.configure_solver(
                integrator_cls=PECIntegrator,
                kernel=WendlandQuintic(dim=2), adaptive_timestep=True,
                n_damp=50, fixed_h=False, dt=dt, **kw)
            return
        self.scheme.configure(pref=ro * co * co / gamma, h0=self.h)
        self.scheme.configure_solver(dt=dt, **kw)

    def create_particles(self):
        dx = self.dx
        h = self.h
        m = dx * dx * ro
        xt, yt = get_2d_tank(dx=dx, length=container_width,
                             height=container_height, base_center=[2, 0],
                             num_layers=4)
        xf, yf = get_2d_block(dx=dx, length=fluid_column_width,
                              height=fluid_column_height,
                              center=[0.5, 1])
        xf += dx
        yf += dx
        fluid = get_particle_array(name='fluid', x=xf, y=yf, h=h, m=m,
                                   rho=ro)
        boundary = get_particle_array(name='boundary', x=xt, y=yt, h=h,
                                      m=m, rho=ro)
        self.scheme.setup_properties([fluid, boundary])
        if not self.options.quiet:
            print('dam_break_2d: %d fluid, %d boundary' %
                  (fluid.get_number_of_particles(),
                   boundary.get_number_of_particles()))
        return [fluid, boundary]


if __name__ == '__main__':
    DamBreak2D().run()
