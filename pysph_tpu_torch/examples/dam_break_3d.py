"""Three-dimensional dam break over a dry bed (SPHERIC Test 2).

Port of ``pysph_tpu/examples/dam_break_3d.py``, the main path.  On an
NVIDIA card:

    python -m pysph_tpu_torch.examples.dam_break_3d --dx 0.02 \\
        --max-steps 100 --disable-output
"""

import numpy as np

from pysph_tpu_torch.base.kernels import WendlandQuintic
from pysph_tpu_torch.examples.db_geometry import DamBreak3DGeometry
from pysph_tpu_torch.solver.application import Application
from pysph_tpu_torch.sph.integrator import EPECIntegrator
from pysph_tpu_torch.sph.scheme import WCSPHScheme

dim = 3
dt = 1e-5
tf = 6.0
dx = 0.02
nboundary_layers = 1
hdx = 1.3
ro = 1000.0
h0 = dx * hdx
gamma = 7.0
alpha = 0.25
beta = 0.0
c0 = 10.0 * np.sqrt(2.0 * 9.81 * 0.55)


class DamBreak3D(Application):
    def add_user_options(self, group):
        group.add_argument('--dx', action='store', type=float,
                           dest='dx', default=dx,
                           help='Particle spacing.')
        group.add_argument('--hdx', action='store', type=float,
                           dest='hdx', default=hdx, help='h = hdx*dx.')

    def consume_user_options(self):
        self.dx = self.options.dx
        self.hdx = self.options.hdx
        self.geom = DamBreak3DGeometry(
            dx=self.dx, nboundary_layers=nboundary_layers,
            hdx=self.hdx, rho0=ro)
        self.co = 10.0 * self.geom.get_max_speed(g=9.81)

    def create_scheme(self):
        return WCSPHScheme(
            ['fluid'], ['boundary', 'obstacle'], dim=dim, rho0=ro,
            c0=c0, h0=h0, hdx=hdx, gz=-9.81, alpha=alpha, beta=beta,
            gamma=gamma, hg_correction=True, tensile_correction=False)

    def configure_scheme(self):
        s = self.scheme
        kernel = WendlandQuintic(dim=dim)
        h = self.dx * self.hdx
        s.configure(h0=h, hdx=self.hdx)
        dt_ = 0.25 * h / (1.1 * self.co)
        s.configure_solver(
            kernel=kernel, integrator_cls=EPECIntegrator, tf=tf, dt=dt_,
            adaptive_timestep=True, n_damp=50,
            output_at_times=[0.4, 0.6, 1.0])

    def create_particles(self):
        return self.geom.create_particles()


if __name__ == '__main__':
    DamBreak3D().run()
