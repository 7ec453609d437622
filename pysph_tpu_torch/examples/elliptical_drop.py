"""Evolution of a circular patch of incompressible fluid (Monaghan 1994).

Port of ``pysph_tpu/examples/elliptical_drop.py``: a circular fluid patch
of radius 1 under the velocity field (-100 x, 100 y) deforms into an
ellipse of conserved area; the semi-axes follow an ODE with an exact
solution (``exact_solution``).  WCSPH with the Gaussian kernel, the EPEC
integrator and adaptive dt, one fluid and no walls; ``--scheme iisph``
(``IISPHScheme``, Euler, dt 2e-4 and adaptive) is the reference's other
run.  On an NVIDIA card:

    python -m pysph_tpu_torch.examples.elliptical_drop --nx 200 \\
        --disable-output                      # wcsph_pair
    python -m pysph_tpu_torch.examples.elliptical_drop --nx 200 \\
        --engine dense --disable-output       # dense_pair
    python -m pysph_tpu_torch.examples.elliptical_drop --nx 200 \\
        --scheme iisph --disable-output       # iisph_pair

``--nx 40`` (the default, 5,021 particles) is the published size.  On
the CPU: ``--device cpu --use-double``.  ``post_process`` reads the last
dump and compares the semi-minor axis with the exact one.
"""

import os

import numpy as np

from pysph_tpu_torch.base.kernels import Gaussian
from pysph_tpu_torch.base.utils import get_particle_array
from pysph_tpu_torch.solver.application import Application
from pysph_tpu_torch.sph.integrator import EPECIntegrator
from pysph_tpu_torch.sph.iisph import IISPHScheme
from pysph_tpu_torch.sph.scheme import SchemeChooser, WCSPHScheme


def _axis_rate(state, t):
    A, a = state
    return np.array([A * A * (a ** 4 - 1) / (a ** 4 + 1), -a * A])


def exact_solution(tf=0.0075, dt=1e-6, n=101):
    """Integrate the semi-axis ODE to ``tf`` (host numpy).

    Returns (a, A, p0, x, y): the semi-minor axis ``a`` (the semi-major
    one is 1/a), its rate ``A``, the centre pressure and the ellipse."""
    y = np.array([100.0, 1.0])
    t = 0.0
    while t <= tf:
        t += dt
        y = y + dt * _axis_rate(y, t)
    Anew, anew = y
    dadt = _axis_rate([Anew, anew], tf)[0]
    po = 0.5 * -anew ** 2 * (dadt - Anew ** 2)
    theta = np.linspace(0, 2 * np.pi, n)
    return anew, Anew, po, anew * np.cos(theta), \
        1 / anew * np.sin(theta)


class EllipticalDrop(Application):
    def initialize(self):
        self.co = 1400.0
        self.ro = 1.0
        self.hdx = 1.3
        self.dx = 0.025
        self.alpha = 0.1

    def add_user_options(self, group):
        group.add_argument(
            '--nx', action='store', type=int, dest='nx', default=40,
            help='Number of points along x direction.')

    def consume_user_options(self):
        self.dx = 1.0 / self.options.nx

    def create_scheme(self):
        wcsph = WCSPHScheme(
            ['fluid'], [], dim=2, rho0=self.ro, c0=self.co,
            h0=self.dx * self.hdx, hdx=self.hdx, gamma=7.0, alpha=0.1,
            beta=0.0)
        iisph = IISPHScheme(['fluid'], [], dim=2, rho0=self.ro)
        return SchemeChooser(default='wcsph', wcsph=wcsph, iisph=iisph)

    def configure_scheme(self):
        tf = 0.0076
        if self.options.scheme == 'iisph':
            self.scheme.configure_solver(
                kernel=Gaussian(dim=2), dt=2e-4, tf=tf,
                adaptive_timestep=True)
            return
        dt = 0.25 * self.hdx * self.dx / (141 + self.co)
        self.scheme.configure(h0=self.hdx * self.dx)
        self.scheme.configure_solver(
            kernel=Gaussian(dim=2), integrator_cls=EPECIntegrator, dt=dt,
            tf=tf, adaptive_timestep=True, cfl=0.3, n_damp=50,
            output_at_times=[0.0008, 0.0038])

    def create_particles(self):
        """Circular patch of particles with the initial strain field."""
        dx = self.dx
        span = np.arange(-1.05, 1.05 + 1e-9, dx)
        x, y = np.meshgrid(span, span)
        x = x.ravel()
        y = y.ravel()
        keep = x * x + y * y < 1.0
        x = x[keep]
        y = y[keep]
        pa = get_particle_array(
            name='fluid', x=x, y=y, m=np.ones_like(x) * dx * dx,
            rho=np.ones_like(x) * self.ro, h=np.ones_like(x) * self.hdx * dx,
            u=-100.0 * x, v=100.0 * y, cs=np.ones_like(x) * self.co)
        if not self.options.quiet:
            print('Elliptical drop: %d particles' % len(x))
        return [pa]

    def post_process(self, info_fname_or_dir='.'):
        """Compare the semi-minor axis of the last dump with the exact
        one; writes ``results.npz`` into the output directory."""
        from pysph_tpu_torch.solver.output import load
        files = self.output_files
        if not files:
            return
        data = load(files[-1])
        fluid = data['arrays']['fluid']
        tf = float(data['solver_data']['t'])
        a_exact = exact_solution(tf)[0]
        # the semi-minor axis from the particles' extent along x
        a_num = np.max(np.abs(np.asarray(fluid.x))) - self.dx * 0.5
        result = dict(t=tf, a_exact=float(a_exact), a_num=float(a_num))
        np.savez(os.path.join(self.output_dir, 'results.npz'), **result)
        print('Exact semi-minor axis: %.5f, computed: %.5f' %
              (a_exact, a_num))
        return result


if __name__ == '__main__':
    app = EllipticalDrop()
    app.run()
    app.post_process(app.info_filename)
