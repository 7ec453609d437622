"""Taylor-Green vortex: 2D periodic decaying vortices.

Port of ``pysph_tpu/examples/taylor_green.py``: a unit box periodic in x
and y holds the vortices ``u = -U cos(2 pi x) sin(2 pi y)``, ``v = U
sin(2 pi x) cos(2 pi y)``, whose speed decays as ``U exp(-8 pi^2 t /
Re)`` (``exact_solution``).  Three of the reference's schemes, each
with ``QuinticSpline`` and a fixed dt, their pair phases on the periodic
grid:

- ``--scheme tvf`` (the default), the Transport Velocity Formulation
  (``TVFScheme``: ``PECIntegrator`` with ``TransportVelocityStep``),
  on ``tvf_pair``;
- ``--scheme wcsph`` (``WCSPHScheme`` with the Tait EOS, no artificial
  viscosity, ``LaminarViscosity``; ``PECIntegrator`` with ``WCSPHStep``),
  on ``wcsph_pair`` (``--engine dense``: ``dense_pair``);
- ``--scheme gtvf`` (``GTVFScheme`` without walls, ``pref = p0``;
  ``GTVFIntegrator``, two evaluators a step), on ``gtvf_pair``.

On an NVIDIA card:

    python -m pysph_tpu_torch.examples.taylor_green --nx 400 \\
        --max-steps 200 --disable-output [--scheme wcsph|gtvf]

(160,000 particles, h = dx = 2.5e-3, dt = 5.68e-5 s); ``--nx 50`` (the
default, 2,500 particles) is the reference's size.  On the CPU:
``--device cpu --use-double``.  ``post_process`` compares max |v| and
the L1 error of |v| of every dump with the exact decay and writes
``results.npz``.  The reference's other schemes raise
``NotImplementedError`` naming their ROADMAP items.
"""

import os

import numpy as np

from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.kernels import QuinticSpline
from pysph_tpu_torch.base.utils import get_particle_array
from pysph_tpu_torch.solver.application import Application
from pysph_tpu_torch.sph.scheme import (
    NotPortedScheme, SchemeChooser, TVFScheme, WCSPHScheme)
from pysph_tpu_torch.sph.wc.gtvf import GTVFScheme

L = 1.0
U = 1.0
rho0 = 1.0
c0 = 10 * U
p0 = c0 ** 2 * rho0

#: the reference's other schemes: the ROADMAP items that port them
_NOT_PORTED = {
    'edac': 'ROADMAP Queue 1 item 35',
    'iisph': 'ROADMAP Queue 1 item 26',
    'crksph': 'ROADMAP Queue 1 item 28, remaining physics',
    'pcisph': 'ROADMAP Queue 1 item 28, remaining physics',
    'sisph': 'ROADMAP Queue 1 item 28, remaining physics',
    'isph': 'ROADMAP Queue 1 item 28, remaining physics',
}


def exact_solution(U, b, t, x, y):
    """The decaying Taylor-Green velocities and pressure."""
    factor = U * np.exp(b * t)
    pi2 = 2 * np.pi
    u = -np.cos(pi2 * x) * np.sin(pi2 * y)
    v = np.sin(pi2 * x) * np.cos(pi2 * y)
    p = -0.25 * (np.cos(2 * pi2 * x) + np.cos(2 * pi2 * y))
    return factor * u, factor * v, factor * factor * p


class TaylorGreen(Application):
    def add_user_options(self, group):
        group.add_argument(
            '--perturb', action='store', type=float, dest='perturb',
            default=0, help='Random perturbation fraction of dx.')
        group.add_argument(
            '--nx', action='store', type=int, dest='nx', default=50,
            help='Number of points along x.')
        group.add_argument(
            '--re', action='store', type=float, dest='re', default=100,
            help='Reynolds number.')
        group.add_argument(
            '--hdx', action='store', type=float, dest='hdx', default=1.0,
            help='h/dx.')
        group.add_argument(
            '--pb-factor', action='store', type=float, dest='pb_factor',
            default=1.0, help='Background pressure factor.')

    def consume_user_options(self):
        nx = self.options.nx
        re = self.options.re
        self.nu = U * L / re
        self.dx = L / nx
        self.hdx = self.options.hdx
        h0 = self.hdx * self.dx
        dt_cfl = 0.25 * h0 / (c0 + U)
        dt_viscous = 0.125 * h0 ** 2 / self.nu
        self.dt = min(dt_cfl, dt_viscous, 0.25)
        self.tf = 2.0

    def create_scheme(self):
        wcsph = WCSPHScheme(['fluid'], [], dim=2, rho0=rho0, c0=c0,
                            h0=None, hdx=None, nu=None, gamma=7.0,
                            alpha=0.0, beta=0.0)
        tvf = TVFScheme(['fluid'], [], dim=2, rho0=rho0, c0=c0, nu=None,
                        p0=p0, pb=None, h0=None)
        gtvf = GTVFScheme(fluids=['fluid'], solids=[], dim=2, rho0=rho0,
                          c0=c0, nu=None, h0=None, pref=None)
        others = {name: NotPortedScheme(name, item)
                  for name, item in _NOT_PORTED.items()}
        return SchemeChooser(default='tvf', wcsph=wcsph, tvf=tvf,
                             gtvf=gtvf, **others)

    def configure_scheme(self):
        h0 = self.hdx * self.dx
        choice = self.options.scheme
        if choice == 'tvf':
            self.scheme.configure(pb=self.options.pb_factor * p0,
                                  nu=self.nu, h0=h0)
        elif choice == 'wcsph':
            self.scheme.configure(hdx=self.hdx, nu=self.nu, h0=h0)
        elif choice == 'gtvf':
            self.scheme.configure(pref=p0, nu=self.nu, h0=h0)
        self.scheme.configure_solver(kernel=QuinticSpline(dim=2),
                                     tf=self.tf, dt=self.dt)
        self.scheme.get_solver().set_print_freq(500)

    def create_domain(self):
        return DomainManager(xmin=0, xmax=L, ymin=0, ymax=L,
                             periodic_in_x=True, periodic_in_y=True)

    def create_particles(self):
        dx = self.dx
        span = np.arange(dx / 2, L, dx)
        x, y = np.meshgrid(span, span)
        x = x.ravel()
        y = y.ravel()
        if self.options.perturb > 0:
            rng = np.random.RandomState(1234)
            factor = dx * self.options.perturb
            x += rng.random(x.shape) * factor
            y += rng.random(y.shape) * factor
        h = np.ones_like(x) * self.hdx * dx
        m = np.ones_like(x) * dx * dx * rho0
        u, v, p = exact_solution(U, 0.0, 0.0, x, y)
        pa = get_particle_array(
            name='fluid', x=x, y=y, h=h, m=m, rho=rho0 * np.ones_like(x),
            u=u, v=v, p=p)
        self.scheme.setup_properties([pa])
        pa.V = 1.0 / (dx * dx) * np.ones_like(x)
        if not self.options.quiet:
            print('Taylor-Green: %d particles, dt=%g' % (len(x), self.dt))
        return [pa]

    def post_process(self, info_fname_or_dir='.'):
        """max |v| and the L1 error of |v| against the exact decay at
        every dump, into ``results.npz`` (t, decay, decay_ex, l1)."""
        from pysph_tpu_torch.solver.output import load
        files = self.output_files
        if not files:
            return
        results = []
        for f in files:
            data = load(f)
            fluid = data['arrays']['fluid']
            t = float(data['solver_data']['t'])
            x, y = np.asarray(fluid.x), np.asarray(fluid.y)
            u, v = np.asarray(fluid.u), np.asarray(fluid.v)
            results.append((t,) + decay_errors(x, y, u, v, t,
                                               self.options.re))
        results = np.array(results)
        out = os.path.join(self.output_dir, 'results.npz')
        np.savez(out, t=results[:, 0], decay=results[:, 1],
                 decay_ex=results[:, 2], l1=results[:, 3])
        print('t=%.3f: max|v|=%.4f exact=%.4f L1=%.5f' %
              tuple(results[-1]))
        return results


def decay_errors(x, y, u, v, t, re):
    """(max |v|, its exact value U exp(-8 pi^2 t / Re), the mean
    absolute error of |v|) of a state at time ``t``."""
    decay_rate = -8.0 * np.pi ** 2 / re
    u_e, v_e, _ = exact_solution(U, decay_rate, t, x, y)
    vmag = np.sqrt(u ** 2 + v ** 2)
    vmag_e = np.sqrt(u_e ** 2 + v_e ** 2)
    return (float(vmag.max()), float(U * np.exp(decay_rate * t)),
            float(np.mean(np.abs(vmag - vmag_e))))


if __name__ == '__main__':
    app = TaylorGreen()
    app.run()
    app.post_process(app.info_filename)
