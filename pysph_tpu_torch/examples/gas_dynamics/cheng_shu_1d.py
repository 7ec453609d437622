r"""Cheng and Shu's 1D acoustic wave: a density and velocity wave in a
line periodic in x.

Port of ``pysph_tpu/examples/gas_dynamics/cheng_shu_1d.py``:
``--n-particles`` (1,000) particles evenly on [0, 1] (both ends, as the
reference's), rho = 2 + sin(2 pi x), p = 1, u = 1 + 0.1 sin(2 pi x),
gamma 1.4, h = 2 dx, a fixed dt of 1e-4 to tf = 1.0.  ``--scheme gsph``
(the default: ``GSPHScheme`` with the exact solver (3), I02 monotonicity,
linear interpolation; Euler with ``GSPHStep``; its density groups on
``gasd_pair``, its gradients and accelerations on ``gsph_pair``) and
``tsph`` (``TSPHScheme`` with hfact 1.2: PEC with TSPH's ``PECStep``; its
three pair sets on ``tsph_pair``) are ported, both with the 1D Gaussian;
the reference's ``psph`` and ``magma2`` raise ``NotImplementedError``
naming their ROADMAP item.  On an NVIDIA card:

    python -m pysph_tpu_torch.examples.gas_dynamics.cheng_shu_1d \\
        --max-steps 200 --disable-output [--scheme tsph]

On the CPU: ``--device cpu --use-double``.  ``figures`` gives the mean
|rho - the initial profile carried at unit speed|, the largest rho and
the largest u of a state.
"""

import numpy

from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.utils import get_particle_array as gpa
from pysph_tpu_torch.solver.application import Application
from pysph_tpu_torch.sph.gas_dynamics.tsph import TSPHScheme
from pysph_tpu_torch.sph.scheme import (
    GSPHScheme, NotPortedScheme, SchemeChooser)

#: the reference's other schemes: the ROADMAP item that ports them
_NOT_PORTED = {
    'psph': 'ROADMAP Queue 1 item 28, remaining physics',
    'magma2': 'ROADMAP Queue 1 item 28, remaining physics',
}


def figures(x, rho, u, t):
    """{'rho_l1': mean |rho - (2 + sin(2 pi (x - t)))|, 'rho_max', 'u_max'}
    of a state at time ``t`` (float64 on the host)."""
    x, rho, u = (numpy.asarray(a, dtype=numpy.float64) for a in (x, rho, u))
    carried = 2 + numpy.sin(2 * numpy.pi * (x - t))
    return {'rho_l1': float(numpy.abs(rho - carried).mean()),
            'rho_max': float(rho.max()), 'u_max': float(u.max())}


class ChengShu(Application):
    def initialize(self):
        self.xmin = 0.0
        self.xmax = 1.0
        self.gamma = 1.4
        self.p_0 = 1.0
        self.c_0 = 1.0
        self.delta_rho = 1
        self.n_particles = 1000
        self.domain_length = self.xmax - self.xmin
        self.dx = self.domain_length / (self.n_particles - 1)
        self.k = 2 * numpy.pi / self.domain_length
        self.hdx = 2.0
        self.dt = 1e-4
        self.tf = 1.0
        self.dim = 1

    def add_user_options(self, group):
        group.add_argument('--n-particles', action='store', type=int,
                           dest='n_particles', default=1000,
                           help='Number of particles.')

    def consume_user_options(self):
        self.n_particles = self.options.n_particles
        self.dx = self.domain_length / (self.n_particles - 1)

    def create_domain(self):
        return DomainManager(xmin=self.xmin, xmax=self.xmax,
                             periodic_in_x=True)

    def create_particles(self):
        x = numpy.linspace(self.xmin, self.xmax, self.n_particles)
        rho = 2 + numpy.sin(2 * numpy.pi * x) * self.delta_rho
        p = numpy.ones_like(x)
        u = 1 + 0.1 * numpy.sin(2 * numpy.pi * x)
        cs = numpy.sqrt(self.gamma * p / rho)
        h = numpy.ones_like(x) * self.dx * self.hdx
        m = numpy.ones_like(x) * self.dx * rho
        e = p / ((self.gamma - 1) * rho)
        fluid = gpa(name='fluid', x=x, p=p, rho=rho, u=u, h=h, m=m,
                    e=e, cs=cs)
        self.scheme.setup_properties([fluid])
        return [fluid]

    def create_scheme(self):
        gsph = GSPHScheme(
            fluids=['fluid'], solids=[], dim=self.dim,
            gamma=self.gamma, kernel_factor=1.0, g1=0.0, g2=0.0,
            rsolver=3, interpolation=1, monotonicity=1,
            interface_zero=True, hybrid=False, blend_alpha=5.0,
            niter=200, tol=1e-6)
        tsph = TSPHScheme(
            fluids=['fluid'], solids=[], dim=self.dim,
            gamma=self.gamma, hfact=1.2)
        others = {name: NotPortedScheme(name, item)
                  for name, item in _NOT_PORTED.items()}
        return SchemeChooser(default='gsph', gsph=gsph, tsph=tsph, **others)

    def configure_scheme(self):
        s = self.scheme
        if self.options.scheme == 'tsph':
            s.configure(hfact=1.2)
        s.configure_solver(dt=self.dt, tf=self.tf,
                           adaptive_timestep=False)
        s.get_solver().set_print_freq(1000)


if __name__ == '__main__':
    app = ChengShu()
    app.run()
