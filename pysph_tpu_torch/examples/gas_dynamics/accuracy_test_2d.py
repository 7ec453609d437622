"""The 2D constant-pressure accuracy test: a density wave advected
through a box periodic in x and y.

Port of ``pysph_tpu/examples/gas_dynamics/accuracy_test_2d.py``: a
cubic lattice of ``--nparticles`` x ``--nparticles`` particles on [0,
1]^2 (256^2 = 65,536 by default) at p = 1 with rho = 1 + 0.2 sin(pi (x
+ y)), all moving with (u, v) = (1, -1), gamma 1.4, dt = 0.1 dx / 1.18
to tf = 1.0, when the wave is back where it started; ``l1_norm`` is the
mean |rho - the exact profile| at the particles.  ``--scheme gsph`` (the
default: ``GSPHScheme`` with the local Lax-Friedrichs solver, I02
monotonicity, linear interpolation; Euler with ``GSPHStep``; the
density groups on ``gasd_pair``, the gradients and accelerations on
``gsph_pair``), ``mpm`` (``GasDScheme`` with kernel_factor 1.5 and no
viscosity, adaptive dt), ``adke`` (``ADKEScheme`` with k = 1.5, no
viscosity or conduction) and ``crksph`` (``CRKSPHScheme`` with cl = 2,
no viscosity: ``CRKSPHIntegrator``, two evaluators a step,
``QuinticSpline``; its six pair phase sets on ``crksph_pair``) and
``tsph`` (``TSPHScheme`` with hfact 1.5: PEC with TSPH's ``PECStep``,
the Gaussian; its number-density iteration a gated ``tsph_sweep`` a
sweep, its velocity gradient and momentum on ``tsph_pair``) are ported;
the reference's ``psph`` and ``magma2`` raise ``NotImplementedError``
naming their ROADMAP item.  On an NVIDIA card:

    python -m pysph_tpu_torch.examples.gas_dynamics.accuracy_test_2d \\
        --disable-output [--scheme mpm|adke|crksph|tsph]

On the CPU: ``--device cpu --use-double --nparticles 32``.
``post_process`` prints and returns the last dump's ``l1_norm``.
"""

import numpy

from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.utils import get_particle_array as gpa
from pysph_tpu_torch.solver.application import Application
from pysph_tpu_torch.sph.gas_dynamics.tsph import TSPHScheme
from pysph_tpu_torch.sph.scheme import (
    ADKEScheme, GasDScheme, GSPHScheme, NotPortedScheme, SchemeChooser)
from pysph_tpu_torch.sph.wc.crksph import CRKSPHScheme
from pysph_tpu_torch.tools import uniform_distribution as ud

dim = 2
gamma = 1.4
gamma1 = gamma - 1.0
tf = 1.0

xmin, xmax = 0.0, 1.0
ymin, ymax = 0.0, 1.0

alpha1 = 1.0
alpha2 = 0.1
beta = 2.0
kernel_factor = 1.5

#: the reference's other schemes: the ROADMAP item that ports them
_NOT_PORTED = {
    'psph': 'ROADMAP Queue 1 item 28, remaining physics',
    'magma2': 'ROADMAP Queue 1 item 28, remaining physics',
}


def exact_density(x, y):
    """The advected profile at a whole period: 1 + 0.2 sin(pi (x + y))."""
    return 1 + 0.2 * numpy.sin(numpy.pi * (x + y))


def l1_norm(x, y, rho):
    """The mean absolute error of ``rho`` against ``exact_density`` at
    the particles (float64 on the host)."""
    x, y, rho = (numpy.asarray(a, dtype=numpy.float64) for a in (x, y, rho))
    return float(numpy.sum(numpy.abs(rho - exact_density(x, y))) / rho.size)


class AccuracyTest2D(Application):
    def initialize(self):
        self.xmin, self.xmax = xmin, xmax
        self.ymin, self.ymax = ymin, ymax
        self.ny = 128
        self.nx = self.ny
        self.dx = (self.xmax - self.xmin) / self.nx
        self.hdx = 2.0
        self.p = 1.0
        self.u = 1
        self.v = -1
        self.c_0 = 1.18
        self.cfl = 0.1

    def add_user_options(self, group):
        group.add_argument(
            '--nparticles', action='store', type=int, dest='nprt',
            default=256, help='Number of particles in domain')

    def consume_user_options(self):
        self.nx = self.options.nprt
        self.ny = self.nx
        self.dx = (self.xmax - self.xmin) / self.nx
        self.dt = self.cfl * self.dx / self.c_0

    def create_domain(self):
        return DomainManager(
            xmin=xmin, xmax=xmax, ymin=ymin, ymax=ymax,
            periodic_in_x=True, periodic_in_y=True)

    def create_particles(self):
        data = ud.uniform_distribution_cubic2D(
            self.dx, xmin, xmax, ymin, ymax)
        x = numpy.ravel(data[0])
        y = numpy.ravel(data[1])
        dx = data[2]
        volume = dx * dx
        rho = exact_density(x, y)
        p = numpy.ones_like(x) * self.p
        h = numpy.ones_like(x) * self.hdx * dx
        m = numpy.ones_like(x) * volume * rho
        u = numpy.ones_like(x) * self.u
        v = numpy.ones_like(x) * self.v
        e = p / (gamma1 * rho)
        fluid = gpa(name='fluid', x=x, y=y, rho=rho, p=p, e=e, h=h,
                    m=m, h0=h.copy(), u=u, v=v)
        self.scheme.setup_properties([fluid])
        if not self.options.quiet:
            print("2D Accuracy Test with %d particles"
                  % fluid.get_number_of_particles())
        return [fluid]

    def create_scheme(self):
        self.tf = tf
        adke = ADKEScheme(
            fluids=['fluid'], solids=[], dim=dim, gamma=gamma,
            alpha=0, beta=0, k=1.5, eps=0.0, g1=0.0, g2=0.0)
        mpm = GasDScheme(
            fluids=['fluid'], solids=[], dim=dim, gamma=gamma,
            kernel_factor=kernel_factor, alpha1=0, alpha2=0,
            beta=beta)
        crksph = CRKSPHScheme(
            fluids=['fluid'], dim=dim, rho0=0, c0=0, nu=0, h0=0,
            p0=0, gamma=gamma, cl=2)
        gsph = GSPHScheme(
            fluids=['fluid'], solids=[], dim=dim, gamma=gamma,
            kernel_factor=1.0, g1=0.0, g2=0.0, rsolver=7,
            interpolation=1, monotonicity=1, interface_zero=True,
            hybrid=False, blend_alpha=5.0, niter=40, tol=1e-6)
        tsph = TSPHScheme(
            fluids=['fluid'], solids=[], dim=dim, gamma=gamma,
            hfact=kernel_factor)
        others = {name: NotPortedScheme(name, item)
                  for name, item in _NOT_PORTED.items()}
        return SchemeChooser(default='gsph', adke=adke, mpm=mpm, gsph=gsph,
                             crksph=crksph, tsph=tsph, **others)

    def configure_scheme(self):
        s = self.scheme
        if self.options.scheme == 'mpm':
            s.configure(kernel_factor=kernel_factor)
            s.configure_solver(dt=self.dt, tf=self.tf,
                               adaptive_timestep=True)
        else:
            s.configure_solver(dt=self.dt, tf=self.tf,
                               adaptive_timestep=False)
        s.get_solver().set_print_freq(50)

    def post_process(self, info_fname_or_dir='.'):
        """Print and return the ``l1_norm`` of the last dump."""
        from pysph_tpu_torch.solver.output import load
        if len(self.output_files) < 1:
            return
        data = load(self.output_files[-1])
        pa = data['arrays']['fluid']
        l1 = l1_norm(pa.x, pa.y, pa.rho)
        print(l1)
        return l1


if __name__ == '__main__':
    app = AccuracyTest2D()
    app.run()
    app.post_process()
