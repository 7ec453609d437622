"""The hydrostatic box: a dense square in pressure equilibrium inside a
light medium, in a box periodic in x and y; nothing should move.

Port of ``pysph_tpu/examples/gas_dynamics/hydrostatic_box.py``: a cubic
lattice of ``--nx`` x ``--nx`` particles on [0, 1]^2 (50 by default) at
p = 1, rho 4 inside (0.25, 0.75)^2 and 1 outside (the masses dx^2 rho
set it), gamma 1.5, h = 1.5 dx, dt = 1e-3 to tf = 10.  The default,
``--scheme crksph`` (``CRKSPHScheme``, cl = 2, no viscosity;
``CRKSPHIntegrator``, two evaluators a step, ``QuinticSpline``; its six
pair phase sets on ``crksph_pair``), ``gsph`` (``GSPHScheme``, the local
Lax-Friedrichs solver; Euler with ``GSPHStep``), ``mpm`` (``GasDScheme``,
kernel_factor 1.2, no viscosity) and ``adke`` (``ADKEScheme``: alpha =
beta = 0.1, k = 1.5, g1 = g2 = 0.1) and ``tsph`` (``TSPHScheme``, hfact
1.2; its three pair sets on ``tsph_pair``) are ported; ``gsph`` and
``mpm`` take the adaptive dt.  The reference's ``psph`` and ``magma2``
raise ``NotImplementedError`` naming their ROADMAP item.  On an NVIDIA
card:

    python -m pysph_tpu_torch.examples.gas_dynamics.hydrostatic_box \\
        --max-steps 200 --disable-output [--scheme gsph|mpm|adke|tsph]

On the CPU: ``--device cpu --use-double``.  ``figures`` gives a state's
largest speed and the largest relative departure of rho from the
density its mass was set for.
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

#: the reference's other schemes: the ROADMAP item that ports them
_NOT_PORTED = {
    'psph': 'ROADMAP Queue 1 item 28, remaining physics',
    'magma2': 'ROADMAP Queue 1 item 28, remaining physics',
}


def figures(u, v, rho, m, dx):
    """A state's figures (float64 on the host): ``max_speed``, the
    largest |(u, v)|; ``rho_spread``, the largest |rho / rho_set - 1|
    with rho_set = m / dx^2, the density each particle's mass was set
    for (4 in the square, 1 outside)."""
    u, v, rho, m = (numpy.asarray(a, dtype=numpy.float64)
                    for a in (u, v, rho, m))
    rho_set = m / (dx * dx)
    return dict(max_speed=float(numpy.sqrt(u * u + v * v).max()),
                rho_spread=float(numpy.abs(rho / rho_set - 1.0).max()))


class HydrostaticBox(Application):
    def initialize(self):
        self.xmin = 0.0
        self.xmax = 1.0
        self.ymin = 0.0
        self.ymax = 1.0
        self.gamma = 1.5
        self.p = 1
        self.rho0 = 1
        self.rhoi = 4
        self.nx = 50
        self.ny = self.nx
        self.dx = (self.xmax - self.xmin) / self.nx
        self.hdx = 1.5
        self.dt = 1e-3
        self.tf = 10

    def add_user_options(self, group):
        group.add_argument('--nx', action='store', type=int,
                           dest='nx', default=50,
                           help='Particles along x.')

    def consume_user_options(self):
        self.nx = self.options.nx
        self.ny = self.nx
        self.dx = (self.xmax - self.xmin) / self.nx

    def create_particles(self):
        data = ud.uniform_distribution_cubic2D(
            self.dx, self.xmin, self.xmax, self.ymin, self.ymax)
        x, y = data[0], data[1]
        box = (x > 0.25) & (x < 0.75) & (y > 0.25) & (y < 0.75)
        rho = numpy.where(box, float(self.rhoi), float(self.rho0))
        e = self.p / ((self.gamma - 1) * rho)
        m = self.dx * self.dx * rho
        h = self.hdx * self.dx
        fluid = gpa(name='fluid', x=x, y=y, p=self.p, rho=rho, e=e,
                    u=0.0, v=0.0, h=h, m=m, h0=h)
        self.scheme.setup_properties([fluid])
        return [fluid]

    def create_domain(self):
        return DomainManager(
            xmin=self.xmin, xmax=self.xmax, ymin=self.ymin,
            ymax=self.ymax, periodic_in_x=True, periodic_in_y=True)

    def create_scheme(self):
        gsph = GSPHScheme(
            fluids=['fluid'], solids=[], dim=2, gamma=self.gamma,
            kernel_factor=1.0, g1=0.0, g2=0.0, rsolver=7,
            interpolation=1, monotonicity=1, interface_zero=True,
            hybrid=False, blend_alpha=5.0, niter=40, tol=1e-6)
        mpm = GasDScheme(
            fluids=['fluid'], solids=[], dim=2, gamma=self.gamma,
            kernel_factor=1.2, alpha1=0, alpha2=0, beta=2.0,
            update_alpha1=False, update_alpha2=False)
        crk = CRKSPHScheme(
            fluids=['fluid'], dim=2, rho0=0, c0=0, nu=0, h0=0, p0=0,
            gamma=self.gamma, cl=2)
        adke = ADKEScheme(
            fluids=['fluid'], solids=[], dim=2, gamma=self.gamma,
            alpha=0.1, beta=0.1, k=1.5, eps=0.0, g1=0.1, g2=0.1)
        tsph = TSPHScheme(
            fluids=['fluid'], solids=[], dim=2, gamma=self.gamma,
            hfact=1.2)
        others = {name: NotPortedScheme(name, item)
                  for name, item in _NOT_PORTED.items()}
        return SchemeChooser(default='crksph', crksph=crk, adke=adke,
                             mpm=mpm, gsph=gsph, tsph=tsph, **others)

    def configure_scheme(self):
        s = self.scheme
        adaptive = self.options.scheme in ('gsph', 'mpm')
        if self.options.scheme == 'mpm':
            s.configure(kernel_factor=1.2)
        elif self.options.scheme == 'tsph':
            s.configure(hfact=1.2)
        s.configure_solver(dt=self.dt, tf=self.tf,
                           adaptive_timestep=adaptive)
        s.get_solver().set_print_freq(50)


if __name__ == "__main__":
    app = HydrostaticBox()
    app.run()
