"""Sedov's point explosion in 2D.

Port of ``pysph_tpu/examples/gas_dynamics/sedov.py``: a uniform lattice
of ``--nx`` x ``--nx`` particles on [-0.5, 0.5]^2 (rho 1, gamma 5/3)
with the blast energy E = 1 deposited at the origin, smoothed by the
cubic spline over the central kernel support, under ``GasDScheme``
(``--scheme mpm``, the default): the grad-h density iteration re-binned
every sweep, the ideal-gas EOS and ``MPMAccelerations`` with the
viscosity and conduction switches updated (alpha1 10, alpha2 1);
``PECIntegrator`` with ``GasDFluidStep``, the ``Gaussian`` kernel, dt =
1e-4 to tf = 0.1.  Both pair sets run in ``gasd_pair``.  ``--scheme
tsph`` is ``TSPHScheme`` (hfact 1.2, PEC with TSPH's ``PECStep``): its
number-density iteration and its two other pair sets run in
``tsph_pair``.  The reference's ``psph`` and ``magma2`` schemes raise
``NotImplementedError`` naming their ROADMAP item.  On an NVIDIA card:

    python -m pysph_tpu_torch.examples.gas_dynamics.sedov --nx 401 \\
        --max-steps 200 --disable-output [--scheme tsph]

(160,801 particles); ``--nx 101`` (the default) is the reference's size.
On the CPU: ``--device cpu --use-double``.  ``figures`` gives the
blast's shell radius, peak density and total energy of a state;
``post_process`` writes the last dump's radial density profile.
"""

import numpy
import torch

from pysph_tpu_torch.base.kernels import CubicSpline
from pysph_tpu_torch.base.utils import get_particle_array as gpa
from pysph_tpu_torch.solver.application import Application
from pysph_tpu_torch.sph.gas_dynamics.tsph import TSPHScheme
from pysph_tpu_torch.sph.scheme import (
    GasDScheme, NotPortedScheme, SchemeChooser)

dim = 2
gamma = 5.0 / 3.0
gamma1 = gamma - 1.0

dt = 1e-4
tf = 0.1

alpha1 = 10.0
alpha2 = 1.0
beta = 2.0
kernel_factor = 1.2

#: the reference's other schemes: the ROADMAP item that ports them
_NOT_PORTED = {
    'psph': 'ROADMAP Queue 1 item 28, remaining physics',
    'magma2': 'ROADMAP Queue 1 item 28, remaining physics',
}
#: the density above which a particle is in the blast's shell
SHELL_RHO = 1.2


def figures(x, y, u, v, rho, m, e):
    """The blast's figures of a state (float64 on the host): ``radius``,
    the density-weighted mean radius of the particles with rho >
    ``SHELL_RHO``; ``peak``, the largest density; ``energy``, the total
    kinetic plus internal energy, sum m (|v|^2 / 2 + e)."""
    x, y, u, v, rho, m, e = (numpy.asarray(a, dtype=numpy.float64)
                             for a in (x, y, u, v, rho, m, e))
    shell = rho > SHELL_RHO
    r = numpy.sqrt(x * x + y * y)
    radius = float(numpy.sum(rho[shell] * r[shell]) /
                   max(numpy.sum(rho[shell]), 1e-300))
    return dict(radius=radius, peak=float(rho.max()),
                energy=float(numpy.sum(m * (0.5 * (u * u + v * v) + e))))


class SedovPointExplosion(Application):
    def add_user_options(self, group):
        group.add_argument('--nx', action='store', type=int,
                           dest='nx', default=101,
                           help='Particles per side.')

    def create_particles(self):
        nx = self.options.nx
        dx = 1.0 / (nx - 1)
        x, y = numpy.mgrid[-0.5:0.5 + 1e-9:dx, -0.5:0.5 + 1e-9:dx]
        x, y = x.ravel(), y.ravel()
        rho0 = 1.0
        m = rho0 * dx * dx
        h = kernel_factor * dx

        # blast energy E=1 smoothed over the central kernel support:
        # e_i = E w_i / sum_j(m_j w_j), the kernel taken in float64
        r = numpy.sqrt(x ** 2 + y ** 2)
        w = CubicSpline(dim=2).kernel(
            None, torch.as_tensor(r, dtype=torch.float64), 2 * h).numpy()
        E = 1.0
        e = 1e-9 + E * w / max(m * w.sum(), 1e-30)
        p = gamma1 * rho0 * e

        fluid = gpa(name='fluid', x=x, y=y, rho=rho0, p=p, e=e, h=h,
                    m=m, additional_props=['e'])
        self.scheme.setup_properties([fluid])
        fluid.h[:] = kernel_factor * (
            numpy.asarray(fluid.m) / numpy.asarray(fluid.rho)
        ) ** (1.0 / dim)
        if not self.options.quiet:
            print("Sedov's point explosion with %d particles"
                  % fluid.get_number_of_particles())
        return [fluid]

    def create_scheme(self):
        mpm = GasDScheme(
            fluids=['fluid'], solids=[], dim=dim, gamma=gamma,
            kernel_factor=kernel_factor, alpha1=alpha1,
            alpha2=alpha2, beta=beta, adaptive_h_scheme='mpm',
            update_alpha1=True, update_alpha2=True)
        tsph = TSPHScheme(fluids=['fluid'], solids=[], dim=dim,
                          gamma=gamma, hfact=kernel_factor)
        others = {name: NotPortedScheme(name, item)
                  for name, item in _NOT_PORTED.items()}
        return SchemeChooser(default='mpm', mpm=mpm, tsph=tsph, **others)

    def configure_scheme(self):
        self.scheme.configure_solver(dt=dt, tf=tf,
                                     adaptive_timestep=False)
        self.scheme.get_solver().set_print_freq(25)

    def post_process(self, info_fname_or_dir='.'):
        """The radial density profile of the last dump, into
        ``results.npz``."""
        from pysph_tpu_torch.solver.output import load
        files = self.output_files
        if not files:
            return
        data = load(files[-1])
        fluid = data['arrays']['fluid']
        r = numpy.sqrt(numpy.asarray(fluid.x) ** 2 +
                       numpy.asarray(fluid.y) ** 2)
        rho = numpy.asarray(fluid.rho)
        numpy.savez(self.output_dir + '/results.npz', r=r, rho=rho)
        print('peak density %.3f at r=%.3f' % (rho.max(),
                                               r[rho.argmax()]))
        return r, rho


if __name__ == '__main__':
    app = SedovPointExplosion()
    app.run()
    app.post_process(app.info_filename)
