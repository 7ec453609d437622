"""Sod's shock tube: 1D compressible gas dynamics with free ends.

Port of ``pysph_tpu/examples/gas_dynamics/shocktube.py``: gas at rest
on [-0.5, 0.5] with a diaphragm at x = 0 (rho 1 | 0.125, p 1 | 0.1,
gamma 1.4; ``--nl`` particles on the left, ``--nl / 8`` on the right,
so h jumps by the density ratio there), run to tf = 0.15 with dt = 1e-4
under ``GasDScheme`` (``--scheme mpm``, the default): the grad-h density
iteration, an iterated group re-binned every sweep, then the ideal-gas
EOS and ``MPMAccelerations``; ``PECIntegrator`` with ``GasDFluidStep``
and the ``Gaussian`` kernel.  Both pair sets run in ``gasd_pair``.
``--scheme adke`` (``ADKEScheme``, k = 0.3, eps = 0.5: the ADKE density
and accelerations on ``gasd_pair``'s ADKE sets, the plain summation
density on ``wcsph_pair``; PEC with ``ADKEStep``) and ``--scheme gsph``
(``GSPHScheme`` with the exact Riemann solver, I02 monotonicity, linear
interpolation and thermal conduction g1 = 0.25, g2 = 0.5: the density
groups on ``gasd_pair``, the gradients and the accelerations on
``gsph_pair``; Euler with ``GSPHStep``) are the reference's other two.
On an NVIDIA card:

    python -m pysph_tpu_torch.examples.gas_dynamics.shocktube \\
        --use-double --disable-output

(``--nl 320``, the default: 360 particles, 1,501 steps).  On the CPU:
``--device cpu --use-double``.  ``l1_errors`` compares a state with the
exact Riemann solution (``riemann_solver.py``); ``post_process`` does so
for the last dump.
"""

import numpy as np

from pysph_tpu_torch.base.utils import get_particle_array_gasd
from pysph_tpu_torch.examples.gas_dynamics import riemann_solver
from pysph_tpu_torch.solver.application import Application
from pysph_tpu_torch.sph.scheme import (
    ADKEScheme, GasDScheme, GSPHScheme, SchemeChooser)

#: the interior held to the exact solution: the rarefactions from the
#: free ends reach |x| = 0.32 by tf
WINDOW = 0.3


def l1_errors(x, rho, p, u, t, gamma=1.4, window=WINDOW):
    """The mean absolute errors of ``rho``, ``p`` and ``u`` against the
    exact Riemann solution of Sod's tube at ``t`` (sampled on 2,001
    points and interpolated at ``x``), over the particles with |x| <
    ``window``: a dict."""
    riemann_solver.set_gamma(gamma)
    rho_e, u_e, p_e, _, xs = riemann_solver.solve(
        x_min=-0.5, x_max=0.5, x_0=0.0, t=t, N=2001)
    sel = np.abs(x) < window
    return {name: float(np.mean(np.abs(got[sel] - np.interp(
        x[sel], xs, exact))))
        for name, got, exact in (('rho', rho, rho_e), ('p', p, p_e),
                                 ('u', u, u_e))}


class ShockTube(Application):
    def initialize(self):
        self.xmin = -0.5
        self.xmax = 0.5
        self.gamma = 1.4
        self.rhol, self.rhor = 1.0, 0.125
        self.pl, self.pr = 1.0, 0.1
        self.nl = 320

    def add_user_options(self, group):
        group.add_argument('--nl', action='store', type=int, dest='nl',
                           default=320,
                           help='Particles left of the diaphragm.')

    def consume_user_options(self):
        self.nl = self.options.nl

    def create_scheme(self):
        mpm = GasDScheme(
            fluids=['fluid'], solids=[], dim=1, gamma=self.gamma,
            kernel_factor=1.2, alpha1=1.0, alpha2=0.1, beta=2.0)
        adke = ADKEScheme(
            fluids=['fluid'], solids=[], dim=1, gamma=self.gamma,
            alpha=1.0, beta=1.0, k=0.3, eps=0.5, g1=0.2, g2=0.4)
        gsph = GSPHScheme(
            fluids=['fluid'], solids=[], dim=1, gamma=self.gamma,
            kernel_factor=1.0, g1=0.25, g2=0.5, rsolver=2,
            interpolation=1, monotonicity=1, interface_zero=True,
            hybrid=False, blend_alpha=2.0, niter=20, tol=1e-6)
        return SchemeChooser(default='mpm', mpm=mpm, adke=adke, gsph=gsph)

    def configure_scheme(self):
        self.scheme.configure_solver(dt=1e-4, tf=0.15)
        self.scheme.get_solver().set_print_freq(200)

    def create_particles(self):
        gamma1 = self.gamma - 1.0
        dxl = 0.5 / self.nl
        ratio = self.rhor / self.rhol
        nr = int(self.nl * ratio)
        dxr = 0.5 / nr
        xl = np.arange(self.xmin + 0.5 * dxl, 0.0, dxl)
        xr = np.arange(0.0 + 0.5 * dxr, self.xmax, dxr)
        x = np.concatenate([xl, xr])
        rho = np.where(x < 0, self.rhol, self.rhor)
        p = np.where(x < 0, self.pl, self.pr)
        m = np.where(x < 0, dxl * self.rhol, dxr * self.rhor)
        h = 1.2 * 2.0 * np.where(x < 0, dxl, dxr)
        e = p / (gamma1 * rho)
        cs = np.sqrt(self.gamma * p / rho)
        pa = get_particle_array_gasd(
            name='fluid', x=x, rho=rho, p=p, m=m, h=h, e=e, cs=cs,
            h0=h.copy())
        pa.add_property('htmp')
        pa.add_property('logrho')
        pa.add_property('wij')
        self.scheme.setup_properties([pa])
        if not self.options.quiet:
            print('Shock tube: %d particles' % pa.get_number_of_particles())
        return [pa]

    def post_process(self, info_fname_or_dir='.'):
        """The last dump's x, rho, p, u and their L1 errors against the
        exact solution (``l1_errors``)."""
        from pysph_tpu_torch.solver.output import load
        files = self.output_files
        if not files:
            return
        data = load(files[-1])
        fluid = data['arrays']['fluid']
        t = float(data['solver_data']['t'])
        out = {c: np.asarray(getattr(fluid, c)) for c in ('x', 'rho', 'p',
                                                          'u')}
        out['l1'] = l1_errors(out['x'], out['rho'], out['p'], out['u'], t,
                              self.gamma)
        return out


if __name__ == '__main__':
    app = ShockTube()
    app.run()
    app.post_process(app.info_filename)
