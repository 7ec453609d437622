"""``GasDScheme``'s pair calls, for the card: ``gasd_pair``'s on the shock
tube and the Sedov blast.

``RUNS``: ``examples/gas_dynamics/shocktube.py`` (1D, ``--nl``) and
``examples/gas_dynamics/sedov.py`` (2D, ``--nx``).

``app(run, size, dtype, steps=0, engine='kernel', device='cuda',
extra=())``: the run's application set up (with the further arguments
``extra``, e.g. ``FULL_WIDTH``).  ``calls(run, size, dtype, steps=0,
jitter_start=True, device='cuda', extra=())``: (calls, particles, app):
the two
``gasd_pair`` calls of one evaluation (one more sweep of the density
set, then the momentum set; ``time_walks.plan_calls``), on the run's
state after ``steps`` steps and one evaluation, whose start's positions
are first moved by up to a tenth of the spacing and its velocities
seeded (numpy ``default_rng``, ``jitter``) where ``jitter_start``: h
then varies from particle to particle.  ``check(calls, label, tol)``: each call's kernel
against its plain version (torch's deterministic algorithms on the
card): every output within ``tol`` of max|ref| (``dt_cfl``, the
``MAX``, among them), each dest's pairs in support (``nnbr``) and their
total exactly equal.  ``gradient_h(dim, dtype, device)``: the density
set's ``dwdh`` of a dest with one neighbour at a few distances against
``Gaussian.gradient_h`` (``base/kernels.py``).  ``kinds(dtype, tol,
device)``: ``check`` of both sets under each other kernel (``KINDS``:
``--kernel``, the Sedov lattice at nx=21 and, for the kernels with a 1D
shape, the shock tube at nl=40).  ``resources(lib, kind)``: the kernels'
registers and spills at one kind.  ``chip_smoke.py`` and
``tests/test_torch_gasd_cuda.py`` use them; on CPU tensors the kernel is
its plain version, which the CPU tests run through the same functions.
"""

import re

import numpy as np
import torch

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.kernels import Gaussian, kernel_kind
from pysph_tpu_torch.base.utils import get_particle_array_gasd
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.examples.gas_dynamics.sedov import SedovPointExplosion
from pysph_tpu_torch.examples.gas_dynamics.shocktube import ShockTube
from pysph_tpu_torch.sph.acceleration_eval import AccelerationEval
from pysph_tpu_torch.sph.equation import Group
from pysph_tpu_torch.sph.gas_dynamics.basic import SummationDensity
from pysph_tpu_torch.tools_dev.time_walks import plan_calls
from pysph_tpu_torch.tools_dev.tvf_check import reference

#: {run: (application class, size argument)}
RUNS = {'shocktube': (ShockTube, '--nl'),
        'sedov': (SedovPointExplosion, '--nx')}
#: the Sedov blast at full width (nx=401) steps with the CFL dt of
#: ``MPMAccelerations``' ``dt_cfl`` at a CFL number of 0.1: the example's
#: fixed dt of 1e-4 is some ten times the CFL limit there (the blast's
#: sound speed ~120 at h = 0.003), and at 0.3 (the default) the
#: conduction switch's rate, 0.01 h |del2e| / sqrt(e) with e = 1e-9
#: around the blast, drives alpha2 past 1e28 within 5 steps (float32 on
#: an H100); at 0.1 the run keeps finite for its 200 steps
FULL_WIDTH = ('--adaptive-timestep', '--cfl', '0.1')
#: the ``--kernel`` choices other than the Gaussian (the scheme's
#: default) by the run that takes them, and that run's size: in 1D only
#: the splines have a shape function in the pair kernels
KINDS = {'sedov': (('WendlandQuintic', 'CubicSpline', 'QuinticSpline',
                    'WendlandQuinticC4', 'WendlandQuinticC6',
                    'SuperGaussian'), 21),
         'shocktube': (('CubicSpline', 'QuinticSpline'), 40)}


def app(run, size, dtype, steps=0, engine='kernel', device='cuda',
        extra=()):
    """``run``'s application at ``size`` on ``device``."""
    cls, arg = RUNS[run]
    argv = ['--disable-output', '-q', '--device', device, '--engine',
            engine, arg, str(size), *extra]
    if dtype == torch.float64:
        argv.append('--use-double')
    if steps:
        argv += ['--max-steps', str(steps)]
    a = cls()
    a.setup(argv)
    return a


def jitter(s, seed=2468):
    """The fluid's positions moved by up to a tenth of its spacing
    (m / rho)^(1/dim) and seeded velocities of a tenth of its largest
    sound speed (``cs`` where set, else from p and rho)."""
    st = s.states['fluid']
    rng = np.random.default_rng(seed)
    n, dim = st['x'].shape[0], s.dim
    dx = (st['m'] / st['rho']) ** (1.0 / dim)
    cs = torch.sqrt(1.4 * st['p'].clamp(min=0.0) / st['rho'])
    scale = 0.1 * float(cs.max())

    def t(v):
        return torch.as_tensor(v, dtype=st['x'].dtype,
                               device=st['x'].device)

    for c in 'xyz'[:dim]:
        st[c] = st[c] + 0.1 * dx * t(rng.uniform(-1, 1, n))
    for c in 'uvw'[:dim]:
        st[c] = st[c] + t(scale * rng.normal(size=n))


def calls(run, size, dtype, steps=0, jitter_start=True, device='cuda',
          extra=()):
    """(calls, particles, app): the ``gasd_pair`` calls of one evaluation
    of ``run`` at ``size``, after ``steps`` steps and one evaluation of
    its (jittered) start."""
    a = app(run, size, dtype, steps=steps, device=device, extra=extra)
    s = a.solver
    if jitter_start:
        jitter(s)
    if steps:
        s.solve()
    s.integrator.initial_acceleration(s.states, s.t, s.dt)
    n = sum(st['x'].shape[0] for st in s.states.values())
    return plan_calls(s, [0]), n, a


def check(calls_, label, tol):
    """Each call's kernel against its plain version: raises where an
    output passes ``tol`` of max|ref| or a dest's pair count differs.
    Returns the largest absolute and scaled errors, the pairs in support
    of all the calls and the dests whose count differs (0)."""
    worst_abs = worst = 0.0
    pairs = 0
    failures = []
    for _, dest, plan, args in calls_:
        got = plan.op(*args, counts=True)
        ref = reference(plan, args + (True,))
        if args[0]['x'].is_cuda:
            torch.cuda.synchronize()
        for p in plan.outputs:
            scale = max(float(ref[p].abs().max()), 1e-300)
            err = float((got[p].double() - ref[p].double()).abs().max())
            if not err <= tol * scale:
                failures.append('%s %s.%s: error %.3g > %.0e * %.3g' % (
                    label, dest, p, err, tol, scale))
            worst_abs = max(worst_abs, err)
            worst = max(worst, err / scale)
        differ = int((got['nnbr'] != ref['nnbr']).sum())
        if differ:
            failures.append('%s %s: %d dests count other pairs than the '
                            'plain version' % (label, dest, differ))
        pairs += int(ref['nnbr'].sum())
    if failures:
        raise AssertionError('; '.join(failures))
    return dict(max_abs_err=worst_abs, max_scaled_err=worst, pairs=pairs,
                nnbr_differ=0)


#: the distances, in units of the dest's h, of ``gradient_h``'s neighbour
DISTANCES = (0.0, 0.3, 0.9, 1.7, 2.6, 2.95)


def gradient_h(dim, dtype, device='cuda'):
    """The density set's ``dwdh`` of a dest (h = 0.1, m = 1) with one
    neighbour (m = 1, h = 0.05, so that the support is the dest's) at
    each of ``DISTANCES`` x h along x, against ``Gaussian(dim).
    gradient_h`` at 0 and at that distance: the largest error scaled by
    the reference."""
    h = 0.1
    kernel = Gaussian(dim=dim)
    config = Config(device=device, dtype=dtype)
    worst = 0.0
    for q in DISTANCES:
        pa = get_particle_array_gasd(
            name='fluid', x=np.array([0.0, q * h]), m=1.0, rho=1.0,
            h=np.array([h, 0.5 * h]))
        grid = CellGrid.from_particles([pa], dim=dim,
                                       radius_scale=kernel.radius_scale)
        a_eval = AccelerationEval(
            [pa], [Group([SummationDensity('fluid', ['fluid'], dim=dim)])],
            kernel, config, grid)
        (plan,) = [p for p in a_eval._plans.values() if p is not None]
        states = {'fluid': pa.to_device(config)}
        cells = grid.bin_all(states)
        st = states['fluid']
        pre = {p: torch.zeros_like(st[p]) for p in plan.outputs}
        got = plan.op(*plan.args(st, states, cells, grid, None, pre))
        r = torch.tensor([0.0, q * h], dtype=torch.float64)
        want = float(kernel.gradient_h(None, r, torch.tensor(h,
                                       dtype=torch.float64)).sum())
        err = abs(float(got['dwdh'][0]) - want) / abs(want)
        worst = max(worst, err)
    return worst


def kinds(dtype, tol, device='cuda'):
    """{label: ``check``'s result and the kind} of both sets of one
    evaluation under each kernel of ``KINDS`` on its run (jittered)."""
    found = {}
    for run, (names, size) in KINDS.items():
        for name in names:
            c, _, _ = calls(run, size, dtype, device=device,
                            extra=('--kernel', name))
            label = '%s %s %d %s' % (name, run, size, str(dtype)[6:])
            found[label] = dict(check(c, label, tol),
                                kind=kernel_kind(c[0][3][6]))
    return found


_KERNEL = re.compile(r'gasd_pair_kernelI([fd])Li(\d)ELb([01])EN\w*?'
                     r'(Density|Momentum)')


def resources(lib, kind=2):
    """{'<dtype> <set> <open|periodic>': (registers, spill store bytes,
    spill load bytes)} of the kernels of shape ``kind`` in the built
    ``gasd_pair`` library ``lib`` (``build.resources``)."""
    from pysph_tpu_torch.ops import build
    out = {}
    for name, res in build.resources(lib).items():
        m = _KERNEL.search(name)
        if m and int(m.group(2)) == kind:
            out['%s %s %s' % ('float32' if m.group(1) == 'f' else 'float64',
                              m.group(4).lower(),
                              'periodic' if m.group(3) == '1' else 'open')
                ] = res
    return dict(sorted(out.items()))
