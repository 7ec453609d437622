"""The gas examples' new runs against the JAX apps, float64 on the CPU:
``accuracy_test_2d`` and ``hydrostatic_box`` under ``--scheme gsph``,
``mpm`` and ``adke`` (boxes periodic in x and y), and ``shocktube``
under ``--scheme gsph`` and ``adke`` (1D, free ends): the initial
evaluation of the example's start (its positions moved by up to a tenth
of its spacing, its velocities seeded) at 1e-10 of ``max|ref|``, and
three steps of the solver's per-step loop at 1e-9, every pair phase on
the kernel engine (on the CPU the kernels' plain versions).

The JAX apps of the periodic runs size their grid with the cells of
``tests/jax_gasd_figures.py``'s ``ROOMY``: GSPH's first evaluation
doubles h and ADKE's k = 1.5 scales it, past the periodic cells that the
JAX package sizes at setup, where it misses pairs (ROADMAP Queue 3),
while the port re-sizes its grid for them (``run_sized``,
``CellGrid.cells_small``); ``test_gsph_first_evaluation_sees_every_pair``
holds that re-sizing to an all-pairs sum where the JAX package's own
cells would miss pairs.
"""

import importlib
import shutil
import tempfile

import numpy as np
import pytest
import torch

import jax_gasd_figures
from pysph_tpu.base.cell_grid import GridSpec
from pysph_tpu_torch.base.kernels import Gaussian
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = 1e-10
STEP_TOL = 1e-9
#: {run: (module, class, arguments, periodic)}
RUNS = {
    'accuracy gsph': ('accuracy_test_2d', 'AccuracyTest2D',
                      ['--nparticles', '20', '--scheme', 'gsph'], True),
    'accuracy mpm': ('accuracy_test_2d', 'AccuracyTest2D',
                     ['--nparticles', '20', '--scheme', 'mpm'], True),
    'accuracy adke': ('accuracy_test_2d', 'AccuracyTest2D',
                      ['--nparticles', '20', '--scheme', 'adke'], True),
    'hydrostatic gsph': ('hydrostatic_box', 'HydrostaticBox',
                         ['--nx', '16', '--scheme', 'gsph'], True),
    'hydrostatic mpm': ('hydrostatic_box', 'HydrostaticBox',
                        ['--nx', '16', '--scheme', 'mpm'], True),
    'hydrostatic adke': ('hydrostatic_box', 'HydrostaticBox',
                         ['--nx', '16', '--scheme', 'adke'], True),
    'shocktube gsph': ('shocktube', 'ShockTube',
                       ['--nl', '40', '--scheme', 'gsph'], False),
    'shocktube adke': ('shocktube', 'ShockTube',
                       ['--nl', '40', '--scheme', 'adke'], False),
}
#: what the evaluations and the steps write
OUT = ('rho', 'h', 'p', 'cs', 'au', 'av', 'ae', 'div', 'arho', 'logrho',
       'px', 'py', 'ux', 'uy', 'vx', 'vy', 'grhox', 'grhoy', 'omega',
       'dwdh', 'converged')
STEP_PROPS = ('x', 'y', 'u', 'v', 'rho', 'p', 'e', 'h')
_FROM_PARTICLES = GridSpec.from_particles.__func__


def _roomy(cls, *args, **kw):
    for k, v in jax_gasd_figures.ROOMY.items():
        kw.setdefault(k, v)
    return _FROM_PARTICLES(cls, *args, **kw)


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


def _cls(package, run):
    mod, name = RUNS[run][:2]
    return getattr(importlib.import_module(
        '%s.examples.gas_dynamics.%s' % (package, mod)), name)


def _argv(run):
    return ['--disable-output', '-q', '--max-steps', '3'] + RUNS[run][2]


def _seed(particles):
    """Seeded velocities and positions moved by up to a tenth of the
    spacing (m / rho)^(1 / dim): on an exact lattice with one h the pairs
    at q = 3, where the Gaussian is not 0, fall in or out of support by
    r2's last bit."""
    props = particles[0].properties
    n = particles[0].get_number_of_particles()
    rng = np.random.default_rng(9)
    for c in ('u', 'v'):
        props[c][:n] += 0.1 * rng.normal(size=n)
    dim = 1 if np.ptp(props['y'][:n]) == 0.0 else 2
    dx = (props['m'][:n] / props['rho'][:n]) ** (1.0 / dim)
    for c in 'xy'[:dim]:
        props[c][:n] += 0.1 * dx * rng.uniform(-1, 1, n)


_RUNS = {}


def _jax_run(run, monkeypatch):
    """The JAX app's initial evaluation and three steps of its start:
    (evaluation outputs, step outputs, t, inputs)."""
    if run in _RUNS:
        return _RUNS[run]
    if RUNS[run][3]:
        monkeypatch.setattr(GridSpec, 'from_particles', classmethod(_roomy))
    tmp = tempfile.mkdtemp()
    try:
        app = _cls('pysph_tpu', run)()
        app.setup(['-d', tmp] + _argv(run))
        _seed(app.particles)
        inputs = {pa.name: ({k: v.copy() for k, v in pa.properties.items()},
                            {k: v.copy() for k, v in pa.constants.items()},
                            dict(pa.stride)) for pa in app.particles}
        s = app.solver
        s.chunk_steps = 1
        s._sync_to_device()
        states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
        if s._check_overflow(diag):
            s._handle_overflow(diag)
            states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
        states = s._mat_fn(states, carry)
        n = app.particles[0].get_number_of_particles()
        evals = {p: np.asarray(states['fluid'][p])[:n].copy() for p in OUT
                 if p in states['fluid']}
        app.solve()
        pa = app.particles[0]
        steps = {p: np.asarray(pa.properties[p])[:n].copy()
                 for p in STEP_PROPS if p in pa.properties}
        assert s.count == 3
        _RUNS[run] = (evals, steps, s.t, inputs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        monkeypatch.undo()
    return _RUNS[run]


@pytest.fixture(scope='module')
def jax_runs():
    with pytest.MonkeyPatch.context() as mp:
        for run in RUNS:
            _jax_run(run, mp)
    return _RUNS


def _port_start(run):
    """The port's app on the JAX app's start, in the per-step loop."""
    inputs = _RUNS[run][3]
    app = _cls('pysph_tpu_torch', run)()
    app.setup(['--use-double', '--device', 'cpu'] + _argv(run))
    s = app.solver
    s.chunk_steps = 1
    s.particles = app.particles = [ParticleArray.from_numpy(name, *args)
                                   for name, args in inputs.items()]
    s._sync_to_device()
    assert set(s.acceleration_evals[0].engine_choices.values()) == {
        'kernel'}
    return app


def _check(got, want, tol, label):
    checked = 0
    for p, w in want.items():
        g = got(p)
        if np.abs(w).max() == 0.0:
            assert np.abs(g).max() == 0.0, (label, p)
            continue
        err = _scaled_err(g, w)
        assert err <= tol, '%s %s: %.3g' % (label, p, err)
        checked += 1
    return checked


@pytest.mark.parametrize('run', list(RUNS))
def test_one_eval_matches_jax(run, jax_runs):
    evals = jax_runs[run][0]
    app = _port_start(run)
    s = app.solver
    s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    st = s.states['fluid']
    assert _check(lambda p: st[p].numpy(), evals, TOL, run) >= 6


@pytest.mark.parametrize('run', list(RUNS))
def test_three_steps_match_jax(run, jax_runs):
    _, steps, t, _ = jax_runs[run]
    app = _port_start(run)
    s = app.solver
    app.solve()
    assert s.count == 3 and abs(s.t - t) <= STEP_TOL * t
    pa = app.particles[0]
    assert _check(lambda p: np.asarray(pa.properties[p]), steps, STEP_TOL,
                  run) >= 5


def test_gsph_first_evaluation_sees_every_pair():
    """``accuracy_test_2d --scheme gsph`` at 40^2, jittered: its first
    evaluation doubles h (``ScaleSmoothingLength``) past the periodic
    cells sized for the start's h; the port's grid is re-sized for it and
    the evaluation run again, so that the density at the doubled h is the
    all-pairs sum (the plain density of the scaled h, read through h from
    the volume and the second density)."""
    from pysph_tpu_torch.examples.gas_dynamics.accuracy_test_2d import (
        AccuracyTest2D)
    app = AccuracyTest2D()
    app.setup(['--use-double', '--device', 'cpu', '--disable-output', '-q',
               '--nparticles', '40'])
    s = app.solver
    # off the lattice, whose ties at q = 3 fall by r2's last bit
    rng = np.random.default_rng(3)
    fluid = s.states['fluid']
    for c in 'xy':
        fluid[c] = fluid[c] + 0.1 / 40 * torch.as_tensor(
            rng.uniform(-1, 1, fluid[c].shape[0]))
    st0 = {p: v.numpy().copy() for p, v in fluid.items()
           if v.is_floating_point()}
    dims0 = s.grid.dims
    s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    # the binning of the scaled h (after ScaleSmoothingLength's group) was
    # re-sized to fewer, wider cells, once
    a_eval = s.acceleration_evals[0]
    scaled = a_eval.binning(a_eval.groups[0]).handle
    assert scaled.dims[0] < dims0[0] and s.grid.grows == 1
    # the all-pairs sums of the scheme's two densities
    x, y, m = st0['x'], st0['y'], st0['m']
    d = np.stack([x[:, None] - x[None], y[:, None] - y[None]])
    d -= np.rint(d)
    r = np.sqrt((d ** 2).sum(0))
    fac = Gaussian(dim=2).fac

    def density(h):
        q = r / h[:, None]
        w = np.where(q < 3, np.exp(-q * q), 0.0) * fac / h[:, None] ** 2
        sup = r < 3.0 * np.maximum(h[:, None], h[None])
        return (np.where(sup, w, 0.0) * m[None]).sum(1)

    h = 2.0 * st0['h']
    h = 1.0 * np.sqrt(m / density(h))
    rho = density(h)
    got = s.states['fluid']
    assert _scaled_err(got['h'].numpy(), h) <= 1e-12
    assert _scaled_err(got['rho'].numpy(), rho) <= 1e-12


class _ScaleLater(object):
    """``ScaleSmoothingLength``'s loop with a factor of 1 before ``T0``
    steps and 4 after: h grows past the periodic cells sized at the
    start in the middle of a run."""
    T0 = 1.5

    def loop(self, d_idx, d_h, t):
        later = torch.as_tensor(t) >= self.T0 * self.dt
        d_h[d_idx] = d_h[d_idx] * torch.where(later, 4.0, 1.0)


def _scaled_later(chunk_steps, all_pairs):
    """``accuracy_test_2d --scheme gsph`` at 32^2, jittered, float64, 4
    steps, with ``_ScaleLater`` in place of its ``ScaleSmoothingLength``;
    ``all_pairs``: on one periodic cell a side (every particle a
    candidate of every dest)."""
    from pysph_tpu_torch.examples.gas_dynamics.accuracy_test_2d import (
        AccuracyTest2D)
    from pysph_tpu_torch.sph.gas_dynamics.basic import ScaleSmoothingLength
    app = AccuracyTest2D()
    app.setup(['--use-double', '--device', 'cpu', '--disable-output', '-q',
               '--nparticles', '32', '--max-steps', '4'])
    s = app.solver
    s.chunk_steps = chunk_steps
    scaled = 0
    for a in s.acceleration_evals:
        for eq in a._iter_equations():
            if isinstance(eq, ScaleSmoothingLength):
                eq.loop = _ScaleLater.loop.__get__(eq)
                eq.T0, eq.dt = _ScaleLater.T0, s.dt
                scaled += 1
    assert scaled and s.grid.h_varies
    rng = np.random.default_rng(4)
    fluid = s.states['fluid']
    for c in 'xy':
        fluid[c] = fluid[c] + 0.1 / 32 * torch.as_tensor(
            rng.uniform(-1, 1, fluid[c].shape[0]))
    if all_pairs:
        # every binning keeps the grid's one cell a side: none is sized
        # down for its h
        s.grid._set_dims((1, 1, 1))
        s.grid.oversized = lambda width: False
    app.solve()
    assert s.count == 4
    return s


@pytest.mark.parametrize('chunk_steps', [1, 4])
def test_h_outgrowing_the_cells_mid_run_is_redone(chunk_steps):
    """h grows past the periodic cells in the third step: the solver puts
    the state back, re-sizes the grid and runs the step (the chunk) again,
    so that the run equals one on a grid of one cell a side, where every
    particle is a candidate (the all-pairs sums)."""
    got = _scaled_later(chunk_steps, all_pairs=False)
    want = _scaled_later(chunk_steps, all_pairs=True)
    assert got.redos == 1 and got.grid.grows == 1
    assert want.redos == 0 and want.grid.grows == 0
    for p in ('x', 'y', 'u', 'v', 'e', 'rho', 'h', 'au', 'ae'):
        err = _scaled_err(got.states['fluid'][p].numpy(),
                          want.states['fluid'][p].numpy())
        assert err <= 1e-12, (p, err)


def test_the_width_is_watched_only_where_an_equation_writes_h():
    """The binnings keep their widest binning (``h_varies``) under the gas
    schemes, whose equations write h, and not under the Taylor-Green
    vortex's, whose h stays as it was."""
    from pysph_tpu_torch.examples.gas_dynamics.accuracy_test_2d import (
        AccuracyTest2D)
    from pysph_tpu_torch.examples.taylor_green import TaylorGreen
    for cls, argv in ((TaylorGreen, ['--nx', '10']),
                      (AccuracyTest2D, ['--nparticles', '10', '--scheme',
                                        'adke'])):
        app = cls()
        app.setup(['--use-double', '--device', 'cpu', '--disable-output',
                   '-q', '--max-steps', '1'] + argv)
        grid = app.solver.grid
        assert grid.is_periodic
        assert grid.h_varies == (cls is AccuracyTest2D)
        app.solve()
        widths = [b.widest for a in app.solver.acceleration_evals
                  for b in a.kept_binnings()]
        assert all((w is None) != (cls is AccuracyTest2D) for w in widths)
