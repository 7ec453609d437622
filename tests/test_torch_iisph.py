"""The port's IISPH (``sph/iisph.py``) and the evaluator's group tree
against pysph_tpu's, float64 on the CPU, inputs seeded with numpy.

- The group tree: an iterated group of two sub-groups (a per-particle
  sweep counter, then a pair sum with ``reduce`` and ``converged``)
  through the port's and the JAX ``SPHEvaluator``, with
  ``min_iterations`` binding, ``max_iterations`` binding and neither:
  the same sweeps, sums and reduced constant; ``converged`` read once a
  sweep that can stop the loop; the features not ported refused naming
  ROADMAP item 21.
- Each IISPH equation, in the scheme's phase sets, against the JAX
  ``SPHEvaluator`` at 1e-10 of ``max|ref|`` on a fluid inside three
  layers of wall (an open box, and a channel periodic in x), on the
  kernel engine (on the CPU ``iisph_pair``'s plain version) and the
  torch engine; ``IISPHStep`` stage by stage (1e-14).
- The reference's three IISPH runs, ``taylor_green --nx 16``,
  ``elliptical_drop --nx 20`` and ``dam_break_2d --dx 0.1`` with
  ``--scheme iisph``, from the example's particles with the fluid's
  positions jittered by a tenth of dx and its velocities seeded: one
  evaluation against the JAX app's on both engines at 1e-10, three steps
  on the kernel engine at 1e-9, with the pressure sweeps of every
  evaluation equal to the JAX app's (counted by host callbacks in its
  traced ``reduce``).
- ``test_iisph_pressure_solve_1e6``: three Euler steps against
  ``NumpyIISPH`` (``tests/test_reference_parity.py``) at 1e-6 relative
  L2, with the oracle's sweep counts, more than 2.
- The plans: every dest of the three runs on ``iisph_pair`` with the
  sets the scheme gives it, linked as designed, and the pressure group
  on ``iisph_solve`` (its plain version on the CPU), held to the JAX
  app's evaluation; the graphed chunk refused only for an iterated group
  that sweeps on the host (``tests/test_torch_iisph_solve.py`` holds
  the solve to the host loop).

``tests/test_torch_iisph_cuda.py`` holds the kernel to its plain
version on the card.
"""

import importlib
import inspect
import logging
import re
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysph_tpu.base.domain import DomainManager as JaxDomain
from pysph_tpu.base.kernels import CubicSpline as JaxCubicSpline
from pysph_tpu.base.kernels import QuinticSpline as JaxQuintic
from pysph_tpu.base.utils import get_particle_array as jax_array
from pysph_tpu.sph import iisph as jax_iisph
from pysph_tpu.sph.acceleration_eval import (
    ArraySchema, _bind_particle_phase as jax_bind)
from pysph_tpu.sph.equation import Equation as JaxEquation
from pysph_tpu.sph.equation import Group as JaxGroup
from pysph_tpu.tools.sph_evaluator import SPHEvaluator as JaxEvaluator
from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.kernels import CubicSpline, QuinticSpline
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.base.utils import (
    get_particle_array, get_particle_array_iisph)
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.ops import build, cell_pack, pair_link
from pysph_tpu_torch.ops import iisph_pair as ip
from pysph_tpu_torch.sph import iisph
from pysph_tpu_torch.sph.acceleration_eval import (
    AccelerationEval, _bind_particle_phase)
from pysph_tpu_torch.sph.equation import Equation, Group, _method_args
from pysph_tpu_torch.sph.integrator import EulerIntegrator
from pysph_tpu_torch.tools.sph_evaluator import SPHEvaluator
from pysph_tpu_torch.tools_dev import iisph_check
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401
from test_reference_parity import NumpyIISPH

TOL = 1e-10
STEP_TOL = 1e-9
CPU = dict(device='cpu', dtype=torch.float64)
ENGINES = ['kernel', 'torch']


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


# -- the group tree ------------------------------------------------------
def _tree(Eq, Grp, lib, k, min_it, max_it):
    """An iterated group of two sub-groups: a per-particle sweep counter
    ``a``, then ``b = sum_j a_j W_ij`` whose ``reduce`` keeps max a in
    the constant ``tmp`` and whose ``converged`` holds once it reaches
    ``k``; ``lib``: ``jnp`` or ``torch``."""
    class Sweep(Eq):
        def initialize(self, d_idx, d_a):
            d_a[d_idx] += 1.0

    class Count(Eq):
        def initialize(self, d_idx, d_b):
            d_b[d_idx] = 0.0

        def loop(self, d_idx, d_b, s_idx, s_a, WIJ):
            d_b[d_idx] += s_a[s_idx] * WIJ

        def reduce(self, dst, t, dt):
            dst.tmp[0] = lib.max(dst.a[:])

        def converged(self, dst):
            return lib.where(dst.tmp[0] >= k, 1.0, -1.0)

    return [Grp(equations=[Grp(equations=[Sweep('fluid', None)]),
                           Grp(equations=[Count('fluid', ['fluid'])])],
                iterate=True, min_iterations=min_it,
                max_iterations=max_it)]


def _lattice(make, n=8, seed=3):
    rng = np.random.default_rng(seed)
    g = (np.arange(n) + 0.5) / n
    x, y = (c.ravel() for c in np.meshgrid(g, g))
    return make(name='fluid', additional_props=['a', 'b'],
                constants={'tmp': [0.0]},
                x=x + 0.05 / n * rng.normal(size=x.size), y=y,
                h=1.2 / n, m=1.0 / n ** 2, rho=1.0)


#: (k, min_iterations, max_iterations, sweeps, converged reads)
TREE_CASES = [(1.0, 2, 30, 2, 1), (10.0, 2, 5, 5, 3), (4.0, 2, 30, 4, 3),
              (0.0, 0, 3, 1, 1)]


@pytest.mark.parametrize('k,min_it,max_it,sweeps,reads', TREE_CASES)
def test_iterated_group_of_subgroups_matches_jax(k, min_it, max_it, sweeps,
                                                 reads):
    jarr = _lattice(jax_array)
    JaxEvaluator([jarr], _tree(JaxEquation, JaxGroup, jnp, k, min_it,
                               max_it), dim=2,
                 kernel=JaxCubicSpline(dim=2)).evaluate(0.0, 0.1)
    arr = _lattice(get_particle_array)
    ev = SPHEvaluator([arr], _tree(Equation, Group, torch, k, min_it,
                                   max_it), dim=2,
                      kernel=CubicSpline(dim=2), config=Config(**CPU))
    assert ev.func_eval.has_iterated
    ev.evaluate(0.0, 0.1)
    a_eval = ev.func_eval
    # the torch engine runs the sum: the evaluation runs again until its
    # list's capacity holds (run_sized), each time from the same start
    assert set(a_eval.sweeps) == {sweeps}
    assert a_eval.converged_reads == reads * len(a_eval.sweeps)
    np.testing.assert_array_equal(arr.a, np.full(arr.a.size, sweeps))
    np.testing.assert_array_equal(np.asarray(jarr.a), arr.a)
    assert _scaled_err(arr.b, np.asarray(jarr.b)) <= TOL
    np.testing.assert_array_equal(arr.tmp, np.asarray(jarr.tmp))


class _LoopAll(Equation):
    def loop_all(self, d_idx, d_a):
        pass


class _InitPair(Equation):
    def initialize_pair(self, d_idx, d_a):
        pass


class _PyInit(Equation):
    def py_initialize(self, dst, t, dt):
        pass


@pytest.mark.parametrize('feature', ['condition', 'update_nnps', 'pre',
                                     'post', 'start_idx', 'stop_idx'])
def test_group_features_not_ported_are_refused(feature):
    if feature == 'update_nnps':
        # ported with the gas-dynamics schemes: taken on a plain and an
        # iterated group (tests/test_torch_gas_dynamics.py holds the
        # re-binning to the JAX package's)
        assert Group([], update_nnps=1).update_nnps
        assert Group([], update_nnps=True, iterate=True).update_nnps
        return
    with pytest.raises(NotImplementedError, match='item 21'):
        Group([], **{feature: 1})


@pytest.mark.parametrize('cls', [_LoopAll, _InitPair, _PyInit])
def test_equation_methods_not_ported_are_refused(cls):
    arr = _lattice(get_particle_array)
    with pytest.raises(NotImplementedError, match='item 21'):
        SPHEvaluator([arr], [Group([cls('fluid', ['fluid'])])], dim=2,
                     config=Config(**CPU))
    # a group of equations and sub-groups together
    with pytest.raises(NotImplementedError, match='item 21'):
        Group([Group([cls('fluid', None)]), cls('fluid', None)])


# -- the equations ---------------------------------------------------------
RHO0, NU, GX, GY = 1000.0, 0.05, 0.3, -9.81
#: the props of the arrays: IISPH's (``get_particle_array_iisph``) and
#: NormalizedSummationDensity's rho0
PROPS = ('uadv', 'vadv', 'wadv', 'rho_adv', 'ax', 'ay', 'az', 'dii0',
         'dii1', 'dii2', 'V', 'dt_cfl', 'dt_force', 'aii', 'dijpj0',
         'dijpj1', 'dijpj2', 'p0', 'piter', 'compression', 'rho0')
#: the fluid and wall props a case writes
OUT = {'fluid': ('rho', 'V', 'au', 'av', 'uadv', 'vadv', 'dii0', 'dii1',
                 'rho_adv', 'aii', 'p0', 'piter', 'dijpj0', 'dijpj1', 'p',
                 'compression', 'tmp_comp', 'dt_cfl', 'dt_force'),
       'solid': ('V',)}


def _walls(make, geometry, seed=23):
    """Fluid inside three layers of wall, as ``tests/test_torch_edac.py``'s:
    ``channel`` periodic in x on [0, 1], ``box`` closed (an open grid);
    positions jittered by 5% of dx; seeded velocities, advected
    velocities, densities, pressures and the pressure solve's inputs."""
    rng = np.random.default_rng(seed)
    dx = 0.1
    if geometry == 'channel':
        xs = np.arange(dx / 2, 1.0, dx)
        xf, yf = np.meshgrid(xs, np.arange(dx / 2, 0.6, dx))
        xw, yw = np.meshgrid(xs, np.concatenate([
            -np.arange(dx / 2, 0.3, dx), 0.6 + np.arange(dx / 2, 0.3, dx)]))
    else:
        g = np.arange(-0.3 + dx / 2, 0.9, dx)
        x, y = np.meshgrid(g, g)
        inside = (x > 0) & (x < 0.6) & (y > 0) & (y < 0.6)
        xf, yf, xw, yw = x[inside], y[inside], x[~inside], y[~inside]
    xf, yf, xw, yw = (a.ravel() for a in (xf, yf, xw, yw))
    nf, nw = xf.size, xw.size
    seeded = {p: rng.normal(0.0, 0.5, nf) for p in (
        'u', 'v', 'uadv', 'vadv', 'dii0', 'dii1', 'dijpj0', 'dijpj1')}
    fluid = make(
        name='fluid', additional_props=list(PROPS),
        constants={'tmp_comp': [0.0, 0.0]},
        x=xf + 0.05 * dx * rng.normal(size=nf),
        y=yf + 0.05 * dx * rng.normal(size=nf), h=1.2 * dx,
        m=RHO0 * dx * dx * (1.0 + 0.05 * rng.normal(size=nf)),
        rho=RHO0 * (1.0 + 0.01 * rng.normal(size=nf)),
        rho0=RHO0 * (1.0 + 0.01 * rng.normal(size=nf)),
        p=1e3 * np.abs(rng.normal(size=nf)),
        piter=1e3 * np.abs(rng.normal(size=nf)),
        rho_adv=RHO0 * (1.0 + 0.01 * rng.normal(size=nf)),
        aii=-1e-3 * (1.0 + np.abs(rng.normal(size=nf))), **seeded)
    solid = make(
        name='solid', additional_props=list(PROPS),
        constants={'tmp_comp': [0.0, 0.0]}, x=xw, y=yw, h=1.2 * dx,
        m=RHO0 * dx * dx, rho=RHO0,
        u=np.where(yw > 0.6, 1.0, 0.0), v=0.1 * rng.normal(size=nw),
        V=(1.0 + 0.02 * rng.normal(size=nw)) / (dx * dx))
    return [fluid, solid]


def _sets(mod, group, case):
    """The groups of an equation case, from ``mod`` (the JAX or the
    port's ``iisph``) and ``group`` (their Group)."""
    f, s = ['fluid'], ['solid']
    sets = {
        'density and advection': [
            group(equations=[mod.NumberDensity('solid', s)]),
            group(equations=[mod.SummationDensity('fluid', f)], real=False),
            group(equations=[mod.SummationDensityBoundary(
                'fluid', s, rho0=RHO0)], real=False),
            group(equations=[
                mod.AdvectionAcceleration('fluid', None, gx=GX, gy=GY),
                mod.ComputeDII('fluid', f),
                mod.ViscosityAcceleration('fluid', f, nu=NU),
                mod.ViscosityAccelerationBoundary('fluid', s, rho0=RHO0,
                                                  nu=NU),
                mod.ComputeDIIBoundary('fluid', s, rho0=RHO0)],
                real=False)],
        'advected density and solve': [
            group(equations=[
                mod.ComputeRhoAdvection('fluid', f),
                mod.ComputeAII('fluid', f),
                mod.ComputeRhoBoundary('fluid', s, rho0=RHO0),
                mod.ComputeAIIBoundary('fluid', s, rho0=RHO0)]),
            group(equations=[mod.ComputeDIJPJ('fluid', f)]),
            group(equations=[
                mod.PressureSolve('fluid', f, rho0=RHO0),
                mod.PressureSolveBoundary('fluid', s, rho0=RHO0)])],
        'force': [group(equations=[
            mod.PressureForce('fluid', f),
            mod.PressureForceBoundary('fluid', s, rho0=RHO0)])],
        'normalized density': [group(equations=[
            mod.NormalizedSummationDensity('fluid', f)])],
    }
    return sets[case]


#: {case: (geometries, the kernel that takes it on the kernel engine)}
CASES = {'density and advection': (('box', 'channel'), ip.iisph_pair),
         'advected density and solve': (('box', 'channel'), ip.iisph_pair),
         'force': (('box', 'channel'), ip.iisph_pair),
         'normalized density': (('box',), None)}
EQ_CASES = [(c, g) for c, (gs, _) in CASES.items() for g in gs]
DT = 2e-3


def _domain(cls, geometry):
    return cls(xmin=0.0, xmax=1.0, periodic_in_x=True) \
        if geometry == 'channel' else None


_JAX = {}


def _jax_case(case, geometry):
    key = (case, geometry)
    if key not in _JAX:
        arrays = _walls(jax_array, geometry)
        ev = JaxEvaluator(arrays, _sets(jax_iisph, JaxGroup, case), dim=2,
                          kernel=JaxQuintic(dim=2),
                          domain_manager=_domain(JaxDomain, geometry))
        ev.evaluate(t=0.1, dt=DT)
        _JAX[key] = {pa.name: {p: np.asarray(getattr(pa, p))
                               for p in OUT[pa.name]} for pa in arrays}
    return _JAX[key]


@pytest.mark.parametrize('engine', ENGINES)
@pytest.mark.parametrize('case,geometry', EQ_CASES)
def test_iisph_equations_match_jax(case, geometry, engine):
    want = _jax_case(case, geometry)
    arrays = _walls(get_particle_array, geometry)
    ev = SPHEvaluator(arrays, _sets(iisph, Group, case), dim=2,
                      kernel=QuinticSpline(dim=2),
                      domain_manager=_domain(DomainManager, geometry),
                      config=Config(engine=engine, **CPU))
    ev.evaluate(t=0.1, dt=DT)
    planned = {p.op for p in ev.func_eval._plans.values() if p is not None}
    op = CASES[case][1]
    assert planned == ({op} if engine == 'kernel' and op else set())
    checked = 0
    for pa in arrays:
        for p, w in want[pa.name].items():
            got = np.asarray(getattr(pa, p))
            if np.abs(w).max() == 0.0:
                assert np.abs(got).max() == 0.0, (pa.name, p)
                continue
            err = _scaled_err(got, w)
            assert err <= TOL, '%s %s.%s: %.3g' % (case, pa.name, p, err)
            checked += 1
    assert checked >= 3


@pytest.mark.parametrize('stage', ['stage1'])
def test_step_stage_matches_jax(stage):
    jax_fn = getattr(jax_iisph.IISPHStep(), stage)
    fn = getattr(iisph.IISPHStep(), stage)
    props = sorted(a[2:] for a in _method_args(jax_fn) if a.startswith('d_'))
    assert props == sorted(a[2:] for a in _method_args(fn)
                           if a.startswith('d_'))
    rng = np.random.default_rng(5)
    values = {p: rng.normal(size=17) for p in props}
    mask = rng.random(17) < 0.8
    jstore = {p: jnp.asarray(v) for p, v in values.items()}
    schema = ArraySchema(name='fluid', props=tuple(props), strides={},
                         consts=())
    jax_bind(jax_fn, jstore, schema, jnp.asarray(mask), 0.2, 0.013,
             JaxCubicSpline(dim=2))
    store = {p: torch.as_tensor(v) for p, v in values.items()}
    _bind_particle_phase(fn, store, torch.as_tensor(mask), 0.2, 0.013, (),
                         CubicSpline(dim=2))
    changed = 0
    for p in props:
        want, got = np.asarray(jstore[p]), store[p].numpy()
        assert _scaled_err(got, want) <= 1e-14, (stage, p)
        assert np.array_equal(got[~mask], values[p][~mask]), p
        changed += not np.array_equal(want, values[p])
    assert changed == 6


def test_every_iisph_class_is_ported():
    """The port's module has every class and function of the JAX
    module, each with the same methods; the particle array the same
    props, constants and output arrays."""
    def public(mod):
        return {n: v for n, v in vars(mod).items()
                if (inspect.isclass(v) or inspect.isfunction(v)) and
                v.__module__ == mod.__name__ and not n.startswith('_')}
    mine, theirs = public(iisph), public(jax_iisph)
    assert set(theirs) <= set(mine)
    for name, cls in theirs.items():
        own = {m for m in vars(cls) if not m.startswith('_')}
        assert own == {m for m in vars(mine[name])
                       if not m.startswith('_')}, name
    from pysph_tpu.base.utils import get_particle_array_iisph as jax_pa
    a, b = get_particle_array_iisph(), jax_pa()
    assert set(a.properties) == set(b.properties)
    assert {k: list(v) for k, v in a.constants.items()} == {
        k: list(v) for k, v in b.constants.items()}
    assert a.output_property_arrays == b.output_property_arrays


# -- the runs ---------------------------------------------------------------
#: the reference's three IISPH runs: {run: (module, class, arguments,
#: the wall array or None)}
RUNS = {
    'taylor_green': ('taylor_green', 'TaylorGreen', ['--nx', '16'], None),
    'elliptical_drop': ('elliptical_drop', 'EllipticalDrop',
                        ['--nx', '20'], None),
    'dam_break_2d': ('dam_break_2d', 'DamBreak2D', ['--dx', '0.1'],
                     'boundary'),
}
EVAL_PROPS = {'fluid': ('rho', 'uadv', 'vadv', 'dii0', 'dii1', 'rho_adv',
                        'aii', 'dijpj0', 'dijpj1', 'p', 'piter', 'au', 'av',
                        'dt_cfl', 'dt_force', 'tmp_comp'),
              'wall': ('V',)}
STEP_PROPS = {'fluid': ('x', 'y', 'u', 'v', 'p', 'rho'), 'wall': ('V',)}


def _cls(package, run):
    mod, name, _, _ = RUNS[run]
    return getattr(importlib.import_module('%s.examples.%s' % (package, mod)),
                   name)


def _argv(run, extra=()):
    return ['--scheme', 'iisph', '--disable-output', '-q'] + \
        RUNS[run][2] + list(extra)


def _port_app(run, engine='kernel', extra=()):
    app = _cls('pysph_tpu_torch', run)()
    app.setup(['--use-double', '--device', 'cpu', '--engine', engine] +
              _argv(run, extra))
    return app


def _seed(particles, wall):
    """The fluid's positions moved by up to a tenth of dx and its
    velocities by a seeded tenth of their largest magnitude (1 m/s at
    rest)."""
    rng = np.random.default_rng(43)
    for pa in particles:
        if pa.name == wall:
            continue
        props = pa.properties
        n = pa.get_number_of_particles()
        dx = float(np.sqrt(props['m'][0] / props['rho'][0]))
        scale = float(np.sqrt(props['u'] ** 2 + props['v'] ** 2).max()) or \
            1.0
        for c in ('x', 'y'):
            props[c][:] += 0.1 * dx * rng.uniform(-1, 1, n)
        for c in ('u', 'v'):
            props[c][:] += 0.1 * scale * rng.normal(size=n)


def _snapshot(particles):
    return {pa.name: ({k: v.copy() for k, v in pa.properties.items()},
                      {k: v.copy() for k, v in pa.constants.items()},
                      dict(pa.stride)) for pa in particles}


def _outputs(arrays, wall, props):
    out = {}
    for name, get in arrays.items():
        kind = 'wall' if name == wall else 'fluid'
        out[name] = {p: get(p) for p in props[kind]}
    return out


#: the JAX package's evaluations and their pressure sweeps, counted by
#: host callbacks in the traced ``AdvectionAcceleration.post_loop`` (one
#: an evaluation) and ``PressureSolve.reduce`` (one a sweep)
_LOG = []


def _counting_post_loop(self, d_idx, d_au, d_av, d_aw, d_uadv, d_vadv,
                        d_wadv, d_u, d_v, d_w, dt):
    jax.debug.callback(lambda: _LOG.append('eval'), ordered=True)
    _JAX_POST_LOOP(self, d_idx, d_au, d_av, d_aw, d_uadv, d_vadv, d_wadv,
                   d_u, d_v, d_w, dt)


def _counting_reduce(self, dst, t, dt):
    # the body of the JAX reduce: its resident engine scans this source
    # for the dst props it reads
    jax.debug.callback(lambda: _LOG.append('sweep'), ordered=True)
    comp = dst.compression[:]
    mask = dst.mask if dst.mask is not None else dst.active
    count = jnp.sum(jnp.where(mask & (comp > 0), 1.0, 0.0))
    total = jnp.sum(jnp.where(mask, comp, 0.0))
    dst.tmp_comp[0] = count
    dst.tmp_comp[1] = total


_JAX_POST_LOOP = jax_iisph.AdvectionAcceleration.post_loop


def _sweeps(log):
    """The sweeps of each evaluation in a callback log."""
    out = []
    for entry in log:
        if entry == 'eval':
            out.append(0)
        else:
            out[-1] += 1
    return out


_RUNS = {}


def _jax_run(run, monkeypatch):
    """The JAX app's one evaluation and three steps of the seeded start:
    (eval outputs, step outputs, t, inputs, dt, sweeps of each
    evaluation: the one evaluation, then the solve's initial one and its
    steps')."""
    if run in _RUNS:
        return _RUNS[run]
    wall = RUNS[run][3]
    dt = float(np.float32(_port_app(run).solver.dt))
    monkeypatch.setattr(jax_iisph.AdvectionAcceleration, 'post_loop',
                        _counting_post_loop)
    monkeypatch.setattr(jax_iisph.PressureSolve, 'reduce', _counting_reduce)
    _LOG.clear()
    tmp = tempfile.mkdtemp()
    try:
        app = _cls('pysph_tpu', run)()
        app.setup(['-d', tmp] + _argv(run, ['--max-steps', '3', '--dt',
                                            repr(dt)]))
        _seed(app.particles, wall)
        inputs = _snapshot(app.particles)
        s = app.solver
        # the per-step loop, as the port's (an iterated group keeps its
        # runs off the chunks): the JAX chunk carries t and dt in float32
        # (ROADMAP Queue 3), and IISPH squares dt
        s.chunk_steps = 1
        s._sync_to_device()
        states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
        if s._check_overflow(diag):
            s._handle_overflow(diag)
            states, diag, carry = s._init_accel_fn(s.states, 0.0, s.dt)
        assert not s._check_overflow(diag)
        states = s._mat_fn(states, carry)
        sizes = {pa.name: pa.get_number_of_particles()
                 for pa in app.particles}
        evals = _outputs(
            {name: (lambda p, name=name: np.asarray(states[name][p])
                    if p == 'tmp_comp' else
                    np.asarray(states[name][p])[:sizes[name]])
             for name in sizes},
            wall, EVAL_PROPS)
        app.solve()
        jax.effects_barrier()
        steps = _outputs(
            {pa.name: (lambda p, pa=pa: np.asarray(
                pa.properties[p])[:sizes[pa.name]]) for pa in app.particles},
            wall, STEP_PROPS)
        assert s.count == 3
        _RUNS[run] = (evals, steps, s.t, inputs, dt, _sweeps(_LOG))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return _RUNS[run]


def _check(got, want, tol, label):
    checked = 0
    for name, props in want.items():
        for p, w in props.items():
            g = got[name][p]
            if np.abs(w).max() == 0.0:
                assert np.abs(g).max() == 0.0, (label, name, p)
                continue
            err = _scaled_err(g, w)
            assert err <= tol, '%s %s.%s: %.3g' % (label, name, p, err)
            checked += 1
    return checked


def _port_start(run, engine, extra=()):
    _, _, _, inputs, dt, _ = _RUNS[run]
    app = _port_app(run, engine, ['--dt', repr(dt)] + list(extra))
    s = app.solver
    s.particles = app.particles = [ParticleArray.from_numpy(name, *args)
                                   for name, args in inputs.items()]
    s._sync_to_device()
    return app, dt


@pytest.fixture(scope='module')
def jax_runs():
    with pytest.MonkeyPatch.context() as mp:
        for run in RUNS:
            _jax_run(run, mp)
    return _RUNS


@pytest.mark.parametrize('engine', ENGINES)
@pytest.mark.parametrize('run', list(RUNS))
def test_one_eval_matches_jax(run, engine, jax_runs):
    evals, _, _, _, dt, sweeps = jax_runs[run]
    app, dt = _port_start(run, engine)
    s = app.solver
    a_eval = s.acceleration_evals[0]
    assert set(a_eval.engine_choices.values()) == {engine}
    a_eval.sweeps.clear()
    s.integrator.initial_acceleration(s.states, 0.0, dt)
    # the torch engine sizes its capacities by running again
    assert a_eval.sweeps[-1] == sweeps[0]
    got = _outputs({name: (lambda p, st=st: st[p].numpy())
                    for name, st in s.states.items()},
                   RUNS[run][3], EVAL_PROPS)
    assert _check(got, evals, TOL, run + ' eval') >= 14


@pytest.mark.parametrize('run', list(RUNS))
def test_three_steps_match_jax(run, jax_runs):
    _, steps, t, _, _, sweeps = jax_runs[run]
    app, _ = _port_start(run, 'kernel', ['--max-steps', '3'])
    a_eval = app.solver.acceleration_evals[0]
    app.solve()
    s = app.solver
    assert s.count == 3 and abs(s.t - t) <= STEP_TOL * t
    # the JAX app's own initial evaluation and its three steps' (its log
    # starts with the evaluation of _jax_run, and a JAX evaluation whose
    # grid overflowed runs again)
    assert a_eval.sweeps == sweeps[-4:]
    got = _outputs({pa.name: (lambda p, pa=pa: np.asarray(
        pa.properties[p])) for pa in app.particles}, RUNS[run][3],
        STEP_PROPS)
    assert _check(got, steps, STEP_TOL, run + ' 3 steps') >= 6


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize('engine', ENGINES)
def test_iisph_pressure_solve_1e6(engine):
    """Three Euler steps of a compressed lattice against the all-pairs
    float64 oracle ``NumpyIISPH``, as ``tests/test_reference_parity.py::
    test_iisph_pressure_solve_1e6`` holds the JAX package: 1e-6 relative
    L2 on rho, p, x, y, u, v, and the oracle's sweep count each step,
    which must exceed 2 somewhere."""
    dx, rho0 = 0.1, 1000.0
    span = np.arange(-0.7, 0.7 + 1e-9, dx)
    x, y = (c.ravel() for c in np.meshgrid(span, span))
    n = x.size
    m = np.full(n, rho0 * dx * dx)
    h = np.full(n, 1.3 * dx)
    u, v = -5.0 * x, -5.0 * y
    scheme = iisph.IISPHScheme(fluids=['fluid'], solids=[], dim=2,
                               rho0=rho0, nu=0.0, omega=0.5, tolerance=1e-2)
    pa = get_particle_array_iisph(name='fluid', x=x, y=y, m=m, h=h, u=u,
                                  v=v)
    scheme.setup_properties([pa], clean=False)
    config = Config(engine=engine, **CPU)
    kernel = CubicSpline(dim=2)
    grid = CellGrid.from_particles([pa], dim=2, radius_scale=2.0)
    a_eval = AccelerationEval([pa], scheme.get_equations(), kernel, config,
                              grid)
    assert set(a_eval.engine_choices.values()) == {engine}
    integrator = EulerIntegrator(fluid=iisph.IISPHStep())
    integrator.set_acceleration_evals([a_eval])
    oracle = NumpyIISPH(x, y, m, h, u, v, rho0)
    states = {'fluid': pa.to_device(config)}
    dt, t = 5e-3, 0.0
    for _ in range(3):
        # a redo of an overflowed torch engine list runs the step again
        saved = dict(states['fluid'])
        while True:
            grid.watch_pairs()
            integrator.step(states, t, dt)
            if not grid.pairs_overflowed():
                break
            grid.grow_pairs()
            states['fluid'] = dict(saved)
            a_eval.sweeps.pop()
        oracle.step(dt)
        t += dt
    assert max(oracle.iterations) > 2, 'the oracle converged trivially'
    assert a_eval.sweeps == oracle.iterations
    s = {p: v.numpy() for p, v in states['fluid'].items()}
    for prop, ref in (('rho', oracle.rho), ('p', oracle.p),
                      ('x', oracle.x), ('y', oracle.y),
                      ('u', oracle.u), ('v', oracle.v)):
        err = _rel_l2(s[prop], ref)
        assert err <= 1e-6, '%s rel L2 %.3g > 1e-6' % (prop, err)


# -- the plans ---------------------------------------------------------------
#: {run: the fluid's plans' {source: terms} in order}
PLANS = {
    'taylor_green': [{'fluid': ip.SDEN}, {'fluid': ip.DII | ip.VISC},
                     {'fluid': ip.RHOADV | ip.AII}, {'fluid': ip.DIJPJ},
                     {'fluid': ip.PSOLVE}, {'fluid': ip.PFORCE}],
    'elliptical_drop': [{'fluid': ip.SDEN}, {'fluid': ip.DII},
                        {'fluid': ip.RHOADV | ip.AII}, {'fluid': ip.DIJPJ},
                        {'fluid': ip.PSOLVE}, {'fluid': ip.PFORCE}],
    'dam_break_2d': [
        {'fluid': ip.SDEN}, {'boundary': ip.SDENB},
        {'fluid': ip.DII, 'boundary': ip.DIIB},
        {'fluid': ip.RHOADV | ip.AII, 'boundary': ip.RHOB | ip.AIIB},
        {'fluid': ip.DIJPJ}, {'fluid': ip.PSOLVE, 'boundary': ip.PSOLVEB},
        {'fluid': ip.PFORCE, 'boundary': ip.PFORCEB}],
}


@pytest.mark.parametrize('run', list(RUNS))
def test_every_dest_is_on_iisph_pair_and_linked(run):
    app = _port_app(run)
    a_eval, = app.solver.acceleration_evals
    assert set(a_eval.engine_choices.values()) == {'kernel'}
    plans = [p for g in a_eval.leaf_groups() for p in [
        a_eval._plans.get((id(g), d)) for d in a_eval._dest_order(g)]
        if p is not None]
    assert all(p.op is ip.iisph_pair and p.takes_dt for p in plans)
    fluid = [p for p in plans if p.dest == 'fluid']
    assert [{ps.name: ps.terms for ps in p.sources} for p in fluid] == \
        PLANS[run]
    # the first plan that sees every later plan's sources emits: the
    # density's on the fluid-only runs, the advection's on the dam break
    first = 2 if RUNS[run][3] else 0
    link = fluid[first].link
    assert link is not None and link.emitter is fluid[first]
    assert link.consumer is fluid[-1]
    assert list(link.middle) == fluid[first + 1:-1]
    assert all(p.link is None for p in fluid[:first])
    wall = [p for p in plans if p.dest != 'fluid']
    if RUNS[run][3]:
        assert [{ps.name: ps.terms for ps in p.sources} for p in wall] == [
            {'boundary': ip.NDEN}]
        assert wall[0].link is None
        assert [ps.rho0 for p in fluid[1:] for ps in p.sources
                if ps.name == 'boundary'] == [1000.0] * 5
    else:
        assert not wall
    if run == 'taylor_green':
        assert fluid[1].sources[0].nu == app.scheme.scheme.nu > 0


def test_scheme_options_and_solver():
    app = _port_app('taylor_green', extra=['--omega', '0.4',
                                           '--tolerance', '0.02'])
    sch = app.scheme.scheme
    assert (sch.omega, sch.tolerance) == (0.4, 0.02)
    solve = [eq for g in app.solver.acceleration_evals[0].leaf_groups()
             for eq in g.equations if isinstance(eq, iisph.PressureSolve)]
    assert [(eq.omega, eq.tolerance) for eq in solve] == [(0.4, 0.02)]
    s = app.solver
    assert type(s.integrator) is EulerIntegrator
    assert isinstance(s.kernel, QuinticSpline) and s.pfreq == 10
    # the scheme's default kernel
    sch = iisph.IISPHScheme(['fluid'], [], dim=2, rho0=1.0)
    sch.configure_solver(dt=1e-3)
    assert isinstance(sch.get_solver().kernel, CubicSpline)


def test_an_iterated_group_keeps_the_run_off_the_chunks(caplog):
    """A graphed chunk (CUDA) refuses only an iterated group that sweeps
    on the host, one that no ``iisph_solve`` plan takes; IISPH's group,
    planned onto ``iisph_solve``, keeps the run in the chunks, and on the
    CPU, where a chunk runs eagerly, the IISPH run chunks."""
    app = _port_app('taylor_green', extra=['--max-steps', '3'])
    s = app.solver
    a_eval = s.acceleration_evals[0]
    assert s.chunk_steps == 10 and len(a_eval._solves) == 1
    logger = 'pysph_tpu_torch.solver.solver'
    s._graphed = lambda: True
    assert s._chunk_eligible()
    a_eval.solve_iterated = False
    with caplog.at_level(logging.INFO, logger=logger):
        assert not s._chunk_eligible()
    assert 'per-step loop: an iterated group that no iisph_solve plan ' \
        'takes' in caplog.text
    a_eval.solve_iterated = True
    del s._graphed
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=logger):
        app.solve()
    assert s.count == 3 and s.captures == 0 and s.replays == 0
    assert 'per-step loop' not in caplog.text
    assert a_eval.sweeps == [2] * 4 and a_eval.converged_reads == 0


@pytest.mark.parametrize('run', list(RUNS))
def test_the_solve_matches_jax(run, jax_runs):
    """The pressure group's one ``iisph_solve`` call (its plain version
    on the CPU) in place of the sweeps' pair calls: one evaluation
    against the JAX app's, the same sweeps, 1e-10, no host read of
    ``converged`` counted."""
    evals, _, _, _, dt, sweeps = jax_runs[run]
    app, dt = _port_start(run, 'kernel')
    s = app.solver
    a_eval = s.acceleration_evals[0]
    calls = iisph_check.record(a_eval)
    try:
        s.integrator.initial_acceleration(s.states, 0.0, dt)
    finally:
        iisph_check.forget(a_eval)
    solve, = iisph_check.solve_calls(calls)
    assert solve[1] == 'fluid'
    assert len(iisph_check.pair_calls(calls)) == (6 if RUNS[run][3] else 4)
    assert a_eval.sweeps == sweeps[:1] and a_eval.converged_reads == 0
    got = _outputs({name: (lambda p, st=st: st[p].numpy())
                    for name, st in s.states.items()},
                   RUNS[run][3], EVAL_PROPS)
    assert _check(got, evals, TOL, run + ' solve') >= 14


def test_plane_table_is_the_cuda_source():
    """``PACK_RECORDS`` is the ``plane q:`` table of
    ``csrc/iisph_pair.cu``, and every term mask of a phase set packs at
    most ``cell_pack.MAX_PLANES`` of its planes."""
    rows = re.findall(r'^//\s+plane (\d): (.+)$',
                      (build.CSRC / 'iisph_pair.cu').read_text(),
                      re.MULTILINE)
    assert [int(q) for q, _ in rows] == list(range(len(ip.PACK_RECORDS)))
    assert [tuple(None if p == '0' else p for p in names.split())
            for _, names in rows] == list(ip.PACK_RECORDS)
    for allowed in ip.PHASE_SETS:
        slots, _ = ip.pack_layout(allowed)
        assert slots[0] == 0 and len(slots) <= cell_pack.MAX_PLANES


def test_wrapper_refuses_calls_out_of_their_modes():
    """On the CPU the wrapper runs the plain version but refuses what the
    kernel would: an emitting call of a set that does not emit, a
    hand-off to a set that does not read one, and a hand-off emitted over
    other sources; a reader over fewer of the emitter's sources takes
    it."""
    calls, _, _, _ = iisph_check.calls('dam_break_2d', 0.1, torch.float64,
                                       steps=0, device='cpu')
    by_set = {ip.phase_of(sum(ps.terms for ps in c[2].sources)): c
              for c in calls if c[1] == 'fluid'}
    density = by_set[ip.DENSITY][3]
    advection = by_set[ip.ADVECTION][3]
    dijpj = by_set[ip.DIJPJ_SET][3]
    with pytest.raises(ValueError, match='emits no hand-off'):
        ip.iisph_pair(*dijpj, emit=True)
    _, handoff = ip.iisph_pair(*advection, emit=True)
    assert handoff.sources == (('fluid', 231), ('boundary', 532))
    with pytest.raises(ValueError, match='takes no hand-off'):
        ip.iisph_pair(*density, handoff=handoff)
    # dijpj reads the fluid alone: the emitter's fluid and wall list
    got = ip.iisph_pair(*dijpj, handoff=handoff)
    want = ip.iisph_pair_reference(*dijpj)
    assert all(torch.equal(got[p], want[p]) for p in want)
    # the pressure sweep reads both, in the emitter's order
    solve = by_set[ip.SOLVE][3]
    ip.iisph_pair(*solve, handoff=handoff)
    other = handoff._replace(sources=(('boundary', 532), ('fluid', 231)))
    with pytest.raises(ValueError, match='hand-off of'):
        ip.iisph_pair(*solve, handoff=other)
    assert pair_link.copies_of(advection[4]) == handoff.sources
