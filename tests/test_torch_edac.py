"""The port's EDAC (``sph/wc/edac.py``) against pysph_tpu's, float64 on
the CPU, inputs seeded with numpy.

- Each EDAC equation and phase set through the port's ``SPHEvaluator``
  against the JAX ``SPHEvaluator``, at 1e-10 of ``max|ref|``, on a fluid
  inside three layers of wall (an open box, and a channel periodic in x
  for the momentum sets), on the kernel engine (on the CPU the plain
  versions of ``tvf_pair`` and ``gtvf_pair``) and the torch engine.
- Every stage of ``EDACStep`` and ``EDACTVFStep`` against the JAX
  classes' (1e-14, as ``tests/test_torch_integrator_step.py``).
- The reference's three EDAC runs, ``taylor_green --nx 16``, ``cavity
  --nx 12`` and ``dam_break_2d --dx 0.1`` with ``--scheme edac``, from
  the example's particles with the fluid's positions jittered by a
  tenth of dx and its density, velocity and pressure seeded: one
  evaluation against the JAX app's on both engines at 1e-10, and three
  steps on the kernel engine at 1e-9 (a dt that float32 holds exactly:
  the JAX float64 time loop hands a fixed dt over as float32).
- The plans: under the kernel engine every dest of the three runs is on
  ``tvf_pair`` or ``gtvf_pair`` with the terms the scheme gives it, and
  each fluid's momentum plan reads its density plan's neighbour list
  (the cavity's mean-pressure plan too).
- The scheme: its forms, its options (``--edac-alpha``, ``--no-use-bql``,
  ``--clamp-pressure``), ``art_nu``, and the inlet/outlet manager it
  refuses naming its ROADMAP item.
- The chunks against the per-step loop (``time_chunks.gate``, the gates
  the card runs: 30 steps of each run at a small size).

``tests/test_torch_edac_cuda.py`` holds the kernels to their plain
versions on the card.
"""

import importlib
import inspect
import shutil
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysph_tpu.base.domain import DomainManager as JaxDomain
from pysph_tpu.base.kernels import CubicSpline as JaxCubicSpline
from pysph_tpu.base.kernels import QuinticSpline as JaxQuintic
from pysph_tpu.base.utils import get_particle_array as jax_array
from pysph_tpu.sph import basic_equations as jax_basic
from pysph_tpu.sph.acceleration_eval import (
    ArraySchema, _bind_particle_phase as jax_bind)
from pysph_tpu.sph.equation import Group as JaxGroup
from pysph_tpu.sph.wc import edac as jax_edac
from pysph_tpu.sph.wc import transport_velocity as jax_tv
from pysph_tpu.tools.sph_evaluator import SPHEvaluator as JaxEvaluator
from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.kernels import CubicSpline, QuinticSpline
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.base.utils import get_particle_array
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.sph import basic_equations
from pysph_tpu_torch.sph.acceleration_eval import _bind_particle_phase
from pysph_tpu_torch.sph.equation import Group, _method_args
from pysph_tpu_torch.sph.integrator import PECIntegrator
from pysph_tpu_torch.sph.wc import edac
from pysph_tpu_torch.sph.wc import transport_velocity as tv
from pysph_tpu_torch.tools.sph_evaluator import SPHEvaluator
from pysph_tpu_torch.tools_dev import time_chunks
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = 1e-10
STEP_TOL = 1e-9
CPU = dict(device='cpu', dtype=torch.float64)
ENGINES = ['kernel', 'torch']
NU, C0, P0 = 0.01, 10.0, 100.0
#: the fluid and wall props an equation case writes
PROPS = {'fluid': ('pavg', 'nnbr', 'au', 'av', 'auhat', 'avhat', 'ap',
                   'ax', 'ay', 'u', 'v', 'uhat', 'vhat'),
         'solid': ('wij', 'V', 'p', 'uf', 'vf', 'ug', 'vg', 'u', 'v',
                   'uhat', 'vhat')}
#: the props of the arrays: TVF's fluid and wall props and EDAC's
FLUID_PROPS = ('uhat', 'vhat', 'what', 'auhat', 'avhat', 'awhat', 'V',
               'pavg', 'nnbr', 'ap', 'ax', 'ay', 'az')
SOLID_PROPS = ('V', 'wij', 'ax', 'ay', 'az', 'uf', 'vf', 'wf', 'ug', 'vg',
               'wg', 'xn', 'yn', 'zn', 'uhat', 'vhat', 'what')


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


def _walls(make, geometry, seed=17):
    """Fluid inside three layers of wall, as
    ``tests/test_torch_tvf_walls.py``'s: ``channel`` periodic in x on [0,
    1], ``box`` closed (an open grid).  Positions jittered by 5% of dx;
    seeded velocities, transport velocities, densities, volumes,
    pressures and mean pressures, the wall's accelerations and normals."""
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
    fluid = make(
        name='fluid', additional_props=list(FLUID_PROPS),
        x=xf + 0.05 * dx * rng.normal(size=nf),
        y=yf + 0.05 * dx * rng.normal(size=nf), h=1.2 * dx,
        m=dx * dx * (1.0 + 0.05 * rng.normal(size=nf)),
        rho=1.0 + 0.01 * rng.normal(size=nf),
        u=rng.normal(0.0, 0.3, nf), v=rng.normal(0.0, 0.3, nf),
        uhat=rng.normal(0.0, 0.3, nf), vhat=rng.normal(0.0, 0.3, nf),
        p=10.0 * rng.normal(size=nf), pavg=rng.normal(size=nf),
        V=(1.0 + 0.02 * rng.normal(size=nf)) / (dx * dx))
    angle = rng.uniform(0.0, 2 * np.pi, nw)
    solid = make(
        name='solid', additional_props=list(SOLID_PROPS),
        x=xw, y=yw, h=1.2 * dx, m=dx * dx,
        rho=1.0 + 0.01 * rng.normal(size=nw),
        u=np.where(yw > 0.6, 1.0, 0.0), au=rng.normal(0.0, 0.5, nw),
        av=rng.normal(0.0, 0.5, nw), p=10.0 * rng.normal(size=nw),
        xn=np.cos(angle), yn=np.sin(angle),
        V=(1.0 + 0.02 * rng.normal(size=nw)) / (dx * dx))
    return [fluid, solid]


def _groups(mod, tvm, basic, group, case):
    """The groups of an equation case, from ``mod`` (the JAX or the
    port's ``edac``), ``tvm`` (``transport_velocity``), ``basic``
    (``basic_equations``) and ``group`` (their Group)."""
    fs, f, s = ['fluid', 'solid'], ['fluid'], ['solid']
    sets = {
        'ComputeAveragePressure': [
            mod.ComputeAveragePressure('fluid', fs)],
        'wall set': [
            mod.SourceNumberDensity('solid', f),
            tvm.VolumeSummation('solid', fs),
            mod.SolidWallPressureBC('solid', f, gx=0.3, gy=-9.81),
            mod.SetWallVelocity('solid', f),
            mod.ClampWallPressure('solid', None)],
        'inviscid walls': [
            mod.SourceNumberDensity('solid', f),
            mod.NoSlipVelocityExtrapolation('solid', f),
            mod.NoSlipAdvVelocityExtrapolation('solid', f)],
        'external momentum set': [
            mod.MomentumEquation('fluid', fs, c0=C0, gx=0.2, gy=-9.81,
                                 tdamp=1.0),
            mod.EDACEquation('fluid', fs, cs=C0, nu=0.05, rho0=1.0),
            basic.XSPHCorrection('fluid', f, eps=0.5)],
        'TVF momentum set': [
            mod.MomentumEquationPressureGradient('fluid', fs, pb=P0,
                                                 gy=-1.0, tdamp=1.0),
            tvm.MomentumEquationViscosity('fluid', f, nu=NU),
            tvm.SolidWallNoSlipBC('fluid', s, nu=NU),
            tvm.MomentumEquationArtificialStress('fluid', f),
            mod.EDACEquation('fluid', fs, cs=C0, nu=0.05, rho0=1.0)],
    }
    return [group(equations=sets[case])]


#: {case: (geometries, the kernel that takes it on the kernel engine)}
CASES = {'ComputeAveragePressure': (('box',), tp.tvf_pair),
         'wall set': (('box',), gp.gtvf_pair),
         'inviscid walls': (('box',), None),
         'external momentum set': (('box', 'channel'), tp.tvf_pair),
         'TVF momentum set': (('box', 'channel'), tp.tvf_pair)}
EQ_CASES = [(c, g) for c, (gs, _) in CASES.items() for g in gs]


def _domain(cls, geometry):
    return cls(xmin=0.0, xmax=1.0, periodic_in_x=True) \
        if geometry == 'channel' else None


_JAX = {}


def _jax_case(case, geometry, t):
    key = (case, geometry, t)
    if key not in _JAX:
        arrays = _walls(jax_array, geometry)
        ev = JaxEvaluator(arrays, _groups(jax_edac, jax_tv, jax_basic,
                                          JaxGroup, case),
                          dim=2, kernel=JaxQuintic(dim=2),
                          domain_manager=_domain(JaxDomain, geometry))
        ev.evaluate(t=t, dt=1e-4)
        _JAX[key] = {pa.name: {p: np.asarray(getattr(pa, p))
                               for p in PROPS[pa.name]} for pa in arrays}
    return _JAX[key]


@pytest.mark.parametrize('engine', ENGINES)
@pytest.mark.parametrize('case,geometry', EQ_CASES)
def test_edac_equations_match_jax(case, geometry, engine):
    t = 0.4     # inside tdamp: the body force is damped
    want = _jax_case(case, geometry, t)
    arrays = _walls(get_particle_array, geometry)
    ev = SPHEvaluator(arrays, _groups(edac, tv, basic_equations, Group,
                                      case),
                      dim=2, kernel=QuinticSpline(dim=2),
                      domain_manager=_domain(DomainManager, geometry),
                      config=Config(engine=engine, **CPU))
    ev.evaluate(t=t, dt=1e-4)
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
    assert checked >= 2


STEP_CLASSES = ('EDACStep', 'EDACTVFStep')
STEP_CASES = [(c, stage) for c in STEP_CLASSES
              for stage in ('initialize', 'stage1', 'stage2')]


@pytest.mark.parametrize('name,stage', STEP_CASES)
def test_step_stage_matches_jax(name, stage):
    jax_fn = getattr(getattr(jax_edac, name)(), stage)
    fn = getattr(getattr(edac, name)(), stage)
    props = sorted(a[2:] for a in _method_args(jax_fn) if a.startswith('d_'))
    assert props == sorted(a[2:] for a in _method_args(fn)
                           if a.startswith('d_'))
    rng = np.random.default_rng(STEP_CASES.index((name, stage)))
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
        assert _scaled_err(got, want) <= 1e-14, (name, stage, p)
        assert np.array_equal(got[~mask], values[p][~mask]), p
        changed += not np.array_equal(want, values[p])
    assert changed


def test_every_edac_class_is_ported():
    """The port's module has every class and function of the JAX
    module, each equation with the same methods."""
    def public(mod):
        return {n: v for n, v in vars(mod).items()
                if (inspect.isclass(v) or inspect.isfunction(v)) and
                v.__module__ == mod.__name__ and not n.startswith('_')}
    mine, theirs = public(edac), public(jax_edac)
    assert set(theirs) <= set(mine)
    for name, cls in theirs.items():
        if inspect.isclass(cls):
            own = {m for m in vars(cls) if not m.startswith('_')}
            assert own == {m for m in vars(mine[name])
                           if not m.startswith('_')}, name
    assert edac.EDAC_PROPS == jax_edac.EDAC_PROPS
    assert edac.EDAC_SOLID_PROPS == jax_edac.EDAC_SOLID_PROPS


#: the reference's three EDAC runs: {run: (module, class, arguments, the
#: wall array or None)}
RUNS = {
    'taylor_green': ('taylor_green', 'TaylorGreen', ['--nx', '16'], None),
    'cavity': ('cavity', 'LidDrivenCavity', ['--nx', '12'], 'solid'),
    'dam_break_2d': ('dam_break_2d', 'DamBreak2D', ['--dx', '0.1'],
                     'boundary'),
}
EVAL_PROPS = {'fluid': ('V', 'rho', 'pavg', 'nnbr', 'au', 'av', 'auhat',
                        'avhat', 'ap', 'ax', 'ay'),
              'wall': ('wij', 'V', 'p', 'uf', 'vf', 'ug', 'vg')}
STEP_PROPS = {'fluid': ('x', 'y', 'u', 'v', 'p', 'rho', 'V'),
              'wall': ('p', 'V', 'ug', 'vg')}


def _cls(package, run):
    mod, name, _, _ = RUNS[run]
    return getattr(importlib.import_module('%s.examples.%s' % (package, mod)),
                   name)


def _argv(run, extra=()):
    return ['--scheme', 'edac', '--disable-output', '-q'] + \
        RUNS[run][2] + list(extra)


def _port_app(run, engine='kernel', extra=()):
    app = _cls('pysph_tpu_torch', run)()
    app.setup(['--use-double', '--device', 'cpu', '--engine', engine] +
              _argv(run, extra))
    return app


def _seed(particles, wall):
    """The fluids' positions moved by up to a tenth of dx, their
    densities by 1%, their velocities and pressures seeded."""
    rng = np.random.default_rng(41)
    for pa in particles:
        if pa.name == wall:
            continue
        props = pa.properties
        n = pa.get_number_of_particles()
        dx = float(np.sqrt(props['m'][0] / props['rho'][0]))
        for c in ('x', 'y'):
            props[c][:] += 0.1 * dx * rng.uniform(-1, 1, n)
        scale = float(props['rho'].mean())
        props['rho'][:] *= 1.0 + 0.01 * rng.normal(size=n)
        for c in ('u', 'v'):
            props[c][:] += rng.normal(0.0, 0.3, n)
        props['p'][:] += scale * rng.normal(size=n)


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


_RUNS = {}


def _jax_run(run):
    """The JAX app's one evaluation and three steps of the seeded
    start: (eval outputs, step outputs, t, inputs, dt)."""
    if run in _RUNS:
        return _RUNS[run]
    wall = RUNS[run][3]
    dt = float(np.float32(_port_app(run).solver.dt))
    tmp = tempfile.mkdtemp()
    try:
        app = _cls('pysph_tpu', run)()
        app.setup(['-d', tmp] + _argv(run, ['--max-steps', '3', '--dt',
                                            repr(dt)]))
        _seed(app.particles, wall)
        inputs = _snapshot(app.particles)
        s = app.solver
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
            {name: (lambda p, name=name: np.asarray(
                states[name][p])[:sizes[name]]
                if p in states[name] else None) for name in sizes},
            wall, EVAL_PROPS)
        app.solve()
        steps = _outputs(
            {pa.name: (lambda p, pa=pa: np.asarray(
                pa.properties[p])[:sizes[pa.name]]
                if p in pa.properties else None) for pa in app.particles},
            wall, STEP_PROPS)
        assert s.count == 3
        _RUNS[run] = (evals, steps, s.t, inputs, dt)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return _RUNS[run]


def _check(got, want, tol, label):
    checked = 0
    for name, props in want.items():
        for p, w in props.items():
            if w is None:
                assert got[name][p] is None, (label, name, p)
                continue
            g = got[name][p]
            if np.abs(w).max() == 0.0:
                assert np.abs(g).max() == 0.0, (label, name, p)
                continue
            err = _scaled_err(g, w)
            assert err <= tol, '%s %s.%s: %.3g' % (label, name, p, err)
            checked += 1
    return checked


def _port_start(run, engine, extra=()):
    _, _, _, inputs, dt = _jax_run(run)
    app = _port_app(run, engine, ['--dt', repr(dt)] + list(extra))
    s = app.solver
    s.particles = app.particles = [ParticleArray.from_numpy(name, *args)
                                   for name, args in inputs.items()]
    s._sync_to_device()
    return app, dt


@pytest.mark.parametrize('engine', ENGINES)
@pytest.mark.parametrize('run', list(RUNS))
def test_one_eval_matches_jax(run, engine):
    evals, _, _, _, dt = _jax_run(run)
    app, dt = _port_start(run, engine)
    s = app.solver
    assert set(s.acceleration_evals[0].engine_choices.values()) == {engine}
    s.integrator.initial_acceleration(s.states, 0.0, dt)
    got = _outputs({name: (lambda p, st=st: st[p].numpy() if p in st
                           else None) for name, st in s.states.items()},
                   RUNS[run][3], EVAL_PROPS)
    assert _check(got, evals, TOL, run + ' eval') >= 8


@pytest.mark.parametrize('run', list(RUNS))
def test_three_steps_match_jax(run):
    _, steps, t, _, _ = _jax_run(run)
    app, _ = _port_start(run, 'kernel', ['--max-steps', '3'])
    app.solve()
    s = app.solver
    assert s.count == 3 and abs(s.t - t) <= STEP_TOL * t
    got = _outputs({pa.name: (lambda p, pa=pa: np.asarray(
        pa.properties[p]) if p in pa.properties else None)
        for pa in app.particles}, RUNS[run][3], STEP_PROPS)
    assert _check(got, steps, STEP_TOL, run + ' 3 steps') >= 7


#: {run: (density terms, mean-pressure terms or None, momentum terms by
#: source)} of the fluid's plans
PLANS = {
    'taylor_green': ({'fluid': tp.SDEN | tp.AVGP}, None,
                     {'fluid': tp.EMPG | tp.VISC | tp.MAS | tp.EDACEQ}),
    'cavity': ({'fluid': tp.SDEN, 'solid': tp.SDEN},
               {'fluid': tp.AVGP, 'solid': tp.AVGP},
               {'fluid': tp.EMPG | tp.VISC | tp.MAS | tp.EDACEQ,
                'solid': tp.EMPG | tp.NOSLIP | tp.EDACEQ}),
    'dam_break_2d': ({'fluid': tp.SDEN, 'boundary': tp.SDEN}, None,
                     {'fluid': tp.EMOM | tp.EDACEQ | tp.XSPH,
                      'boundary': tp.EMOM | tp.EDACEQ}),
}


@pytest.mark.parametrize('run', list(RUNS))
def test_every_dest_is_on_a_kernel_and_linked(run):
    app = _port_app(run)
    s = app.solver
    wall = RUNS[run][3]
    a_eval, = s.acceleration_evals
    assert set(a_eval.engine_choices.values()) == {'kernel'}
    plans = [p for g in a_eval.groups for p in [
        a_eval._plans.get((id(g), d)) for d in a_eval._dest_order(g)]
        if p is not None]
    fluid = [p for p in plans if p.dest == 'fluid']
    assert all(p.op is tp.tvf_pair for p in fluid)
    density, middle, momentum = PLANS[run]
    want = [density] + ([middle] if middle else []) + [momentum]
    assert [{ps.name: ps.terms for ps in p.sources} for p in fluid] == want
    link = fluid[0].link
    assert link is not None and all(p.link is link for p in fluid)
    assert link.emitter is fluid[0] and link.consumer is fluid[-1]
    assert list(link.middle) == fluid[1:-1]
    sch = app.scheme.scheme
    for ps in fluid[-1].sources:
        assert (ps.cs, ps.edac_nu) == (sch.c0, sch._get_edac_nu())
    if wall is None:
        assert len(plans) == 2
        return
    walls = [p for p in plans if p.dest == wall]
    assert len(walls) == 1 and walls[0].op is gp.gtvf_pair
    assert {ps.name: ps.terms for ps in walls[0].sources} == {
        'fluid': gp.SND | gp.VSUM | gp.EWALLP | gp.ESWV, wall: gp.VSUM}
    assert walls[0].outputs == ('uf', 'vf', 'wf', 'wij', 'V', 'p')


def test_scheme_forms_and_options():
    tg = _port_app('taylor_green')
    sch = tg.scheme.scheme
    assert sch.use_tvf and sch.bql
    h0 = 1.0 / 16
    assert sch.art_nu == 0.5 * h0 * 10.0 / 8
    s = tg.solver
    assert type(s.integrator) is PECIntegrator and \
        type(s.kernel) is QuinticSpline
    assert [type(st) for st in s.integrator.steppers.values()] == [
        edac.EDACTVFStep]
    # an EDAC viscosity of the option; without the correction no mean
    # pressure
    tg = _port_app('taylor_green', extra=['--edac-alpha', '0.25',
                                          '--no-use-bql'])
    sch = tg.scheme.scheme
    assert sch.art_nu == 0.25 * h0 * 10.0 / 8 and not sch.bql
    eqs = sch.get_equations()
    assert [type(e).__name__ for e in eqs[0].equations] == [
        'SummationDensity']
    eq = next(e for e in eqs[-1].equations
              if isinstance(e, edac.EDACEquation))
    assert eq.nu == sch.art_nu
    db = _port_app('dam_break_2d')
    sch = db.scheme.scheme
    assert not sch.use_tvf and sch.clamp_p
    assert [type(st) for st in db.solver.integrator.steppers.values()] == [
        edac.EDACStep]
    names = [type(e).__name__ for e in sch.get_equations()[0].equations]
    assert names[-1] == 'ClampWallPressure'
    cav = _port_app('cavity', extra=['--clamp-pressure'])
    # the transport-velocity form takes no clamp
    names = [type(e).__name__ for g in cav.scheme.scheme.get_equations()
             for e in g.equations]
    assert 'ClampWallPressure' not in names
    assert names.count('ComputeAveragePressure') == 1


def test_inlet_outlet_manager_is_refused_naming_its_item():
    sch = edac.EDACScheme(['fluid'], [], dim=2, c0=C0, nu=NU, rho0=1.0,
                          pb=P0, h=0.1, inlet_outlet_manager=object())
    for call in (sch.get_equations, lambda: sch.configure_solver(dt=1e-3),
                 lambda: sch.setup_properties([])):
        with pytest.raises(NotImplementedError,
                           match=r'ROADMAP Queue 1 item 28'):
            call()


@pytest.mark.parametrize('case', ['taylor_green edac nx=40',
                                  'cavity edac nx=20',
                                  'dam_break_2d edac dx=0.04'])
def test_chunks_match_the_per_step_loop(case):
    held = time_chunks.gate(case, 'cpu')
    assert held['steps'] == time_chunks.GATE_STEPS
    assert held['max_scaled_err'] <= time_chunks.TOL
