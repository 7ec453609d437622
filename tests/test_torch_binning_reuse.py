"""The port's binning reuse against pysph_tpu's (CPU, float64).

Input: the dam_break_3d geometry at dx=0.12 (1,960 particles in three
arrays) with seeded velocities (numpy ``default_rng``).

- The reuse decision: the port's ``AccelerationEval.prepare_reuse``
  against ``pysph_tpu``'s (its ``diag['rebinned']``) on the same states
  and the same earlier binning: no motion, a particle moved just under
  and just over half the slack margin, h grown past the cell width and
  within its 1.0001 tolerance.
- The rebuild count: 10 steps of a fixed dt through the JAX integrator
  (XLA engine, ``nnps_carry`` threaded as its solver does) and through
  the port's, rebuild for rebuild.
- Reuse against binning every eval: 20 steps of the port's solver with
  the default reuse at ``cell_slack`` 1.1 and with ``bin_every_eval`` at
  1.001 agree to 1e-12 of ``max|ref|`` per property (the same pairs,
  summed in other orders).
- The plain binning (``ops/bin_cells.py::bin_cells_reference``): with the
  flag 0 the handle stays bitwise as it was, with the flag 1 it equals a
  fresh binning; a grow invalidates the handles.
"""

import shutil
import tempfile

import jax
import numpy as np
import pytest
import torch

from pysph_tpu.config import get_config
from pysph_tpu.examples.dam_break_3d import DamBreak3D as JaxDamBreak3D
from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
from pysph_tpu_torch.ops import bin_cells as bc
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

ARGV = ['--dx', '0.12']
CPU = ['-q', '--disable-output', '--use-double', '--device', 'cpu']
#: seeded velocities fast enough to rebuild every few steps of DT
SPEED = 3.0
DT = 5e-4
STEPS = 10
#: steps of the solves of reuse against binning every eval
SOLVE_STEPS = 20
PROPS = ('x', 'y', 'z', 'u', 'v', 'w', 'rho', 'p')
#: the fluid particle that the decision cases move
K = 7


def _jax_app(tmp):
    """pysph_tpu's dam break on its XLA engine with seeded velocities;
    returns (app, {name: (props, constants)} of its particles)."""
    app = JaxDamBreak3D()
    app.setup(['-d', tmp, '-q', '--disable-output'] + ARGV)
    rng = np.random.default_rng(5)
    for pa in app.particles:
        n = pa.get_number_of_particles()
        for p in 'uvw':
            setattr(pa, p, rng.normal(0.0, SPEED, n))
    inputs = {pa.name: ({k: v.copy() for k, v in pa.properties.items()},
                        {k: v.copy() for k, v in pa.constants.items()})
              for pa in app.particles}
    app.solver._sync_to_device()
    return app, inputs


def _port_app(inputs, argv=()):
    app = DamBreak3D()
    app.setup(CPU + ARGV + list(argv))
    s = app.solver
    s.particles = [ParticleArray.from_numpy(name, props, consts)
                   for name, (props, consts) in inputs.items()]
    s._sync_to_device()
    return app


@pytest.fixture(scope='module')
def jax_side():
    """(app, inputs, jitted prepare_reuse, the binning of the initial
    states and its diag) of pysph_tpu's dam break."""
    cfg = get_config()
    old = cfg._use_pallas
    tmp = tempfile.mkdtemp()
    try:
        cfg.use_pallas = False
        app, inputs = _jax_app(tmp)
        a_eval = app.solver.integrator.acceleration_evals[0]
        handle, diag = jax.jit(a_eval.prepare)(app.solver.states)
        yield app, inputs, jax.jit(a_eval.prepare_reuse), handle, diag
    finally:
        cfg._use_pallas = old
        shutil.rmtree(tmp, ignore_errors=True)


def _move_jax(states, name, prop, k, fn):
    out = {n: dict(s) for n, s in states.items()}
    col = out[name][prop]
    out[name][prop] = col.at[k].set(fn(col[k]))
    return out


def _move_port(states, name, prop, k, fn):
    out = {n: dict(s) for n, s in states.items()}
    col = out[name][prop].clone()
    col[k] = fn(col[k])
    out[name][prop] = col
    return out


#: {case: (array, prop, change as a function of (value, margin, hmax))}
DECISIONS = {
    'no motion': ('fluid', 'x', lambda v, m, h: v),
    'moved under the margin': ('fluid', 'x', lambda v, m, h: v + 0.999 * m),
    'moved over the margin': ('fluid', 'x', lambda v, m, h: v + 1.001 * m),
    'moved over the margin in z': ('fluid', 'z',
                                   lambda v, m, h: v - 1.001 * m),
    'h grown past the width': ('fluid', 'h', lambda v, m, h: 1.01 * h),
    'h grown within the tolerance': ('fluid', 'h',
                                     lambda v, m, h: 1.00005 * h),
}


@pytest.mark.parametrize('case', list(DECISIONS))
def test_reuse_decision_matches_jax(jax_side, case):
    app, inputs, prepare_reuse, handle, diag = jax_side
    name, prop, change = DECISIONS[case]
    a_eval = app.solver.integrator.acceleration_evals[0]
    ref_states = app.solver.states
    assert int(diag['rebinned']) == 1

    port = _port_app(inputs).solver
    p_eval = port.acceleration_evals[0]
    assert p_eval.arrays_used == a_eval.arrays_used
    p_handle, flag = p_eval.prepare(port.states)
    assert bool(flag)
    hmax = max(float(s['h'].max()) for s in port.states.values())
    spec = a_eval.grid_spec
    assert spec.cell_slack == port.grid.cell_slack == 1.1
    margin = port.grid.half_margin() * hmax
    assert float(p_handle.width) == float(handle.widths[0])

    def fn(v):
        return change(v, margin, hmax)

    moved_jax = _move_jax(ref_states, name, prop, K, fn)
    moved_port = _move_port(port.states, name, prop, K, fn)
    _, jdiag = prepare_reuse(moved_jax, handle)
    before = {p: t.clone() for p, t in p_handle.ref.items()}
    _, flag = p_eval.prepare_reuse(moved_port, p_handle)
    want = bool(int(jdiag['rebinned']))
    assert bool(flag) == want
    assert want == (case in ('moved over the margin',
                             'moved over the margin in z',
                             'h grown past the width'))
    # a kept binning keeps its reference positions; a rebuilt one takes
    # the moved ones
    for n, ref in p_handle.ref.items():
        st = moved_port[n]
        assert torch.equal(ref, torch.stack([st['x'], st['y'], st['z']])
                           if want else before[n])


def test_rebuild_count_matches_jax(jax_side):
    """Every step's rebuild: the JAX integrator's ``diag['rebinned']``
    with its ``nnps_carry`` threaded, against the port's count."""
    app, inputs, _, handle, diag = jax_side
    s = app.solver
    # the carry of the initial eval: the binning of the initial states (a
    # step evaluates its accelerations afresh and the dt is fixed, so the
    # initial eval's values are not needed)
    states, carry = s.states, {0: handle}
    want = [int(diag['rebinned'])]
    for i in range(STEPS):
        states, diag, carry = s._step_fn(states, i * DT, DT, carry)
        want.append(int(diag['rebinned']))

    port = _port_app(inputs).solver
    integ = port.integrator
    integ.initial_acceleration(port.states, 0.0, DT)
    got = [int(integ.rebuilds)]
    for i in range(STEPS):
        integ.step(port.states, i * DT, DT)
        got.append(int(integ.rebuilds) - sum(got))
    assert got == want
    assert 3 <= sum(got) <= STEPS // 2 + 1, got
    # the port stayed on the reference's trajectory
    n = inputs['fluid'][0]['x'].shape[0]
    for p in PROPS:
        ref = np.asarray(states['fluid'][p])[:n]
        err = np.abs(port.states['fluid'][p].numpy() - ref).max()
        assert err <= 1e-9 * np.abs(ref).max(), p


def _solve(inputs, every_eval):
    app = _port_app(inputs, ['--max-steps', str(SOLVE_STEPS)])
    s = app.solver
    s.n_damp = 0
    if every_eval:
        s.integrator.bin_every_eval = True
        s.grid.resize(s.states.values(), cell_slack=1.001)
    app.solve()
    return s


def test_reuse_equals_binning_every_eval(jax_side):
    inputs = jax_side[1]
    reuse = _solve(inputs, False)
    every = _solve(inputs, True)
    assert reuse.count == every.count == SOLVE_STEPS
    assert reuse.grid.cell_slack == 1.1 and every.grid.cell_slack == 1.001
    # reuse binned once a step at most, the other every eval or nearly
    assert 2 <= reuse.rebuilds <= SOLVE_STEPS // 2 + 1
    assert every.rebuilds > SOLVE_STEPS
    assert abs(reuse.t - every.t) <= 1e-12 * every.t
    for name, st in every.states.items():
        for p in PROPS:
            ref = st[p]
            err = float((reuse.states[name][p] - ref).abs().max())
            assert err <= 1e-12 * float(ref.abs().max()), (name, p)


CPU64 = Config(device='cpu', dtype=torch.float64)


def _arrays(dim, seed):
    rng = np.random.default_rng(seed)
    arrays = []
    for name, n in (('a', 300), ('b', 120), ('empty', 0)):
        xyz = np.zeros((3, n))
        xyz[:dim] = rng.uniform(0.0, 1.0, (dim, n))
        arrays.append(ParticleArray(name=name, x=xyz[0], y=xyz[1], z=xyz[2],
                                    h=rng.uniform(0.02, 0.04, n)))
    return arrays


def _snapshot(handle):
    tensors = [handle.origin, handle.width, handle.overflow]
    for name in handle.names:
        tensors += list(handle.lists[name]) + [handle.ref[name]]
    return [t.clone() for t in tensors]


@pytest.mark.parametrize('dim', [2, 3])
@pytest.mark.parametrize('flag', [0, 1])
def test_plain_binning_under_the_flag(dim, flag):
    """The flag 0 (a stale binning in an inactive step) leaves every
    tensor of the handle bitwise as it was; the flag 1 (forced) gives a
    fresh binning of the moved particles, with their positions as the
    reference."""
    arrays = _arrays(dim, 3 + dim)
    grid = CellGrid.from_particles(arrays, dim=dim, radius_scale=2.0)
    states = {pa.name: pa.to_device(CPU64) for pa in arrays}
    handle = grid.handle_for(None, states)
    assert bool(bc.bin_cells(grid, states, handle))     # new: stale
    moved = {n: dict(s) for n, s in states.items()}
    moved['a']['x'] = moved['a']['x'] + 0.6      # past the grid
    before = _snapshot(handle)
    if flag:
        got = bc.bin_cells(grid, moved, handle, force=True,
                           active=torch.tensor(True))
    else:
        got = bc.bin_cells(grid, moved, handle, active=torch.tensor(False))
    assert bool(got) == bool(flag) and got is handle.rebuild
    if not flag:
        for a, b in zip(_snapshot(handle), before):
            assert torch.equal(a, b)
        return
    lo, hi, hmax = grid._box(moved.values())
    width = grid.cell_slack * grid.radius_scale * hmax
    assert torch.equal(handle.origin, lo) and torch.equal(handle.width, width)
    assert bool(handle.overflow) == bool(grid.escaped(lo, hi, width))
    assert bool(handle.overflow)              # x moved beyond the grid
    for name, s in moved.items():
        fresh = grid.bin(s, lo, width)
        for got_t, want_t in zip(handle.lists[name], fresh):
            assert torch.equal(got_t, want_t)
        assert torch.equal(handle.ref[name],
                           torch.stack([s['x'], s['y'], s['z']]))
    # stable within a cell: the order ascends there
    cl = handle.lists['a']
    cell = cl.cell.long()[cl.order.long()]
    same = cell[1:] == cell[:-1]
    assert bool((cl.order[1:][same] > cl.order[:-1][same]).all())


def test_grow_invalidates_the_handles():
    arrays = _arrays(3, 11)
    grid = CellGrid.from_particles(arrays, dim=3, radius_scale=2.0)
    states = {pa.name: pa.to_device(CPU64) for pa in arrays}
    handle = grid.handle_for(None, states)
    bc.bin_cells(grid, states, handle, force=True)
    assert not bool(bc.bin_cells(grid, states, handle))      # kept
    dims = grid.dims
    grid.grow(states.values())
    assert grid.dims == dims and float(handle.width) == 0.0
    assert bool(bc.bin_cells(grid, states, handle))          # rebuilt
    for s in states.values():
        s['x'] = s['x'] * 2.0
    grid.grow(states.values())
    assert grid.dims != dims and not handle.fits(grid, states)
    assert grid.handle_for(handle, states) is not handle


def test_unported_branches_raise():
    """The stratified binning and the mirror boundaries of a domain wait
    for ROADMAP item 27 (the periodic minimum image of the reuse test,
    which raised here, is ported: ``tests/test_torch_domain.py``)."""
    arrays = _arrays(2, 13)
    with pytest.raises(NotImplementedError, match='item 27'):
        CellGrid.from_particles(arrays, dim=2, radius_scale=2.0,
                                stratify=True)
    with pytest.raises(NotImplementedError, match='item 27'):
        DomainManager(xmin=0.0, xmax=1.0, mirror_in_x=True)
