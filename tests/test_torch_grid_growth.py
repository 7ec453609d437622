"""The port's cell grid grows with the particles (on the CPU, float64).

``CellGrid`` is sized at setup from the initial box, padded by ``PAD`` a
side and 3 cells; each binning flags particles at or beyond its far
edge (``CellGrid.overflow``), whom it clamps into the edge cells, and
the solver grows the grid when it reads the flag: with adaptive dt on
the dt's own copy to the host, with a fixed dt every
``GROW_CHECK_STEPS`` steps.

Input: the elliptical drop at nx=20 (1,247 particles) stretched to the
shape it nears by tf (y twice, x half as long), past its initial box.
The grown grid keeps the stencil candidates within 2x of the start and
below the clamped grid's, and one evaluation on it equals the
clamped grid's to 1e-12 of ``max|ref|`` (the same pairs, summed in
another order).
"""

import numpy as np
import pytest
import torch

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.examples.dam_break_2d import DamBreak2D
from pysph_tpu_torch.examples.elliptical_drop import EllipticalDrop
from pysph_tpu_torch.solver import solver as solver_mod
from pysph_tpu_torch.tools_dev import roofline
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

ARGV = ['--nx', '20', '-q', '--use-double', '--device', 'cpu',
        '--disable-output']
EVAL_OUT = ('arho', 'au', 'av', 'ax', 'ay', 'dt_cfl', 'p', 'rho')


def _candidates(grid, states):
    cells = grid.bin_all(states)['fluid']
    return roofline.stencil(grid, cells, cells)[0]


def _stretch(states):
    st = states['fluid']
    st['x'] = st['x'] * 0.5
    st['y'] = st['y'] * 2.0


def test_drop_past_its_box_grows_the_grid():
    app = EllipticalDrop()
    app.setup(ARGV + ['--max-steps', '2'])
    s = app.solver
    dims = s.grid.dims
    assert dims == (12, 12, 1)
    first = _candidates(s.grid, s.states)
    assert not bool(s.grid.overflow)
    _stretch(s.states)
    clamped = _candidates(s.grid, s.states)
    assert bool(s.grid.overflow)
    app.solve()
    assert s.count == 2 and s.grid.grows == 1
    assert s.grid.dims[1] > dims[1]
    last = _candidates(s.grid, s.states)
    assert not bool(s.grid.overflow)
    assert last <= 2 * first and last < clamped


def test_eval_on_the_grown_grid_equals_the_clamped_grid():
    app = EllipticalDrop()
    app.setup(ARGV)
    s = app.solver
    rng = np.random.default_rng(3)
    st = s.states['fluid']
    n = st['x'].shape[0]
    for p in ('u', 'v'):
        st[p] = st[p] + torch.as_tensor(rng.normal(0.0, 10.0, n))
    st['rho'] = torch.as_tensor(1.0 + 1e-3 * rng.normal(size=n))
    _stretch(s.states)
    clamped = CellGrid(s.grid.dim, s.grid.radius_scale, s.grid.dims)
    s.grid.grow(s.states.values())
    assert s.grid.dims != clamped.dims
    a_eval = s.acceleration_evals[0]
    outs = []
    for grid in (clamped, s.grid):
        states = {k: {p: t.clone() for p, t in v.items()}
                  for k, v in s.states.items()}
        a_eval.grid = grid
        a_eval.update_and_compute(0.0, s.dt, states)
        outs.append(states['fluid'])
    got, ref = outs[1], outs[0]
    assert float(ref['au'].abs().max()) > 1e3
    for p in EVAL_OUT:
        scale = float(ref[p].abs().max())
        err = float((got[p] - ref[p]).abs().max())
        assert err <= 1e-12 * scale, (p, err / scale)


@pytest.mark.parametrize('dim', [2, 3])
def test_binning_flags_particles_beyond_the_grid(dim):
    rng = np.random.default_rng(7 + dim)
    n = 300
    xyz = np.zeros((3, n))
    xyz[:dim] = rng.uniform(0.0, 1.0, (dim, n))
    pa = ParticleArray(name='a', x=xyz[0], y=xyz[1], z=xyz[2],
                       h=np.full(n, 0.05))
    grid = CellGrid.from_particles([pa], dim=dim, radius_scale=2.0)
    width = grid.cell_slack * 2.0 * 0.05
    extent = xyz.max(axis=1) - xyz.min(axis=1)
    assert grid.dims == tuple(int(extent[d] * 1.06 / width) + 3 if d < dim
                              else 1 for d in range(3))
    state = pa.to_device(Config(device='cpu', dtype=torch.float64))
    grid.bin_all({'a': state})
    assert not bool(grid.overflow)
    k = int(np.argsort(xyz[0])[n // 2])     # not the lowest on any axis
    for d, c in enumerate('xyz'):
        origin = float(state[c].min())
        for shift, flagged in ((-1e-6, False), (1e-6, True)):
            moved = dict(state)
            moved[c] = state[c].clone()
            moved[c][k] = origin + (grid.dims[d] + shift) * width
            cells = grid.bin_all({'a': moved})['a']
            # an axis of one cell never overflows
            assert bool(grid.overflow) == (flagged and d < dim), (c, shift)
            assert int(cells.cell.max()) < grid.ncells


def _count_reads(monkeypatch):
    """Count the tensor-to-host reads (``tolist``, ``item``, ``float``,
    ``bool``, ``int``) made from Python."""
    reads = []
    for name in ('tolist', 'item', '__float__', '__bool__', '__int__'):
        def read(self, *args, _name=name, _orig=getattr(torch.Tensor, name),
                 **kw):
            reads.append(_name)
            return _orig(self, *args, **kw)
        monkeypatch.setattr(torch.Tensor, name, read)
    return reads


def test_the_step_reads_the_device_once(monkeypatch):
    """With adaptive dt the grid's flag rides on the dt's copy: one read
    a step.  With a fixed dt, one read every ``GROW_CHECK_STEPS``
    steps."""
    app = EllipticalDrop()
    app.setup(ARGV)
    s = app.solver
    assert s.adaptive_timestep
    s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    reads = _count_reads(monkeypatch)
    for count in range(3):
        s.count = count
        dt = s._compute_timestep()
        assert len(reads) == count + 1 and reads[-1] == 'tolist'
        assert isinstance(dt, float) and dt > 0.0
    monkeypatch.undo()

    gtvf = DamBreak2D()
    gtvf.setup(['--scheme', 'gtvf', '--dx', '0.1', '-q', '--device', 'cpu',
                '--use-double', '--disable-output'])
    s = gtvf.solver
    assert not s.adaptive_timestep
    s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    reads = _count_reads(monkeypatch)
    every = solver_mod.GROW_CHECK_STEPS
    for count in range(2 * every + 1):
        s.count = count
        assert s._compute_timestep() == s.dt
    assert len(reads) == 3
