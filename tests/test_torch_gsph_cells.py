"""GSPH's binnings and its linked pair on the CPU (float64): each binning
that an evaluator keeps has periodic counts fitted to its own h
(``base/cell_grid.py``, ``sph/acceleration_eval.py::Binning``), so that
the scaled density, the second density, the gradients and the
acceleration of ``accuracy_test_2d --scheme gsph`` each walk cells that
fit their h and still sum every pair in support (held to a run on one
periodic cell a side, where every particle is a candidate: the
minimum-image all-pairs sums); a binning whose h falls to half its cells
is sized down at a multiple of ``solver.RESIZE_STEPS``, with no redo, in
chunks as in the per-step loop, bit for bit; and ``link_pairs`` links
GSPH's gradients plan to its acceleration plan, but not across a group
that writes h.  The JAX package keeps its setup's cells (ROADMAP Queue
3), so these hold the port to all-pairs sums, not to it.
"""

import logging

import numpy as np
import pytest
import torch

from pysph_tpu_torch.examples.gas_dynamics.accuracy_test_2d import (
    AccuracyTest2D)
from pysph_tpu_torch.ops import gsph_pair as gs
from pysph_tpu_torch.solver.solver import RESIZE_STEPS
from pysph_tpu_torch.sph.acceleration_eval import AccelerationEval
from pysph_tpu_torch.sph.equation import Group
from pysph_tpu_torch.sph.gas_dynamics.basic import (
    UpdateSmoothingLengthFromVolume)
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

#: the props the evaluation writes: h and rho (both densities), the
#: gradients and the acceleration
PROPS = ('h', 'rho', 'p', 'px', 'py', 'ux', 'uy', 'vx', 'vy', 'au', 'av',
         'ae')


def _accuracy(n, steps=0, all_pairs=False, chunk_steps=10):
    """``accuracy_test_2d --scheme gsph`` at n^2, float64, its positions
    moved by up to a tenth of the spacing (seeded); ``all_pairs``: every
    binning on one periodic cell a side, never sized down."""
    app = AccuracyTest2D()
    argv = ['--use-double', '--device', 'cpu', '--disable-output', '-q',
            '--nparticles', str(n)]
    if steps:
        argv += ['--max-steps', str(steps)]
    app.setup(argv)
    s = app.solver
    s.chunk_steps = chunk_steps
    rng = np.random.default_rng(5)
    fluid = s.states['fluid']
    for c in 'xy':
        fluid[c] = fluid[c] + 0.1 / n * torch.as_tensor(
            rng.uniform(-1, 1, fluid[c].shape[0]))
    if all_pairs:
        s.grid._set_dims((1, 1, 1))
        s.grid.oversized = lambda width: False
    return app


def _scaled_err(got, want):
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                1e-300))


def _fits(b, grid):
    """The binning ``b``'s width (its handle's, the support of the h it
    last binned) and the least periodic cell of its counts."""
    return (float(b.handle.width),
            b.cells(grid).box_host(torch.float64)['stale'])


def test_each_binning_fits_its_own_h_and_sees_every_pair():
    fitted, every = _accuracy(24), _accuracy(24, all_pairs=True)
    for app in (fitted, every):
        s = app.solver
        s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    s = fitted.solver
    a_eval, = s.acceleration_evals
    names = [b.name for b in a_eval.kept_binnings()]
    assert names == ['step', 'group 0', 'group 2']
    # the scaled h outgrew the setup's cells once; the h from the volume
    # fits half of them: sized down after the evaluation
    assert s.grid.grows == 1 and s.grid.shrinks >= 1
    dims = {}
    for b in a_eval.kept_binnings():
        w, cell = _fits(b, s.grid)
        assert w <= cell < 2 * w, (b.name, w, cell)
        dims[b.name] = b.cells(s.grid).dims
    # the scaled h (twice the volume's) bins on fewer, wider cells
    assert dims['group 0'][0] < dims['group 2'][0]
    for p in PROPS:
        err = _scaled_err(fitted.solver.states['fluid'][p],
                          every.solver.states['fluid'][p])
        assert err <= 1e-12, (p, err)
    # steps on the fitted cells: every evaluation still sums every pair
    for app in (fitted, every):
        app.solver.max_steps = 12
        app.solve()
    assert fitted.solver.redos == 0
    for b in a_eval.kept_binnings():
        w, cell = _fits(b, s.grid)
        assert b.handle.dims == b.cells(s.grid).dims
        assert w <= cell < 2 * w, (b.name, w, cell)
    for p in PROPS + ('x', 'y', 'u', 'v', 'e'):
        err = _scaled_err(fitted.solver.states['fluid'][p],
                          every.solver.states['fluid'][p])
        assert err <= 1e-12, (p, err)


def test_a_shrinking_h_is_sized_down_at_a_boundary_as_per_step():
    """The scaled h halves after the first evaluation (twice the setup's
    h there, twice the volume's after): its binning, sized for the first,
    is sized down at step ``RESIZE_STEPS`` with no redo, in chunks of 4
    (which end there) as in the per-step loop, which give the same
    bits."""
    def scaled(app):
        a_eval, = app.solver.acceleration_evals
        return a_eval.binning(a_eval.groups[0])

    # before the boundary the scaled h's binning keeps the cells of the
    # first evaluation's h, twice as wide as it needs
    early = _accuracy(16, steps=RESIZE_STEPS - 1, chunk_steps=1)
    early.solve()
    w, cell = _fits(scaled(early), early.solver.grid)
    assert cell >= 2 * w
    runs = {}
    for k in (4, 1):
        app = _accuracy(16, steps=RESIZE_STEPS + 4, chunk_steps=k)
        app.solve()
        s = app.solver
        late = scaled(app).cells(s.grid).dims
        assert late[0] > scaled(early).cells(early.solver.grid).dims[0]
        w, cell = _fits(scaled(app), s.grid)
        assert w <= cell < 2 * w
        assert s.count == RESIZE_STEPS + 4 and s.redos == 0
        assert s.grid.grows == 1
        runs[k] = s
    a, b = runs[4], runs[1]
    assert a.replays == 0 and a.grid.shrinks == b.grid.shrinks >= 1
    differ = [p for p, v in b.states['fluid'].items()
              if not torch.equal(v, a.states['fluid'][p])]
    assert not differ
    assert a.t == b.t and a.dt == b.dt


def _linked(groups, caplog):
    app = AccuracyTest2D()
    app.setup(['--use-double', '--device', 'cpu', '--disable-output', '-q',
               '--nparticles', '8'])
    s = app.solver
    with caplog.at_level(logging.INFO, logger='pysph_tpu_torch'):
        a_eval = AccelerationEval(app.particles, groups, s.kernel, s.config,
                                  s.grid)
    return [p for g in a_eval.leaf_groups()
            for p in [a_eval._plans.get((id(g), 'fluid'))]
            if p is not None and p.op is gs.gsph_pair]


def test_link_pairs_links_the_gradients_to_the_acceleration(caplog):
    app = AccuracyTest2D()
    app.setup(['--use-double', '--device', 'cpu', '--disable-output', '-q',
               '--nparticles', '8'])
    groups = app.scheme.get_equations()
    grads, acc = _linked(groups, caplog)
    assert grads.link is acc.link is not None
    assert grads.link.emitter is grads and grads.link.consumer is acc
    # a group between them that writes h: no link, and the log says why
    caplog.clear()
    k = next(i for i, g in enumerate(groups)
             if any(type(eq).__name__ == 'GSPHAcceleration'
                    for eq in g.equations))
    groups.insert(k, Group(equations=[UpdateSmoothingLengthFromVolume(
        dest='fluid', sources=None, k=1.0, dim=2)]))
    grads, acc = _linked(groups, caplog)
    assert grads.link is None and acc.link is None
    assert 'gsph_pair for fluid: no link: UpdateSmoothingLengthFromVolume ' \
        'is not among the equations that keep the pairs' in caplog.text


@pytest.mark.parametrize('emit', [True, False])
def test_the_plain_version_takes_the_link_on_the_cpu(emit):
    """On CPU tensors an emitting gradients call returns an empty
    hand-off and the acceleration call on it walks: the plain version;
    an acceleration call refuses to emit, a gradients call a hand-off."""
    app = _accuracy(8)
    s = app.solver
    s.integrator.initial_acceleration(s.states, 0.0, s.dt)
    from pysph_tpu_torch.tools_dev.time_walks import plan_calls
    calls = [c for c in plan_calls(s, [0]) if c[2].op is gs.gsph_pair]
    (_, _, gplan, gargs), (_, _, aplan, aargs) = calls
    walked = gs.gsph_pair(*aargs)
    out, handoff = gs.gsph_pair(*gargs, emit=True)
    assert handoff.count is None and handoff.nbr.shape[0] == 0
    got = gs.gsph_pair(*aargs, handoff=handoff)
    for p in aplan.outputs:
        assert torch.equal(got[p], walked[p])
    with pytest.raises(ValueError, match='only a gradients call emits'):
        gs.gsph_pair(*aargs, emit=True)
    with pytest.raises(ValueError, match='only an acceleration call'):
        gs.gsph_pair(*gargs, handoff=handoff)
