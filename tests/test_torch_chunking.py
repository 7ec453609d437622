"""The solver's K-step chunk against its per-step loop (CPU, float64).

Port of ``tests/test_solver_chunking.py``, at a tighter bar: the JAX
chunk carries time in float32 and holds to 1e-5, the port's carries t
and dt in float64 on the device and takes the per-step loop's decisions
in the same arithmetic.  Each case runs ``chunk_steps = 4`` against
``chunk_steps = 1`` from the same setup: every state prop within 1e-12
of its max (the cases below reach 0), ``t``, ``dt``, ``count`` and the
binnings that ran (the reuse test decides them on the device) exact,
and the same dumps (count and t).  On the CPU a chunk runs eagerly; the
card replays it from a CUDA graph (``tests/test_torch_capture_cuda.py``).

The integrators of one and four evaluations a step run in chunks too
(dam_break_2d ``--scheme wcsph`` under PEC and under PEFRL), and so does
the torch pair engine (dam_break_3d ``--engine dense --delta-sph``, whose
delta-SPH groups it takes): a capacity too small from the start is grown
and the chunk or step redone, to the same bits as an ample one.
"""

import logging

import pytest
import torch

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.examples.dam_break_2d import DamBreak2D
from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
from pysph_tpu_torch.examples.elliptical_drop import EllipticalDrop
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401
from pysph_tpu_torch.tools_dev.time_chunks import integrated

K = 4
CPU = ['--use-double', '--device', 'cpu', '-q']
#: the drop's first dt at nx=20 with n_damp = 0 is ~1.38e-5 s
DROP_OUT = 1.3e-4
DROP = ['--nx', '20', '--max-steps', '23', '--pfreq', '7']


def _drop_adaptive(s):
    s.n_damp = 0
    s.set_output_at_times([DROP_OUT, 1.0])


def _drop_tight_grid(s):
    """The drop spreading ten times faster in a grid that just holds it:
    a binning overflows after a few steps, inside a chunk."""
    s.n_damp = 0
    st = s.states['fluid']
    st['u'] = st['u'] * 10.0
    st['v'] = st['v'] * 10.0
    width = s.grid.cell_slack * s.grid.radius_scale * float(
        st['h'].max())
    s.grid._set_dims([int(float(st[c].max() - st[c].min()) // width) + 1
                      for c in 'xy'] + [1])


def _db3d_damped(s):
    s.n_damp = 4


CASES = {
    # adaptive dt, a pfreq boundary, a landing on an output time inside a
    # chunk and max_steps inside a chunk
    'drop': (EllipticalDrop, DROP, _drop_adaptive),
    # the fixed dt and the two evaluators of GTVF
    'gtvf': (DamBreak2D, ['--scheme', 'gtvf', '--dx', '0.1',
                          '--max-steps', '13'], None),
    # chunks from count = n_damp on
    'dam_break_3d': (DamBreak3D, ['--dx', '0.12', '--max-steps', '9'],
                     _db3d_damped),
    # one evaluation a step (PEC, the WCSPH dam break's default), and four
    'pec': (DamBreak2D, ['--dx', '0.1', '--max-steps', '11'],
            _db3d_damped),
    'pefrl': (integrated('PEFRLIntegrator'), ['--dx', '0.1',
                                              '--max-steps', '9'],
              _db3d_damped),
    # the delta-SPH groups on the torch pair engine, at capacities
    'torch_engine': (DamBreak3D, ['--dx', '0.12', '--max-steps', '9',
                                  '--engine', 'dense', '--delta-sph'],
                     _db3d_damped),
    # the grid grows after a chunk that a binning's overflow ended
    'grow': (EllipticalDrop, ['--nx', '20', '--max-steps', '20',
                              '--disable-output'], _drop_tight_grid),
}


def _run(case, chunk_steps, out_dir, callback=None):
    """Solve a case; returns (solver, [(count, t) of each dump],
    [(count before, count after) of each chunk])."""
    cls, argv, prepare = CASES[case]
    app = cls()
    app.setup(CPU + ['-d', str(out_dir)] + argv)
    # -q quietened the package's log, which the solver's reasons use
    logging.getLogger('pysph_tpu_torch').setLevel(logging.INFO)
    s = app.solver
    s.chunk_steps = chunk_steps
    if prepare is not None:
        prepare(s)
    if callback is not None:
        s.add_pre_step_callback(callback)
    dumps, chunks = [], []
    dump, run_chunk = s.dump_output, s._run_chunk

    def record_dump():
        dumps.append((s.count, s.t))
        dump()

    def record_chunk():
        before = s.count
        run_chunk()
        chunks.append((before, s.count))

    s.dump_output, s._run_chunk = record_dump, record_chunk
    app.solve()
    return s, dumps, chunks


def _assert_same(got, want):
    assert got.count == want.count
    assert got.t == want.t and got.dt == want.dt
    assert got.grid.grows == want.grid.grows
    # the same binnings ran: no inactive step of a chunk re-bins
    assert got.rebuilds == want.rebuilds > 0
    for name, ref in want.states.items():
        for p, v in ref.items():
            mine = got.states[name][p]
            fin = torch.isfinite(v)
            assert torch.equal(torch.isfinite(mine), fin), (name, p)
            assert torch.equal(mine[~fin], v[~fin]), (name, p)
            if fin.any():
                scale = float(v[fin].abs().max())
                err = float((mine[fin] - v[fin]).abs().max())
                assert err <= 1e-12 * scale, (name, p, err / scale)


@pytest.mark.parametrize('case', sorted(CASES))
def test_chunks_equal_the_per_step_loop(case, tmp_path):
    got, got_dumps, chunks = _run(case, K, tmp_path / 'chunked')
    want, want_dumps, none = _run(case, 1, tmp_path / 'per_step')
    _assert_same(got, want)
    assert got_dumps == want_dumps
    assert chunks and not none
    if case == 'torch_engine':
        a_eval = got.acceleration_evals[0]
        assert 'torch' in a_eval.engine_choices.values()
        assert got.grid.pair_caps and got.redos == want.redos == 0
    # every step from n_damp on ran in a chunk, none longer than K
    assert all(0 < b - a <= K for a, b in chunks)
    assert sum(b - a for a, b in chunks) == got.count - want.n_damp
    assert chunks[0][0] == want.n_damp
    if case == 'drop':
        # pfreq = 7 and max_steps = 23 end chunks; the landing on
        # DROP_OUT was decided and stepped inside a chunk, which ended
        # there
        land = _landing(got_dumps)
        assert land % 7 and any(a < land - 1 and b == land
                                for a, b in chunks)
        assert got.count == 23 and (21, 23) in chunks
    if case == 'grow':
        # one chunk ended early, after the step whose binning overflowed
        assert got.grid.grows == 1
        short = [(a, b) for a, b in chunks if b - a < K and b != 20]
        assert len(short) == 1, chunks


def _landing(dumps):
    """The count of the dump at ``DROP_OUT``."""
    hits = [c for c, t in dumps if abs(t - DROP_OUT) < 1e-12]
    assert len(hits) == 1, dumps
    return hits[0]


def _count_reads(monkeypatch):
    """Count the tensor-to-host reads (``tolist``, ``item``, ``float``,
    ``bool``, ``int``) made from Python, but for those of the exact pair
    lists (``neighbor_pairs`` without a capacity), which the kernels'
    plain versions, on the CPU, size on the host (the card's kernels do
    not).  The torch engine's lists, at capacities, count."""
    reads, inside = [], []
    for name in ('tolist', 'item', '__float__', '__bool__', '__int__'):
        def read(self, *args, _name=name, _orig=getattr(torch.Tensor, name),
                 **kw):
            if not any(inside):
                reads.append(_name)
            return _orig(self, *args, **kw)
        monkeypatch.setattr(torch.Tensor, name, read)
    pairs = CellGrid.neighbor_pairs

    def neighbor_pairs(self, *args):
        exact = len(args) < 6 or args[5] is None
        inside.append(exact)
        try:
            return pairs(self, *args)
        finally:
            inside.pop()

    monkeypatch.setattr(CellGrid, 'neighbor_pairs', neighbor_pairs)
    return reads


@pytest.mark.parametrize('case', ['drop', 'gtvf', 'grow', 'torch_engine'])
def test_a_chunk_reads_the_device_once(case, monkeypatch, tmp_path):
    """One ``tolist`` a chunk and no other read; a grow reads the box
    once more.  The per-step loop reads once a step with adaptive dt
    (``tests/test_torch_grid_growth.py``)."""
    cls, argv, prepare = CASES[case]
    app = cls()
    app.setup(CPU + ['--disable-output'] + argv)
    s = app.solver
    s.chunk_steps = K
    if prepare is not None:
        prepare(s)
    s.n_damp = 0
    s.integrator.initial_acceleration(s.states, s.t, s.dt)
    s.dt = s._get_timestep()
    reads, before_loop = _count_reads(monkeypatch), s.reads
    per_chunk = []
    while s.count < s.max_steps and s._chunk_eligible():
        before, grows = len(reads), s.grid.grows
        s._run_chunk()
        per_chunk.append(len(reads) - before - (s.grid.grows - grows))
    assert per_chunk and set(per_chunk) == {1}
    assert set(reads) == {'tolist'}
    assert s.reads - before_loop == len(reads)


def test_ineligible_steps_run_per_step(tmp_path, caplog):
    """A pre-step callback makes every step a per-step one, and so do the
    damped steps (``count < n_damp``); each reason is logged once."""
    calls = []
    got, _, chunks = _run('dam_break_3d', K, tmp_path / 'cb',
                          callback=lambda s: calls.append(s.count))
    said = [r.getMessage() for r in caplog.records
            if 'per-step loop' in r.getMessage()]
    assert said == ['step 0: per-step loop: damped steps (count < n_damp)',
                    'step 4: per-step loop: a pre-step callback']
    want, _, _ = _run('dam_break_3d', 1, tmp_path / 'loop')
    _assert_same(got, want)
    assert chunks == [] and calls == list(range(9))


def _shrink(s, factor, when):
    """Scale every torch engine capacity by ``factor`` after the initial
    eval (``when = 'start'``) or before the first chunk (``'chunk'``)."""
    def scale():
        for cap in s.grid.pair_caps.values():
            cap.candidates = int(cap.candidates * factor)
            cap.pairs = int(cap.pairs * factor)

    if when == 'start':
        initial = s.integrator.initial_acceleration

        def then_scale(*args):
            initial(*args)
            scale()
        s.integrator.initial_acceleration = then_scale
    else:
        run_chunk = s._run_chunk

        def first_scaled():
            if s.count == s.n_damp and not s.redos:
                scale()
            run_chunk()
        s._run_chunk = first_scaled


def _capacity_run(tmp_path, factor, when):
    cls, argv, prepare = CASES['torch_engine']
    app = cls()
    app.setup(CPU + ['-d', str(tmp_path), '--disable-output'] + argv)
    s = app.solver
    s.chunk_steps = K
    prepare(s)
    _shrink(s, factor, when)
    app.solve()
    return s


@pytest.mark.parametrize('when', ['start', 'chunk'])
def test_a_small_capacity_is_grown_and_redone(when, tmp_path):
    """Capacities cut to a fifth (after the initial eval, so a damped
    step of the per-step loop overflows first; or before the first
    chunk): the step or chunk is redone from the state before it, with
    the capacities grown, to the same bits, t, dt, count and binnings as
    capacities four times too large."""
    got = _capacity_run(tmp_path / 'small', 0.2, when)
    want = _capacity_run(tmp_path / 'ample', 4.0, when)
    assert got.redos >= 1 and want.redos == 0
    assert got.count == want.count == 9
    assert (got.t, got.dt, got.rebuilds) == (want.t, want.dt, want.rebuilds)
    for name, ref in want.states.items():
        for p, v in ref.items():
            assert torch.equal(got.states[name][p], v), (name, p)
