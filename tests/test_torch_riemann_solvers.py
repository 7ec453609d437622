"""The port's Riemann solvers (``sph/gas_dynamics/riemann_solver.py``)
against pysph_tpu's, float64 on the CPU, inputs seeded with numpy.

- each of the eleven solvers against the JAX solver of the same id on
  Toro's four problems (as ``tests/test_riemann_solvers.py`` sets them)
  and on 1,000 seeded states (densities and pressures log-uniform over
  three decades, velocities up to +-3 and counter-flowing), within
  1e-12 of each value (NaN where JAX gives NaN);
- the published star states of the four problems at the graded
  tolerances of ``tests/test_riemann_solvers.py``;
- ``riemann_solve``'s dispatch, a fixed trip count (``niter``), and an
  unknown id refused.

``tests/test_torch_gsph_cuda.py`` holds the device solvers of
``csrc/riemann.cuh`` to these on the card.
"""

import numpy as np
import pytest
import torch

import pysph_tpu.sph.gas_dynamics.riemann_solver as JR
import pysph_tpu_torch.sph.gas_dynamics.riemann_solver as R
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = 1e-12
IDS = sorted(R.SOLVERS)
NAMES = [R.SOLVERS[k].__name__ for k in IDS]

#: Toro's problems: (rhol, pl, ul, rhor, pr, ur) and the star (pm, um)
TORO = {
    'sod': ((1.0, 1.0, 0.0, 0.125, 0.1, 0.0), (0.30313, 0.92745)),
    'blastwave': ((1.0, 1000.0, 0.0, 1.0, 0.01, 0.0), (460.894, 19.5975)),
    'sjogreen': ((1.0, 0.4, -2.0, 1.0, 0.4, 2.0), (0.0018938, 0.0)),
    'woodward_colella': ((1.0, 0.01, 0.0, 1.0, 100.0, 0.0),
                         (46.0950, -6.19633)),
}


def random_states(n=1000, seed=11):
    """(rhol, rhor, pl, pr, ul, ur) as float64 arrays: densities and
    pressures log-uniform over [0.01, 10] and [0.01, 100], velocities
    uniform in [-3, 3]."""
    rng = np.random.default_rng(seed)
    rho = 10.0 ** rng.uniform(-2, 1, (2, n))
    p = 10.0 ** rng.uniform(-2, 2, (2, n))
    u = rng.uniform(-3, 3, (2, n))
    return rho[0], rho[1], p[0], p[1], u[0], u[1]


def toro_states():
    """The four problems as arrays in the solvers' argument order."""
    rows = np.array([s for s, _ in TORO.values()])
    rhol, pl, ul, rhor, pr, ur = rows.T
    return rhol, rhor, pl, pr, ul, ur


def _solve(method, states, gamma=1.4, niter=20):
    got = R.riemann_solve(method, *[torch.as_tensor(s) for s in states],
                          gamma, niter)
    want = JR.riemann_solve(method, *states, gamma, niter)
    return ([g.numpy() for g in got], [np.asarray(w) for w in want])


def _close(got, want, label):
    for g, w, what in zip(got, want, ('pstar', 'ustar')):
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan, '%s %s: NaN'
                                      % (label, what))
        err = np.abs(g[~nan] - w[~nan])
        bad = ~(err <= TOL * np.maximum(np.abs(w[~nan]), 1e-300))
        assert not bad.any(), '%s %s: %d values apart, worst %.3g' % (
            label, what, int(bad.sum()),
            float((err / np.maximum(np.abs(w[~nan]), 1e-300)).max()))


@pytest.mark.parametrize('method', IDS, ids=NAMES)
@pytest.mark.parametrize('gamma', [1.4, 1.5])
def test_solver_matches_jax(method, gamma):
    for label, states in (('toro', toro_states()),
                          ('random', random_states())):
        got, want = _solve(method, states, gamma)
        _close(got, want, '%s %s gamma %g' % (NAMES[method], label, gamma))


@pytest.mark.parametrize('method', [1, 2], ids=['van_leer', 'exact'])
@pytest.mark.parametrize('niter', [0, 1, 5, 40])
def test_iterative_solvers_run_niter_trips(method, niter):
    got, want = _solve(method, random_states(200, seed=3), niter=niter)
    _close(got, want, '%s niter %d' % (NAMES[method], niter))


def _star(solver, problem):
    (rhol, pl, ul, rhor, pr, ur), _ = TORO[problem]
    pm, um = solver(*[torch.tensor(v, dtype=torch.float64)
                      for v in (rhol, rhor, pl, pr, ul, ur)], 1.4, 20, 1e-6)
    return float(pm), float(um)


def test_exact_star_states():
    for problem, rel, absolute in (('sod', 1e-4, None),
                                   ('blastwave', 1e-3, None),
                                   ('sjogreen', None, 1e-4),
                                   ('woodward_colella', 1e-4, None)):
        pm, um = _star(R.exact, problem)
        want = TORO[problem][1]
        assert pm == pytest.approx(want[0], rel=rel, abs=absolute)
        assert um == pytest.approx(want[1], rel=rel, abs=absolute)


def test_van_leer_and_ducowicz_star_states():
    for problem in ('sod', 'blastwave', 'woodward_colella'):
        pm, um = _star(R.van_leer, problem)
        assert pm == pytest.approx(TORO[problem][1][0], rel=1e-2)
        assert um == pytest.approx(TORO[problem][1][1], rel=1e-2)
    for problem in ('sod', 'woodward_colella'):
        pm, um = _star(R.ducowicz, problem)
        rel = 0.2 if problem == 'sod' else 0.4
        assert pm == pytest.approx(TORO[problem][1][0], rel=rel)
        assert um == pytest.approx(TORO[problem][1][1], rel=rel)


@pytest.mark.parametrize('method', IDS[1:], ids=NAMES[1:])
def test_every_solver_gives_a_usable_sod_state(method):
    solver = R.SOLVERS[method]
    rel = 2.0 if solver.__name__ in ('roe', 'hllc') else 1.0
    pm, um = _star(solver, 'sod')
    assert np.isfinite(pm) and np.isfinite(um)
    assert pm == pytest.approx(0.30313, rel=rel)
    assert um == pytest.approx(0.92745, rel=rel)


def test_dispatch_takes_floats_and_refuses_an_unknown_id():
    pm, um = R.riemann_solve(1, 1.0, 0.125, 1.0, 0.1, 0.0, 0.0)
    assert pm.dtype == torch.float64 and np.isfinite(float(pm))
    x = torch.tensor([1.0, 2.0], dtype=torch.float32)
    pm, _ = R.riemann_solve(7, x, 1.0, x, 0.5, 0.0, 0.0)
    assert pm.dtype == torch.float32 and pm.shape == (2,)
    with pytest.raises(ValueError, match='no Riemann solver 11'):
        R.riemann_solve(11, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0)
    assert [s.__name__ for s in R.HELPERS] == [s.__name__
                                              for s in JR.HELPERS]
