"""The port's integrators (float64, on the CPU): the convergence orders of
``tests/test_integrator.py`` on its harmonic oscillator (Euler first
order; PEC, EPEC and LeapFrog second; PEFRL fourth; and TVDRK3, which
that file lacks, third), and each
integrator's state after 5 steps against ``pysph_tpu``'s from the same
inputs, to 1e-12 of each prop's max.

The force is the oscillator's ``au = -x`` with the XSPH velocity
``ax = u`` (``HarmonicForce``) or, for the steps that carry only the XSPH
correction in ``ax`` (LeapFrog, PEFRL), ``ax = 0`` (``XSPHZero``); the
5-step comparison also gives ``arho`` and ``ae`` values, so that every
prop a step advances moves.
"""

import jax
import numpy as np
import pytest
import torch

from pysph_tpu.base.cell_grid import GridSpec
from pysph_tpu.base.kernels import CubicSpline as JaxCubicSpline
from pysph_tpu.base.utils import get_particle_array_wcsph as jax_wcsph_array
from pysph_tpu.sph import integrator as jax_integrator
from pysph_tpu.sph import integrator_step as jax_steps
from pysph_tpu.sph.acceleration_eval import AccelerationEval as JaxEval
from pysph_tpu.sph.equation import Equation as JaxEquation
from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.kernels import CubicSpline
from pysph_tpu_torch.base.utils import get_particle_array_wcsph
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.sph import integrator
from pysph_tpu_torch.sph import integrator_step as steps
from pysph_tpu_torch.sph.acceleration_eval import AccelerationEval
from pysph_tpu_torch.sph.equation import Equation

CPU = Config(device='cpu', dtype=torch.float64)
PROPS = ('x', 'y', 'u', 'v', 'rho', 'e')


def _force(xsph):
    def initialize(self, d_idx, d_au, d_av, d_aw, d_ax, d_ay, d_az,
                   d_arho, d_ae, d_x, d_y, d_u, d_v):
        d_au[d_idx] = -d_x[d_idx]
        d_av[d_idx] = -2.0 * d_y[d_idx]
        d_aw[d_idx] = 0.0
        d_ax[d_idx] = d_u[d_idx] * xsph
        d_ay[d_idx] = d_v[d_idx] * xsph
        d_az[d_idx] = 0.0
        d_arho[d_idx] = -0.1 * d_u[d_idx]
        d_ae[d_idx] = d_x[d_idx] * d_u[d_idx]
    return initialize


def _equations(base):
    return {name: type(name, (base,), {'initialize': _force(xsph)})
            for name, xsph in (('HarmonicForce', 1.0), ('XSPHZero', 0.0))}


EQUATIONS = _equations(Equation)
JAX_EQUATIONS = _equations(JaxEquation)

#: {integrator: (step class, equation)}
SCHEMES = {
    'EulerIntegrator': ('EulerStep', 'HarmonicForce'),
    'PECIntegrator': ('WCSPHStep', 'HarmonicForce'),
    'EPECIntegrator': ('WCSPHStep', 'HarmonicForce'),
    'TVDRK3Integrator': ('WCSPHTVDRK3Step', 'HarmonicForce'),
    'LeapFrogIntegrator': ('LeapFrogStep', 'XSPHZero'),
    'PEFRLIntegrator': ('PEFRLStep', 'XSPHZero'),
}

INPUTS = dict(x=[1.0, 0.5, -0.3], y=[0.0, 0.4, -0.2], u=[0.0, 0.2, 0.1],
              v=[0.1, 0.0, -0.3], h=[1.0] * 3, m=[1.0] * 3,
              rho=[1.0, 1.1, 0.9])


def _array(factory, n):
    kw = {k: v[:n] for k, v in INPUTS.items()}
    pa = factory(name='fluid', **kw)
    pa.add_property('ae')
    pa.add_property('e')
    return pa


def _port_run(name, dt, steps_, n=3):
    """The port's integrator ``name`` on the oscillator for ``steps_``
    steps of ``dt``; returns ({prop: ndarray}, t)."""
    step_cls, eq = SCHEMES[name]
    pa = _array(get_particle_array_wcsph, n)
    grid = CellGrid.from_particles([pa], dim=1, radius_scale=2.0)
    a_eval = AccelerationEval([pa], [EQUATIONS[eq]('fluid', None)],
                              CubicSpline(dim=1), CPU, grid)
    integ = getattr(integrator, name)(fluid=getattr(steps, step_cls)())
    integ.set_acceleration_evals([a_eval])
    states = {'fluid': pa.to_device(CPU)}
    integ.initial_acceleration(states, 0.0, dt)
    t = 0.0
    for _ in range(steps_):
        integ.step(states, t, dt)
        t += dt
    return {p: states['fluid'][p].numpy() for p in PROPS}, t


def _jax_run(name, dt, steps_, n=3):
    step_cls, eq = SCHEMES[name]
    pa = _array(jax_wcsph_array, n)
    a_eval = JaxEval([pa], [JAX_EQUATIONS[eq]('fluid', None)],
                     JaxCubicSpline(dim=1))
    integ = getattr(jax_integrator, name)(
        fluid=getattr(jax_steps, step_cls)())
    integ.set_acceleration_evals([a_eval])
    integ.set_nnps(GridSpec.from_particles([pa], dim=1, radius_scale=2.0))
    states = {'fluid': pa.to_device()[0]}
    states, _, carry = integ.initial_acceleration(states, 0.0, dt)

    @jax.jit
    def step(states, t, carry):
        s, _, carry = integ.step(states, t, dt, carry)
        return s, carry

    t = 0.0
    for _ in range(steps_):
        states, carry = step(states, t, carry)
        t += dt
    return {p: np.asarray(states['fluid'][p])[:n] for p in PROPS}, t


def _error(name, dt, tf=1.0):
    out, t = _port_run(name, dt, int(round(tf / dt)), n=1)
    return abs(out['x'][0] - np.cos(t))


@pytest.mark.parametrize('name,dt,low,high', [
    ('EulerIntegrator', 0.02, 1.5, 2.8),
    ('PECIntegrator', 0.02, 2.5, 6.0),
    ('EPECIntegrator', 0.02, 3.0, 5.0),
    ('LeapFrogIntegrator', 0.02, 3.0, 5.0),
    ('PEFRLIntegrator', 0.05, 10.0, 24.0),
    ('TVDRK3Integrator', 0.02, 6.0, 10.0),
])
def test_convergence_order(name, dt, low, high):
    """The error ratio of dt and dt/2 at t = 1, within the bounds of
    ``tests/test_integrator.py`` (TVDRK3's: about 2^3)."""
    ratio = _error(name, dt) / _error(name, dt / 2)
    assert low < ratio < high, ratio


@pytest.mark.parametrize('name', sorted(SCHEMES))
def test_five_steps_match_jax(name):
    dt = 0.05
    got, t = _port_run(name, dt, 5)
    want, t_ref = _jax_run(name, dt, 5)
    assert t == t_ref
    for p in PROPS:
        scale = np.abs(want[p]).max()
        if scale == 0.0:      # a prop the step does not advance
            assert np.abs(got[p]).max() == 0.0, (name, p)
            continue
        err = np.abs(got[p] - want[p]).max() / scale
        assert err <= 1e-12, '%s %s: scaled error %.3g' % (name, p, err)
    # the step moved every prop it advances
    moved = {p for p in PROPS if not np.array_equal(
        want[p], np.asarray(INPUTS.get(p, [0.0] * 3)))}
    assert {'x', 'u'} <= moved, moved


def test_post_stage_callback_fractions():
    """``do_post_stage`` calls the callback with the reference's
    fractions of dt after each stage (PEFRL: five)."""
    calls = []
    pa = _array(get_particle_array_wcsph, 3)
    grid = CellGrid.from_particles([pa], dim=1, radius_scale=2.0)
    a_eval = AccelerationEval([pa], [EQUATIONS['XSPHZero']('fluid', None)],
                              CubicSpline(dim=1), CPU, grid)
    integ = integrator.PEFRLIntegrator(fluid=steps.PEFRLStep())
    integ.set_acceleration_evals([a_eval])
    integ.set_post_stage_callback(lambda t, dt, stage: calls.append(
        (t, dt, stage)))
    states = {'fluid': pa.to_device(CPU)}
    integ.initial_acceleration(states, 0.0, 0.1)
    integ.step(states, 1.0, 0.1)
    assert [c[2] for c in calls] == [1, 2, 3, 4, 5]
    assert all(c[1] == 0.1 for c in calls)
    np.testing.assert_allclose(
        [c[0] for c in calls],
        [1.0 + 0.1 * f for f in (0.1786178958448091, 0.1123533131749906,
                                 0.8876466868250094, 0.8213821041551909,
                                 1.0)], rtol=0, atol=1e-15)
