"""The port's TVF wall examples (``examples/poiseuille.py``, ``couette``,
``cavity``, ``rayleigh_taylor``, ``periodic_cylinders``) against
pysph_tpu's, float64 on the CPU, each at its own size (the cavity at
``--nx 12``).

- The plan: under the kernel engine every dest of every example is on a
  kernel: each fluid's density and momentum groups (the no-slip wall
  among the momentum terms) on ``tvf_pair``, linked, the wall's velocity
  and pressure on ``gtvf_pair``; the grid periodic in x where the
  example's domain is.
- Three steps to 1e-9 of ``max|ref|`` from the example's own particles,
  the fluids' positions jittered by a tenth of dx and their densities by
  1% (seeded; the lattice is exact), with a dt that float32 holds
  exactly (the JAX float64 time loop hands a fixed dt over as float32),
  on the kernel engine.

``tests/test_torch_tvf_walls.py`` runs each example for two steps with
dumps, and its ``post_process``.
"""

import importlib
import shutil
import tempfile

import numpy as np
import pytest

from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

STEP_TOL = 1e-9
#: {example: (application class, arguments, the example's wall array)}
EXAMPLES = {
    'poiseuille': ('PoiseuilleFlow', [], 'channel'),
    'couette': ('CouetteFlow', [], 'channel'),
    'cavity': ('LidDrivenCavity', ['--nx', '12'], 'solid'),
    'rayleigh_taylor': ('RayleighTaylor', [], 'solid'),
    'periodic_cylinders': ('PeriodicCylinders', [], 'solid'),
}
PERIODIC_X = ('poiseuille', 'couette', 'periodic_cylinders')
PROPS = {'fluid': ('x', 'y', 'u', 'v', 'p', 'rho', 'V', 'au', 'av'),
         'wall': ('p', 'rho', 'ug', 'vg')}


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


def _cls(package, example):
    mod = importlib.import_module('%s.examples.%s' % (package, example))
    return getattr(mod, EXAMPLES[example][0])


def _port_app(example, argv, engine='kernel'):
    app = _cls('pysph_tpu_torch', example)()
    app.setup(['--use-double', '--device', 'cpu', '--engine', engine, '-q']
              + EXAMPLES[example][1] + argv)
    return app


def _jitter(particles, wall):
    """The fluids' positions moved by up to a tenth of dx, their
    densities by 1% (seeded)."""
    rng = np.random.default_rng(29)
    for pa in particles:
        if pa.name == wall:
            continue
        n = pa.get_number_of_particles()
        dx = float(np.sqrt(pa.properties['m'][0] / pa.properties['rho'][0]))
        for c in ('x', 'y'):
            pa.properties[c][:] += 0.1 * dx * rng.uniform(-1, 1, n)
        pa.properties['rho'][:] *= 1.0 + 0.01 * rng.normal(size=n)


@pytest.mark.parametrize('example', list(EXAMPLES))
def test_every_dest_is_on_a_kernel(example):
    s = _port_app(example, ['--disable-output']).solver
    wall = EXAMPLES[example][2]
    assert s.grid.periodic == (example in PERIODIC_X, False, False)
    a_eval, = s.acceleration_evals
    assert set(a_eval.engine_choices.values()) == {'kernel'}
    plans = [p for p in a_eval._plans.values() if p is not None]
    fluids = sorted(p.dest for p in plans if p.op is tp.tvf_pair)
    assert len(fluids) == 2 * (2 if example == 'rayleigh_taylor' else 1)
    for dest in set(fluids):
        density, momentum = [p for p in plans if p.dest == dest]
        assert density.outputs == ('V', 'rho')
        assert density.link is not None and density.link is momentum.link
        assert [s.name for s in momentum.sources] == \
            [s.name for s in density.sources]
        terms = {s.name: s.terms for s in momentum.sources}
        assert terms[wall] & tp.NOSLIP and terms[wall] & tp.MPG
        assert all(not t & tp.NOSLIP for n, t in terms.items() if n != wall)
    assert [(p.dest, p.op) for p in plans if p.dest == wall] == \
        [(wall, gp.gtvf_pair)] * 2


@pytest.mark.parametrize('example', list(EXAMPLES))
def test_three_steps_match_jax(example):
    wall = EXAMPLES[example][2]
    dt = float(np.float32(_port_app(example,
                                    ['--disable-output']).solver.dt))
    argv = ['--disable-output', '--max-steps', '3', '--dt', repr(dt)]
    tmp = tempfile.mkdtemp()
    try:
        ref = _cls('pysph_tpu', example)()
        ref.setup(['-d', tmp, '-q'] + EXAMPLES[example][1] + argv)
        _jitter(ref.particles, wall)
        ref.solver._sync_to_device()
        inputs = {pa.name: ({k: v.copy() for k, v in pa.properties.items()},
                            {k: v.copy() for k, v in pa.constants.items()},
                            dict(pa.stride)) for pa in ref.particles}
        ref.solve()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    port = _port_app(example, argv)
    s = port.solver
    s.particles = port.particles = [ParticleArray.from_numpy(name, *args)
                                    for name, args in inputs.items()]
    s._sync_to_device()
    port.solve()
    assert s.count == ref.solver.count == 3
    assert abs(s.t - ref.solver.t) <= STEP_TOL * ref.solver.t
    refs = {pa.name: pa for pa in ref.particles}
    checked = 0
    for pa in port.particles:
        want_pa = refs[pa.name]
        n = want_pa.get_number_of_particles()
        for p in PROPS['wall' if pa.name == wall else 'fluid']:
            want = np.asarray(want_pa.properties[p])[:n]
            if np.abs(want).max() == 0.0:
                assert np.abs(pa.properties[p]).max() == 0.0, (pa.name, p)
                continue
            err = _scaled_err(pa.properties[p], want)
            assert err <= STEP_TOL, '%s.%s after 3 steps: %.3g' % (
                pa.name, p, err)
            checked += 1
    assert checked >= 10
