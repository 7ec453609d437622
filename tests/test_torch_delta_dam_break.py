"""dam_break_3d ``--delta-sph`` (the BASELINE dam break) against pysph_tpu:
dx=0.12 (1,960 particles) for three steps in float64 on the CPU, every
prop to 1e-9 of max|ref|, ``m_mat`` and ``gradrho`` included.

The reference builds ``GradientCorrection`` without ``dim``, so in 3D it
corrects two components of the gradient (``pysph_tpu/sph/scheme.py:402``);
the port reproduces that, and the same run with the correction in three
dimensions must miss the bar.
"""

import shutil
import tempfile

import numpy as np
import pytest

from pysph_tpu.examples.dam_break_3d import DamBreak3D as JaxDamBreak3D
from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
from pysph_tpu_torch.sph.wc import kernel_correction
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

ARGV = ['--dx', '0.12', '--max-steps', '3', '--disable-output', '-q',
        '--delta-sph']
PROPS = ('x', 'y', 'z', 'u', 'v', 'w', 'rho', 'p', 'arho', 'm_mat',
         'gradrho')
TOL = 1e-9


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


@pytest.fixture(scope='module')
def jax_run():
    tmp = tempfile.mkdtemp()
    try:
        ref = JaxDamBreak3D()
        ref.run(['-d', tmp] + ARGV)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ref


def _errors(port, ref):
    """{(array, prop): scaled error} of the port's final state."""
    ref_arrays = {pa.name: pa for pa in ref.particles}
    errs = {}
    for pa in port.particles:
        rpa = ref_arrays[pa.name]
        n = rpa.get_number_of_particles()
        assert pa.get_number_of_particles() == n
        for p in PROPS:
            if p not in pa.properties:
                continue
            k = pa.stride.get(p, 1)
            assert rpa.stride.get(p, 1) == k, p
            errs[pa.name, p] = _scaled_err(pa.properties[p],
                                           rpa.properties[p][:n * k])
    return errs


def test_delta_dam_break_three_steps_matches_jax(jax_run):
    port = DamBreak3D()
    port.run(['--use-double', '--device', 'cpu'] + ARGV)
    a_eval = port.solver.acceleration_evals[0]
    assert set(a_eval.engine_choices.values()) == {'kernel'}
    assert port.solver.count == jax_run.solver.count == 3
    assert abs(port.solver.t - jax_run.solver.t) <= TOL * jax_run.solver.t
    assert abs(port.solver.dt - jax_run.solver.dt) <= TOL * jax_run.solver.dt
    errs = _errors(port, jax_run)
    assert ('fluid', 'gradrho') in errs and ('fluid', 'm_mat') in errs
    for key, err in errs.items():
        assert err <= TOL, '%s.%s: scaled error %.3g' % (key + (err,))


def test_gradient_correction_in_three_dimensions_misses_jax(jax_run,
                                                           monkeypatch):
    """The bar above sees the correction's dim: built with dim=3, the
    port's fluid gradrho leaves it."""
    init = kernel_correction.GradientCorrection.__init__

    def three_d(self, dest, sources, dim=2, tol=0.1):
        init(self, dest, sources, dim=3, tol=tol)

    monkeypatch.setattr(kernel_correction.GradientCorrection, '__init__',
                        three_d)
    port = DamBreak3D()
    port.run(['--use-double', '--device', 'cpu'] + ARGV)
    errs = _errors(port, jax_run)
    assert errs['fluid', 'gradrho'] > 1e3 * TOL
