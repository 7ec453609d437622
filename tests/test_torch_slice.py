"""The port's main path against pysph_tpu: dam_break_3d at dx=0.12 for
three steps in float64, and the port's independence from JAX."""

import pkgutil
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from pysph_tpu.examples.dam_break_3d import DamBreak3D as JaxDamBreak3D
from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

ARGV = ['--dx', '0.12', '--max-steps', '3', '--disable-output', '-q']
PROPS = ('x', 'y', 'z', 'u', 'v', 'w', 'rho', 'p')
TOL = 1e-9


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


def test_dam_break_3d_three_steps_matches_jax():
    tmp = tempfile.mkdtemp()
    try:
        ref = JaxDamBreak3D()
        ref.run(['-d', tmp] + ARGV)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    port = DamBreak3D()
    port.run(['--use-double', '--device', 'cpu'] + ARGV)

    assert port.solver.count == ref.solver.count == 3
    assert abs(port.solver.t - ref.solver.t) <= TOL * ref.solver.t
    assert abs(port.solver.dt - ref.solver.dt) <= TOL * ref.solver.dt
    ref_arrays = {pa.name: pa for pa in ref.particles}
    for pa in port.particles:
        rpa = ref_arrays[pa.name]
        n = rpa.get_number_of_particles()
        assert pa.get_number_of_particles() == n
        for p in PROPS:
            err = _scaled_err(pa.properties[p], rpa.properties[p][:n])
            assert err <= TOL, '%s.%s: scaled error %.3g' % (pa.name, p,
                                                             err)


def test_port_imports_no_jax():
    """Every module of the port, its tools included, imports without
    pulling in JAX, the JAX package or the root ``tools_dev``."""
    import pysph_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        pysph_tpu_torch.__path__, 'pysph_tpu_torch.')]
    assert 'pysph_tpu_torch.examples.dam_break_3d' in names
    for m in ('ops.micro', 'ops.pair_stub', 'tools_dev.micro_launch',
              'tools_dev.micro_engine', 'tools_dev.prof_dma',
              'tools_dev.prof_phases', 'tools_dev.roofline',
              'tools_dev.time_chunks', 'tools_dev.prof_chunk',
              'ops.gsph_pair', 'ops.pair_sets', 'sph.gas_dynamics.gsph',
              'sph.gas_dynamics.riemann_solver',
              'tools.uniform_distribution',
              'examples.gas_dynamics.accuracy_test_2d',
              'examples.gas_dynamics.hydrostatic_box'):
        assert 'pysph_tpu_torch.' + m in names
    code = ('import importlib, sys\n'
            'for m in %r:\n'
            '    importlib.import_module(m)\n'
            'bad = sorted(m for m in sys.modules if m == "jax" or '
            'm.startswith(("jax.", "jaxlib")) or m == "pysph_tpu" or '
            'm.startswith("pysph_tpu.") or m == "tools_dev" or '
            'm.startswith("tools_dev."))\n'
            'print(bad)\n' % names)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=Path(__file__).resolve().parents[1],
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'
