"""The solver's chunks replayed from CUDA graphs against its eager
per-step loop, on the card.

Skips without an NVIDIA card (a CUDA graph has no CPU mode; on the CPU
the same chunks run eagerly, ``tests/test_torch_chunking.py``).  This
file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_capture_cuda.py
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pysph_tpu_torch.tools_dev import time_chunks
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA graph has no CPU mode)')


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(time_chunks.GATES))
def test_captured_chunks_equal_the_eager_loop(case):
    """float64, 30 steps from n_damp = 0, chunks of 10 against one step
    at a time: every prop within 1e-12 of its max, t, dt and the count
    equal, a landing on an output time inside a chunk, one replay a
    chunk; the drop's grid grows inside a chunk and the chunk is captured
    again; the delta-SPH groups of ``--engine dense`` replay on the torch
    pair engine (``time_chunks.gate``)."""
    _need_card()
    held = time_chunks.gate(case)
    assert held['steps'] == time_chunks.GATE_STEPS
    assert held['max_scaled_err'] <= time_chunks.TOL
    # the initial dt's read, one a chunk, one a grow and one a redo
    assert held['reads'] == 1 + held['chunks'] + held['grows'] + \
        held['redos']


# in a process of its own: a failed capture may leave a CUDA error behind
_FAILING_CAPTURE = """
from pysph_tpu_torch.sph.integrator import Integrator
from pysph_tpu_torch.tools_dev.time_chunks import DamBreak3D
app = DamBreak3D()
app.setup(['--disable-output', '-q', '--use-double', '--device', 'cuda',
           '--dx', '0.08', '--max-steps', '12'])
app.solver.n_damp = 0
adapt = Integrator.compute_time_step

def reads_back(self, *args):
    dt = adapt(self, *args)
    float(dt)
    return dt

Integrator.compute_time_step = reads_back
try:
    app.solve()
except RuntimeError as e:
    print('raised:', app.solver.replays, app.solver.count, str(e)[:200])
"""


@pytest.mark.cuda
def test_a_capture_that_fails_raises():
    """No fallback: a read inside the step makes the capture fail, and
    the run raises instead of going on eagerly (no replay, and no step
    after the damped ones)."""
    _need_card()
    out = subprocess.run([sys.executable, '-c', _FAILING_CAPTURE],
                         capture_output=True, text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert 'raised: 0 0 ' in out.stdout, out.stdout
