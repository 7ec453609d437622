"""Which of the JAX package's Pallas kernels each ``CRKSPHScheme`` group
takes, from the JAX package's own record: its log (``pallas fallback``
lines of ``pysph_tpu.sph.acceleration_eval``, ``resident mode off``
lines of ``pysph_tpu.ops.resident``) and each evaluator's
``engine_choices``, with ``use_pallas`` on (Pallas in interpret mode on
the CPU).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/jax_crksph_engines.py \\
        [--nx 30]

runs one step of ``pysph_tpu/examples/gas_dynamics/hydrostatic_box.py``
(its default scheme, ``crksph``) in float64 and prints the log's lines,
whether the integrator built a resident runner, and each evaluator's
``engine_choices`` (``pallas-compact``: ``_pair_kernel_compact``,
``pallas_engine.py:1160``; ``xla``: no Pallas kernel).  At ``--nx 12``
the box's periodic axes have 2 cells, which the compact engine refuses.
Not a test: pytest collects only ``test_*.py``.
"""

import argparse
import logging
import shutil
import tempfile


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--nx', type=int, default=30)
    nx = parser.parse_args().nx
    logging.basicConfig(level=logging.INFO, format='%(name)s: %(message)s')
    from pysph_tpu.config import get_config
    from pysph_tpu.examples.gas_dynamics.hydrostatic_box import (
        HydrostaticBox)
    get_config().use_pallas = True
    tmp = tempfile.mkdtemp()
    try:
        app = HydrostaticBox()
        app.setup(['-d', tmp, '--disable-output', '-q', '--max-steps', '1',
                   '--nx', str(nx), '--use-double'])
        app.solver.chunk_steps = 1
        app.solve()
        ig = app.solver.integrator
        print('evaluators %d; resident runner %r' % (
            len(ig.acceleration_evals), ig._res_runner))
        for k, a_eval in enumerate(ig.acceleration_evals):
            print('evaluator %d engine_choices %s' % (k, a_eval.engine_choices))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == '__main__':
    main()
