"""The JAX package's Taylor-Green decay figures, the constants that
``chip_smoke.py`` holds the port's runs on the card to.

    JAX_PLATFORMS=cpu python tests/jax_tg_decay.py --scheme wcsph \\
        --nx 400 --steps 200 [--delta-sph | --summation-density | ...]

runs ``pysph_tpu/examples/taylor_green.py`` with ``--scheme`` at ``nx``
for ``steps`` steps in float32 (the example's own start, no output),
with any further arguments passed on to the example (the scheme's own
flags: ``--delta-sph``, ``--summation-density``,
``--tensile-correction``, ``--kernel ...``), and prints one JSON line:
the final t, max |v| over the exact decay of the start's max |v|
(``ratio``) and the L1 error of |v| against the exact field (``l1``),
as ``chip_smoke.py::_tg_decay`` computes them for the port.  Not a
test: pytest collects only ``test_*.py``.
"""

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

from pysph_tpu.examples.taylor_green import TaylorGreen, exact_solution


def decay(scheme, nx, steps, flags=(), re=100.0):
    tmp = tempfile.mkdtemp()
    try:
        app = TaylorGreen()
        app.setup(['-d', tmp, '--disable-output', '-q', '--scheme', scheme,
                   '--nx', str(nx), '--max-steps', str(steps)] +
                  list(flags))
        pa = app.particles[0]
        vmax0 = float(np.sqrt(np.asarray(pa.u) ** 2 +
                              np.asarray(pa.v) ** 2).max())
        t0 = time.perf_counter()
        app.solve()
        wall = time.perf_counter() - t0
        pa = app.particles[0]
        t = float(app.solver.t)
        x, y, u, v = (np.asarray(getattr(pa, c), dtype=np.float64)
                      for c in 'xyuv')
        rate = -8.0 * np.pi ** 2 / re
        u_e, v_e, _ = exact_solution(1.0, rate, t, x, y)
        vmag = np.sqrt(u ** 2 + v ** 2)
        vmag_e = np.sqrt(u_e ** 2 + v_e ** 2)
        return dict(scheme=scheme, flags=list(flags), nx=nx,
                    steps=int(app.solver.count), t=t,
                    vmax0=vmax0, vmax=float(vmag.max()),
                    ratio=float(vmag.max() / (vmax0 * np.exp(rate * t))),
                    l1=float(np.mean(np.abs(vmag - vmag_e))),
                    dtype=str(pa.u.dtype), solve_s=wall)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--scheme', default='wcsph')
    parser.add_argument('--nx', type=int, default=400)
    parser.add_argument('--steps', type=int, default=200)
    a, flags = parser.parse_known_args()
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    print(json.dumps(decay(a.scheme, a.nx, a.steps, flags)), flush=True)


if __name__ == '__main__':
    main()
