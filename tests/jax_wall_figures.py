"""The JAX package's figures for the TVF wall examples, the constants
that ``chip_smoke.py`` holds the port's runs on the card to.

    JAX_PLATFORMS=cpu python tests/jax_wall_figures.py poiseuille
    JAX_PLATFORMS=cpu python tests/jax_wall_figures.py couette
    JAX_PLATFORMS=cpu python tests/jax_wall_figures.py cavity \\
        --nx 400 --steps 200

``poiseuille`` and ``couette`` run ``pysph_tpu/examples/<name>.py`` as
the example defines itself (to its own ``tf``, float32), dumping into a
temporary directory, and print the ``post_process`` error against the
exact steady profile (max |u - ue| over max |ue|) as ``profile_err``.
``cavity`` runs ``pysph_tpu/examples/cavity.py --nx <nx>`` for
``steps`` steps in float32 (no output) and prints the fluid's max speed
and kinetic energy, as ``chip_smoke.py::_cavity_figures`` computes them
for the port.  One JSON line each.  Not a test: pytest collects only
``test_*.py``.
"""

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np


def profile(name):
    from pysph_tpu.examples.couette import CouetteFlow
    from pysph_tpu.examples.poiseuille import PoiseuilleFlow
    cls = {'poiseuille': PoiseuilleFlow, 'couette': CouetteFlow}[name]
    tmp = tempfile.mkdtemp()
    try:
        app = cls()
        app.setup(['-d', tmp, '-q'])
        t0 = time.perf_counter()
        app.solve()
        wall = time.perf_counter() - t0
        y, u, ue = app.post_process(app.info_filename)
        err = float(np.abs(u - ue).max() / max(abs(ue).max(), 1e-12))
        return dict(example=name, steps=int(app.solver.count),
                    t=float(app.solver.t), profile_err=err,
                    dtype=str(np.asarray(u).dtype), solve_s=wall)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def cavity(nx, steps):
    from pysph_tpu.examples.cavity import LidDrivenCavity
    tmp = tempfile.mkdtemp()
    try:
        app = LidDrivenCavity()
        app.setup(['-d', tmp, '--disable-output', '-q', '--nx', str(nx),
                   '--max-steps', str(steps)])
        t0 = time.perf_counter()
        app.solve()
        wall = time.perf_counter() - t0
        pa = next(p for p in app.particles if p.name == 'fluid')
        u, v, m = (np.asarray(getattr(pa, c), dtype=np.float64)
                   for c in ('u', 'v', 'm'))
        speed2 = u * u + v * v
        return dict(example='cavity', nx=nx, steps=int(app.solver.count),
                    t=float(app.solver.t), n=int(u.size),
                    vmax=float(np.sqrt(speed2.max())),
                    ke=float(0.5 * np.sum(m * speed2)),
                    dtype=str(np.asarray(pa.u).dtype), solve_s=wall)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('example',
                        choices=('poiseuille', 'couette', 'cavity'))
    parser.add_argument('--nx', type=int, default=400)
    parser.add_argument('--steps', type=int, default=200)
    a = parser.parse_args()
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    out = cavity(a.nx, a.steps) if a.example == 'cavity' else \
        profile(a.example)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
