"""The JAX package's figures for the TVF wall examples, the constants
that ``chip_smoke.py`` holds the port's runs on the card to.

    JAX_PLATFORMS=cpu python tests/jax_wall_figures.py poiseuille
    JAX_PLATFORMS=cpu python tests/jax_wall_figures.py couette
    JAX_PLATFORMS=cpu python tests/jax_wall_figures.py cavity \\
        --nx 400 --steps 200 [--scheme edac]
    JAX_PLATFORMS=cpu python tests/jax_wall_figures.py dam_break_2d \\
        --dx 0.02 --steps 200 [--scheme edac|iisph]
    JAX_PLATFORMS=cpu python tests/jax_wall_figures.py elliptical_drop \\
        --nx 100 [--steps 200] [--scheme iisph]

``poiseuille`` and ``couette`` run ``pysph_tpu/examples/<name>.py`` as
the example defines itself (to its own ``tf``, float32), dumping into a
temporary directory, and print the ``post_process`` error against the
exact steady profile (max |u - ue| over max |ue|) as ``profile_err``.
``cavity`` runs ``pysph_tpu/examples/cavity.py --nx <nx> --scheme
<scheme>`` (default ``tvf``) for ``steps`` steps in float32 (no output)
and prints the fluid's max speed and kinetic energy, as
``chip_smoke.py::_cavity_figures`` computes them for the port.
``dam_break_2d`` runs ``pysph_tpu/examples/dam_break_2d.py --dx <dx>
--scheme <scheme>`` (default ``edac``) for ``steps`` steps in float32
(no output) and prints the fluid's front (its max x), its kinetic
energy and the wall's least pressure, as ``chip_smoke.py::
_dam_break_figures`` computes them for the port.  ``elliptical_drop``
runs ``pysph_tpu/examples/elliptical_drop.py --nx <nx> --scheme
<scheme>`` (default ``iisph``) to its ``tf`` (or ``steps`` steps) in
float32 (no output) and prints the fluid's max |y| (the semi-major axis)
and max |x|.  One JSON line each.
Not a test: pytest collects only ``test_*.py``.
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


def cavity(nx, steps, scheme='tvf'):
    from pysph_tpu.examples.cavity import LidDrivenCavity
    tmp = tempfile.mkdtemp()
    try:
        app = LidDrivenCavity()
        app.setup(['-d', tmp, '--disable-output', '-q', '--nx', str(nx),
                   '--max-steps', str(steps), '--scheme', scheme])
        t0 = time.perf_counter()
        app.solve()
        wall = time.perf_counter() - t0
        pa = next(p for p in app.particles if p.name == 'fluid')
        u, v, m = (np.asarray(getattr(pa, c), dtype=np.float64)
                   for c in ('u', 'v', 'm'))
        speed2 = u * u + v * v
        return dict(example='cavity', scheme=scheme, nx=nx,
                    steps=int(app.solver.count),
                    t=float(app.solver.t), n=int(u.size),
                    vmax=float(np.sqrt(speed2.max())),
                    ke=float(0.5 * np.sum(m * speed2)),
                    dtype=str(np.asarray(pa.u).dtype), solve_s=wall)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dam_break(dx, steps, scheme='edac'):
    from pysph_tpu.examples.dam_break_2d import DamBreak2D
    tmp = tempfile.mkdtemp()
    try:
        app = DamBreak2D()
        app.setup(['-d', tmp, '--disable-output', '-q', '--dx', repr(dx),
                   '--max-steps', str(steps), '--scheme', scheme])
        t0 = time.perf_counter()
        app.solve()
        wall = time.perf_counter() - t0
        arrays = {p.name: p for p in app.particles}
        fluid = arrays['fluid']
        x, u, v, m = (np.asarray(getattr(fluid, c), dtype=np.float64)
                      for c in ('x', 'u', 'v', 'm'))
        p_wall = np.asarray(arrays['boundary'].p, dtype=np.float64)
        return dict(example='dam_break_2d', scheme=scheme, dx=dx,
                    steps=int(app.solver.count), t=float(app.solver.t),
                    n=int(x.size), front=float(x.max()),
                    ke=float(0.5 * np.sum(m * (u * u + v * v))),
                    wall_p_min=float(p_wall.min()),
                    dtype=str(np.asarray(fluid.u).dtype), solve_s=wall)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def drop(nx, steps, scheme='iisph'):
    from pysph_tpu.examples.elliptical_drop import EllipticalDrop
    tmp = tempfile.mkdtemp()
    try:
        app = EllipticalDrop()
        app.setup(['-d', tmp, '--disable-output', '-q', '--nx', str(nx),
                   '--max-steps', str(steps), '--scheme', scheme])
        t0 = time.perf_counter()
        app.solve()
        wall = time.perf_counter() - t0
        pa = app.particles[0]
        x, y = (np.asarray(getattr(pa, c), dtype=np.float64) for c in 'xy')
        return dict(example='elliptical_drop', scheme=scheme, nx=nx,
                    steps=int(app.solver.count), t=float(app.solver.t),
                    n=int(x.size), ymax=float(np.abs(y).max()),
                    xmax=float(np.abs(x).max()),
                    dtype=str(np.asarray(pa.u).dtype), solve_s=wall)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('example',
                        choices=('poiseuille', 'couette', 'cavity',
                                 'dam_break_2d', 'elliptical_drop'))
    parser.add_argument('--nx', type=int, default=400)
    parser.add_argument("--dx", type=float, default=0.02)
    parser.add_argument('--steps', type=int, default=None)
    parser.add_argument('--scheme', default=None)
    a = parser.parse_args()
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    steps = 200 if a.steps is None else a.steps
    if a.example == 'cavity':
        out = cavity(a.nx, steps, a.scheme or 'tvf')
    elif a.example == 'dam_break_2d':
        out = dam_break(a.dx, steps, a.scheme or 'edac')
    elif a.example == 'elliptical_drop':
        # to the example's tf unless a step count is given
        out = drop(a.nx, a.steps or 1 << 30, a.scheme or 'iisph')
    else:
        out = profile(a.example)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
