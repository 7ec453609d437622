"""The JAX package's figures for the gas-dynamics runs, the constants that
``chip_smoke.py`` holds the port's runs on the card to
(``tests/jax_gasd_figures.py`` is to ``GasDScheme`` what
``tests/jax_wall_figures.py`` is to the walls).

    JAX_PLATFORMS=cpu python tests/jax_gasd_figures.py shocktube \\
        [--nl 320]
    JAX_PLATFORMS=cpu python tests/jax_gasd_figures.py sedov \\
        [--nx 41] [--steps 200]

Both run the JAX solver's per-step loop (``chunk_steps = 1``), as the
port runs an iterated group on the card.  ``shocktube`` runs
``pysph_tpu/examples/gas_dynamics/shocktube.py --nl <nl> --use-double``
to its tf = 0.15 (no output) and prints the L1 errors
of rho, p and u against the exact Riemann solution, as the port's
``examples/gas_dynamics/shocktube.py::l1_errors`` computes them.
``sedov`` runs ``pysph_tpu/examples/gas_dynamics/sedov.py --nx <nx>``
for ``steps`` steps in float32 (no output) and prints the blast's shell
radius, peak density and total energy, as the port's
``examples/gas_dynamics/sedov.py::figures`` computes them; and the
spread of h.  One JSON line each.
Not a test: pytest collects only ``test_*.py``.  ``FROZEN`` holds what
it printed on the CPU (JAX's XLA path), the figures ``chip_smoke.py``
holds the port to (``JAX_SHOCKTUBE``, ``JAX_SEDOV``).
"""

import argparse
import json
import shutil
import tempfile
import time

import numpy as np

#: the figures of ``shocktube --nl 320`` (float64, 1,500 steps to t =
#: 0.15, hmax/hmin 80.777) and ``sedov --nx 41 --steps 200`` (float32, t
#: = 0.02, hmax/hmin 2.356, h 0.0229 to 0.0540) as this script printed
#: them
FROZEN = {
    'shocktube': {'rho': 0.01269194755940777, 'p': 0.015312279820969206,
                  'u': 0.06395616494260377},
    'sedov': {'radius': 0.1599970491956032, 'peak': 1.7150838375091553,
              'energy': 0.9999738059114059},
}


def _run(app, argv):
    tmp = tempfile.mkdtemp()
    try:
        app.setup(['-d', tmp, '--disable-output', '-q'] + argv)
        # the per-step loop, as the port's on the card: the JAX chunk
        # carries t in float32, and its t after the shock tube's 1,500
        # steps falls short of tf by 1e-8, so that a chunked run takes a
        # 1,501st step of that size, which re-evaluates rho and p at the
        # full step (GasDFluidStep's corrector leaves them at the half
        # step): 0.5% in the L1 errors of rho and p
        app.solver.chunk_steps = 1
        t0 = time.perf_counter()
        app.solve()
        return time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _state(app):
    pa = app.particles[0]
    return {p: np.asarray(pa.properties[p], dtype=np.float64)
            for p in ('x', 'y', 'u', 'v', 'rho', 'p', 'm', 'e', 'h')}


def shocktube(nl):
    from pysph_tpu.examples.gas_dynamics.shocktube import ShockTube
    from pysph_tpu_torch.examples.gas_dynamics.shocktube import l1_errors
    app = ShockTube()
    wall = _run(app, ['--nl', str(nl), '--use-double'])
    s, st = app.solver, _state(app)
    return dict(example='shocktube', nl=nl, steps=int(s.count),
                t=float(s.t), n=int(st['x'].size),
                l1=l1_errors(st['x'], st['rho'], st['p'], st['u'], s.t),
                hmax_hmin=float(st['h'].max() / st['h'].min()),
                dtype=str(np.asarray(app.particles[0].properties['x']).dtype),
                solve_s=wall)


def sedov(nx, steps):
    from pysph_tpu.examples.gas_dynamics.sedov import SedovPointExplosion
    from pysph_tpu_torch.examples.gas_dynamics.sedov import figures
    app = SedovPointExplosion()
    wall = _run(app, ['--nx', str(nx), '--max-steps', str(steps)])
    s, st = app.solver, _state(app)
    return dict(example='sedov', nx=nx, steps=int(s.count), t=float(s.t),
                n=int(st['x'].size),
                **figures(st['x'], st['y'], st['u'], st['v'], st['rho'],
                          st['m'], st['e']),
                hmin=float(st['h'].min()), hmax=float(st['h'].max()),
                hmax_hmin=float(st['h'].max() / st['h'].min()),
                dtype=str(np.asarray(app.particles[0].properties['x']).dtype),
                solve_s=wall)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('example', choices=('shocktube', 'sedov'))
    parser.add_argument('--nl', type=int, default=320)
    parser.add_argument('--nx', type=int, default=41)
    parser.add_argument('--steps', type=int, default=200)
    args = parser.parse_args()
    if args.example == 'shocktube':
        out = shocktube(args.nl)
    else:
        out = sedov(args.nx, args.steps)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
