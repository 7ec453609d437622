"""The JAX package's figures for the gas-dynamics runs, the constants that
``chip_smoke.py`` holds the port's runs on the card to
(``tests/jax_gasd_figures.py`` is to ``GasDScheme`` what
``tests/jax_wall_figures.py`` is to the walls).

    JAX_PLATFORMS=cpu python tests/jax_gasd_figures.py shocktube \\
        [--nl 320] [--scheme mpm|gsph|adke]
    JAX_PLATFORMS=cpu python tests/jax_gasd_figures.py sedov \\
        [--nx 41] [--steps 200] [--scheme mpm|tsph]
    JAX_PLATFORMS=cpu python tests/jax_gasd_figures.py accuracy_test_2d \\
        [--nparticles 64] [--scheme gsph|mpm|adke|crksph|tsph]
    JAX_PLATFORMS=cpu python tests/jax_gasd_figures.py hydrostatic_box \\
        [--nx 50] [--steps 200] [--scheme gsph|mpm|adke|crksph|tsph]
    JAX_PLATFORMS=cpu python tests/jax_gasd_figures.py cheng_shu_1d \\
        [--steps 200] [--scheme gsph|tsph]

Both run the JAX solver's per-step loop (``chunk_steps = 1``), as the
port runs an iterated group on the card.  ``shocktube`` runs
``pysph_tpu/examples/gas_dynamics/shocktube.py --nl <nl> --use-double``
(with ``--scheme``) to its tf = 0.15 (no output) and prints the L1 errors
of rho, p and u against the exact Riemann solution, as the port's
``examples/gas_dynamics/shocktube.py::l1_errors`` computes them.
``accuracy_test_2d`` runs ``accuracy_test_2d.py --nparticles <n>
--use-double`` (with ``--scheme``) to its tf = 1.0 and prints the L1
error of rho against the advected profile, as the port's
``examples/gas_dynamics/accuracy_test_2d.py::l1_norm`` computes it;
``hydrostatic_box`` runs ``hydrostatic_box.py --nx <nx> --use-double``
(with ``--scheme``) for ``steps`` steps and prints the largest speed and
the largest relative departure of rho from its set value, as the port's
``examples/gas_dynamics/hydrostatic_box.py::figures`` computes them.
Both periodic runs size the JAX grid with cells ``ROOMY['cell_slack']``
times the support of the setup's h (and ``capacity_slack`` to match):
``GSPHScheme``'s first evaluation doubles h and ``ADKEScheme``'s k = 1.5
scales it by 1.5, past the periodic cells that the JAX package sizes at
setup and keeps, where its sums miss pairs (ROADMAP Queue 3); the port
re-sizes its grid for them, and the larger cells give the JAX package
every pair.
``cheng_shu_1d`` runs ``cheng_shu_1d.py --use-double`` (1,000
particles, with ``--scheme``) for ``steps`` steps on ``ROOMY`` cells and
prints the port's ``examples/gas_dynamics/cheng_shu_1d.py::figures``.
``sedov`` runs ``pysph_tpu/examples/gas_dynamics/sedov.py --nx <nx>``
(with ``--scheme``) for ``steps`` steps in float32 (no output) and
prints the blast's shell radius, peak density and total energy, as the
port's ``examples/gas_dynamics/sedov.py::figures`` computes them; and the
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

#: the JAX grid's sizing in the periodic runs (see the module docstring)
ROOMY = dict(cell_slack=2.5, capacity_slack=10.0)


def _roomy_grid():
    """Size every JAX grid with ``ROOMY`` (``GridSpec.from_particles``'s
    defaults replaced; the JAX package is not edited)."""
    from pysph_tpu.base.cell_grid import GridSpec
    make = GridSpec.from_particles.__func__

    def roomy(cls, *args, **kw):
        for k, v in ROOMY.items():
            kw.setdefault(k, v)
        return make(cls, *args, **kw)

    GridSpec.from_particles = classmethod(roomy)

#: the figures of ``shocktube --nl 320`` (float64, 1,500 steps to t =
#: 0.15, hmax/hmin 80.777) and ``sedov --nx 41 --steps 200`` (float32, t
#: = 0.02, hmax/hmin 2.356, h 0.0229 to 0.0540), and of the runs below, as
#: this script printed them
FROZEN = {
    'shocktube': {'rho': 0.01269194755940777, 'p': 0.015312279820969206,
                  'u': 0.06395616494260377},
    'sedov': {'radius': 0.1599970491956032, 'peak': 1.7150838375091553,
              'energy': 0.9999738059114059},
    # accuracy_test_2d --nparticles 64 to tf = 1.0 (756 steps; mpm's
    # adaptive dt 205), float64, ROOMY cells: the L1 of rho by scheme
    'accuracy_test_2d': {'gsph': 0.019094168522500815,
                         'mpm': 0.009723247057571023,
                         'adke': 0.01850768099388279},
    # hydrostatic_box --nx 50 after 200 steps, float64, ROOMY cells
    'hydrostatic_box': {
        'gsph': {'max_speed': 0.05207310077308546,
                 'rho_spread': 0.488650734680953},
        'mpm': {'max_speed': 0.09849217996461504,
                'rho_spread': 0.39589640171242335},
        'adke': {'max_speed': 0.17708498207009132,
                 'rho_spread': 0.4606353648072288}},
    # the CRKSPH runs, float64: accuracy_test_2d --nparticles 32 --scheme
    # crksph to tf = 1.0 (378 steps; 64^2 ran past 20 minutes on the
    # CPU), its L1 of rho; hydrostatic_box --nx 50 --scheme crksph after
    # 200 steps (its largest speed is rounding)
    'crksph': {'accuracy_test_2d 32': 7.707702803696342e-07,
               'hydrostatic_box': {'max_speed': 3.852790224035833e-15,
                                   'rho_spread': 0.00015512394441330457}},
    # the TSPH runs: accuracy_test_2d --nparticles 32 --scheme tsph to tf
    # = 1.0 (378 steps), float64, its L1 of rho; hydrostatic_box --nx 50
    # --scheme tsph after 200 steps, float64; sedov --nx 41 --scheme tsph
    # after 200 steps, float32 (hmax/hmin 2.374); cheng_shu_1d --scheme
    # tsph after 200 steps, float64
    'tsph': {'accuracy_test_2d 32': 0.020816479930321194,
             'hydrostatic_box': {'max_speed': 0.13057059225211037,
                                 'rho_spread': 0.3963929452518531},
             'sedov': {'radius': 0.1602630866490765,
                       'peak': 1.7553044557571411,
                       'energy': 0.9999728717082634},
             'cheng_shu_1d': {'rho_l1': 0.01785519223224774,
                              'rho_max': 3.0006915842179342,
                              'u_max': 1.0996233021775303}},
    # cheng_shu_1d --scheme gsph (the exact solver) after 200 steps,
    # float64
    'cheng_shu_1d gsph': {'rho_l1': 0.01806316552009522,
                          'rho_max': 3.0793219522333306,
                          'u_max': 1.0999479519940372},
    # shocktube --nl 320 --scheme gsph|adke to tf = 0.15 (1,500 steps),
    # float64: the L1 errors of rho, p and u
    'shocktube schemes': {
        'gsph': {'rho': 0.006351124186608512, 'p': 0.005643681197702059,
                 'u': 0.009568452084448117},
        'adke': {'rho': 0.19249611921569626, 'p': 0.2167222541130143,
                 'u': 0.19141747246591215}},
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


def shocktube(nl, scheme='mpm'):
    from pysph_tpu.examples.gas_dynamics.shocktube import ShockTube
    from pysph_tpu_torch.examples.gas_dynamics.shocktube import l1_errors
    app = ShockTube()
    wall = _run(app, ['--nl', str(nl), '--use-double', '--scheme', scheme])
    s, st = app.solver, _state(app)
    return dict(example='shocktube', scheme=scheme, nl=nl,
                steps=int(s.count),
                t=float(s.t), n=int(st['x'].size),
                l1=l1_errors(st['x'], st['rho'], st['p'], st['u'], s.t),
                hmax_hmin=float(st['h'].max() / st['h'].min()),
                dtype=str(np.asarray(app.particles[0].properties['x']).dtype),
                solve_s=wall)


def sedov(nx, steps, scheme='mpm'):
    from pysph_tpu.examples.gas_dynamics.sedov import SedovPointExplosion
    from pysph_tpu_torch.examples.gas_dynamics.sedov import figures
    app = SedovPointExplosion()
    wall = _run(app, ['--nx', str(nx), '--max-steps', str(steps),
                      '--scheme', scheme])
    s, st = app.solver, _state(app)
    return dict(example='sedov', scheme=scheme, nx=nx, steps=int(s.count),
                t=float(s.t),
                n=int(st['x'].size),
                **figures(st['x'], st['y'], st['u'], st['v'], st['rho'],
                          st['m'], st['e']),
                hmin=float(st['h'].min()), hmax=float(st['h'].max()),
                hmax_hmin=float(st['h'].max() / st['h'].min()),
                dtype=str(np.asarray(app.particles[0].properties['x']).dtype),
                solve_s=wall)


def accuracy_test_2d(nparticles, scheme):
    from pysph_tpu.examples.gas_dynamics.accuracy_test_2d import (
        AccuracyTest2D)
    from pysph_tpu_torch.examples.gas_dynamics.accuracy_test_2d import (
        l1_norm)
    _roomy_grid()
    app = AccuracyTest2D()
    wall = _run(app, ['--nparticles', str(nparticles), '--use-double',
                      '--scheme', scheme])
    s, st = app.solver, _state(app)
    return dict(example='accuracy_test_2d', scheme=scheme,
                nparticles=nparticles, steps=int(s.count), t=float(s.t),
                n=int(st['x'].size), l1=l1_norm(st['x'], st['y'], st['rho']),
                hmax_hmin=float(st['h'].max() / st['h'].min()),
                dtype=str(np.asarray(app.particles[0].properties['x']).dtype),
                solve_s=wall)


def hydrostatic_box(nx, steps, scheme):
    from pysph_tpu.examples.gas_dynamics.hydrostatic_box import (
        HydrostaticBox)
    from pysph_tpu_torch.examples.gas_dynamics.hydrostatic_box import (
        figures)
    _roomy_grid()
    app = HydrostaticBox()
    wall = _run(app, ['--nx', str(nx), '--use-double', '--scheme', scheme,
                      '--max-steps', str(steps)])
    s, st = app.solver, _state(app)
    return dict(example='hydrostatic_box', scheme=scheme, nx=nx,
                steps=int(s.count), t=float(s.t), n=int(st['x'].size),
                **figures(st['u'], st['v'], st['rho'], st['m'], 1.0 / nx),
                hmax_hmin=float(st['h'].max() / st['h'].min()),
                dtype=str(np.asarray(app.particles[0].properties['x']).dtype),
                solve_s=wall)


def cheng_shu_1d(steps, scheme):
    from pysph_tpu.examples.gas_dynamics.cheng_shu_1d import ChengShu
    from pysph_tpu_torch.examples.gas_dynamics.cheng_shu_1d import figures
    _roomy_grid()
    app = ChengShu()
    wall = _run(app, ['--use-double', '--scheme', scheme, '--max-steps',
                      str(steps)])
    s, st = app.solver, _state(app)
    return dict(example='cheng_shu_1d', scheme=scheme, steps=int(s.count),
                t=float(s.t), n=int(st['x'].size),
                **figures(st['x'], st['rho'], st['u'], float(s.t)),
                hmax_hmin=float(st['h'].max() / st['h'].min()),
                dtype=str(np.asarray(app.particles[0].properties['x']).dtype),
                solve_s=wall)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('example', choices=('shocktube', 'sedov',
                                            'accuracy_test_2d',
                                            'hydrostatic_box',
                                            'cheng_shu_1d'))
    parser.add_argument('--nl', type=int, default=320)
    parser.add_argument('--nx', type=int, default=None)
    parser.add_argument('--nparticles', type=int, default=64)
    parser.add_argument('--steps', type=int, default=200)
    parser.add_argument('--scheme', default=None)
    args = parser.parse_args()
    if args.example == 'shocktube':
        out = shocktube(args.nl, args.scheme or 'mpm')
    elif args.example == 'sedov':
        out = sedov(args.nx or 41, args.steps, args.scheme or 'mpm')
    elif args.example == 'accuracy_test_2d':
        out = accuracy_test_2d(args.nparticles, args.scheme or 'gsph')
    elif args.example == 'cheng_shu_1d':
        out = cheng_shu_1d(args.steps, args.scheme or 'gsph')
    else:
        out = hydrostatic_box(args.nx or 50, args.steps,
                              args.scheme or 'gsph')
    print(json.dumps(out))


if __name__ == '__main__':
    main()
