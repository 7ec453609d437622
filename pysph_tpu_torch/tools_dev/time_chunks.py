"""The solver's chunks on the card: the equality gate and ms/step.

    python3 -m pysph_tpu_torch.tools_dev.time_chunks [label]

``gate(case)``: a path in float64 at a small size, ``GATE_STEPS`` steps
with ``n_damp = 0``, under ``chunk_steps = 10`` (chunks replayed from a
CUDA graph) and under ``chunk_steps = 1`` (the eager per-step loop):
every state prop within 1e-12 of its max over the finite entries (the
non-finite ones equal), ``t``, ``dt``, ``count`` and the binnings that
ran (``rebuilds``) exactly equal, the
same dumps (count and t), among them a landing on an output time that
the chunk decided; on the drop, the grid just holds it and its speed is
ten times the example's, so a binning overflows inside a chunk, the grid
grows and the chunk is captured again; on the moving dam break, seeded
velocities of 3 m/s make the reuse test rebuild the binning every few
steps inside the chunks; ``dam_break_3d --engine dense --delta-sph``
runs its delta-SPH groups on the torch pair engine inside the graphs
(a chunk that overflowed a capacity is redone and captured again); the
Taylor-Green vortex runs on a periodic box, whose particles wrap across
it inside the chunks, under its three schemes (``tvf``; ``wcsph`` on
both kernel engines, and with each of ``WCSPH_OPTIONS``, the scheme's
other flags and kernels; ``gtvf``, two evaluators a step); the TVF wall
examples run the Adami walls, the cavity on an open grid, Poiseuille's
channel periodic in x; ``EDACScheme`` runs the Taylor-Green vortex, the
cavity (its mean-pressure group between the density and the momentum
group) and the 2D dam break (its external flow, the wall pressure
clamped); ``IISPHScheme`` the Taylor-Green vortex and the 2D dam break
(adaptive dt), the pressure group's sweeps in one ``iisph_solve``
launch inside the graphs.

``timed_solve(app, chunk_steps)``: the median ms/step of a run, per
step (host clock at each step's start, the card synchronised) or in
chunks (host clock after each chunk's read, which waits for the card,
over the chunks after the capture).  ``main`` prints one JSON line per
full-width run of ``STEPS`` steps and binning configuration of
``CONFIGS``, both ways, with the binnings that ran, tagged with
``label`` and the card's name and power limit (the delta-SPH dam break,
the Taylor-Green runs, the wall examples and the EDAC and IISPH runs
under ``reuse`` only); the IISPH runs (``STEP_PATHS``) with their
pressure sweeps, ``iisph_solve`` launches and host reads both ways.

``CONFIGS`` are the reference's two binning configurations, set in code
on an app after its setup (``configure``): ``reuse`` (the default: a
reuse test once a step per evaluator, cells ``cell_slack`` 1.1 times the
support) and ``every eval`` (``Integrator.bin_every_eval``, the test at
every evaluation, on cells 1.001 times the support, so that nearly every
test rebuilds).
"""

import json
import sys
import time

import numpy as np
import torch

from pysph_tpu_torch.examples.dam_break_2d import DamBreak2D
from pysph_tpu_torch.examples.cavity import LidDrivenCavity
from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
from pysph_tpu_torch.examples.elliptical_drop import EllipticalDrop
from pysph_tpu_torch.examples.periodic_cylinders import PeriodicCylinders
from pysph_tpu_torch.examples.poiseuille import PoiseuilleFlow
from pysph_tpu_torch.examples.rayleigh_taylor import RayleighTaylor
from pysph_tpu_torch.examples.taylor_green import TaylorGreen
from pysph_tpu_torch.ops.iisph_solve import iisph_solve
from pysph_tpu_torch.sph import integrator as _integrator
from pysph_tpu_torch.sph import integrator_step as _steps
from pysph_tpu_torch.tools_dev import common
from pysph_tpu_torch.tools_dev.time_walks import make_app

STEPS = 200
WARMUP = 20
GATE_STEPS = 30
TOL = 1e-12

#: {case: (example, arguments, what to change on its solver or None)}
#: of the gate, float64; filled below
GATES = {}

#: the binning configurations: {name: (bin_every_eval, cell_slack)}
CONFIGS = {'reuse': (False, 1.1), 'every eval': (True, 1.001)}

#: the full-width float32 runs: {label: make_app keyword arguments}
PATHS = {
    'dam_break_3d dx=0.02': dict(dx=0.02),
    'dam_break_3d dx=0.02 delta': dict(dx=0.02, extra=('--delta-sph',)),
    'GTVF dx=0.004': dict(dx=0.004, cls=DamBreak2D,
                          extra=('--scheme', 'gtvf')),
    'dam_break_2d wcsph dx=0.004': dict(dx=0.004, cls=DamBreak2D),
    'drop nx=200 kernel': dict(dx=None, cls=EllipticalDrop,
                               extra=('--nx', '200')),
    'drop nx=200 dense': dict(dx=None, cls=EllipticalDrop,
                              extra=('--nx', '200'), engine='dense'),
    'taylor_green nx=400': dict(dx=None, cls=TaylorGreen,
                                extra=('--nx', '400')),
    'taylor_green wcsph nx=400': dict(
        dx=None, cls=TaylorGreen, extra=('--nx', '400', '--scheme',
                                         'wcsph')),
    'taylor_green wcsph nx=400 dense': dict(
        dx=None, cls=TaylorGreen, extra=('--nx', '400', '--scheme',
                                         'wcsph'), engine='dense'),
    'taylor_green gtvf nx=400': dict(
        dx=None, cls=TaylorGreen, extra=('--nx', '400', '--scheme',
                                         'gtvf')),
    'dam_break_3d dx=0.02 C4': dict(
        dx=0.02, extra=('--kernel', 'WendlandQuinticC4')),
    # the TVF wall examples: the lid-driven cavity at a convergence
    # study's resolution, and the two runs whose sizes are the
    # reference's constants
    'cavity nx=400': dict(dx=None, cls=LidDrivenCavity,
                          extra=('--nx', '400')),
    'rayleigh_taylor': dict(dx=None, cls=RayleighTaylor),
    'periodic_cylinders': dict(dx=None, cls=PeriodicCylinders),
}
#: the TVF wall examples' paths
WALL_PATHS = ('cavity nx=400', 'rayleigh_taylor', 'periodic_cylinders')
#: EDACScheme's three runs: Taylor-Green and the cavity at a convergence
#: study's resolution, the dam break at the WCSPH and GTVF dam breaks'
EDAC_PATHS = {
    'taylor_green edac nx=400': dict(
        dx=None, cls=TaylorGreen, extra=('--nx', '400', '--scheme',
                                         'edac')),
    'cavity edac nx=400': dict(dx=None, cls=LidDrivenCavity,
                               extra=('--nx', '400', '--scheme', 'edac')),
    'dam_break_2d edac dx=0.004': dict(dx=0.004, cls=DamBreak2D,
                                       extra=('--scheme', 'edac')),
}
PATHS.update(EDAC_PATHS)
#: IISPHScheme's three runs (their pressure group one iisph_solve launch
#: an eval, so they run in chunks), timed in chunks and per step with
#: their sweeps and host reads: Taylor-Green at a convergence study's
#: resolution, the dam break at the other dam breaks', the drop at the
#: WCSPH drop's
STEP_PATHS = {
    'taylor_green iisph nx=400': dict(
        dx=None, cls=TaylorGreen, extra=('--nx', '400', '--scheme',
                                         'iisph')),
    'dam_break_2d iisph dx=0.004': dict(dx=0.004, cls=DamBreak2D,
                                        extra=('--scheme', 'iisph')),
    'drop iisph nx=200': dict(dx=None, cls=EllipticalDrop,
                              extra=('--nx', '200', '--scheme', 'iisph')),
}
PATHS.update(STEP_PATHS)

#: WCSPHScheme's other flags and kernels on the Taylor-Green vortex:
#: {name: the example's arguments}
WCSPH_OPTIONS = {
    'delta': ('--delta-sph',),
    'summation': ('--summation-density',),
    'tensile': ('--tensile-correction',),
    'C4': ('--kernel', 'WendlandQuinticC4'),
    'C6': ('--kernel', 'WendlandQuinticC6'),
    'SuperGaussian': ('--kernel', 'SuperGaussian'),
}
#: the options timed at full width
TIMED_OPTIONS = ('delta', 'summation', 'tensile')
PATHS.update({
    'taylor_green wcsph %s nx=400' % name: dict(
        dx=None, cls=TaylorGreen, extra=('--nx', '400', '--scheme', 'wcsph')
        + WCSPH_OPTIONS[name]) for name in TIMED_OPTIONS})

#: the paths timed under the default binning configuration only
REUSE_ONLY = ('dam_break_3d dx=0.02 delta', 'taylor_green nx=400',
              'taylor_green wcsph nx=400', 'taylor_green wcsph nx=400 dense',
              'taylor_green gtvf nx=400', 'dam_break_3d dx=0.02 C4') + tuple(
                  'taylor_green wcsph %s nx=400' % name
                  for name in TIMED_OPTIONS) + WALL_PATHS + tuple(
                      EDAC_PATHS) + tuple(STEP_PATHS)


def configs(path):
    """The binning configurations ``path`` is timed under."""
    return ('reuse',) if path in REUSE_ONLY else tuple(CONFIGS)


def configure(app, config):
    """Set the binning configuration ``config`` (of ``CONFIGS``) on a set
    up app: the integrator's ``bin_every_eval`` and the grid's cell_slack
    (the grid re-sized to it)."""
    every, slack = CONFIGS[config]
    s = app.solver
    s.integrator.bin_every_eval = every
    if slack != s.grid.cell_slack:
        s.grid.resize(s.states.values(), cell_slack=slack)
    return app


def _tight_grid(s):
    """The drop ten times faster in a grid that just holds it."""
    st = s.states['fluid']
    st['u'] = st['u'] * 10.0
    st['v'] = st['v'] * 10.0
    width = s.grid.cell_slack * s.grid.radius_scale * float(
        st['h'].max())
    s.grid._set_dims([int(float(st[c].max() - st[c].min()) // width) + 1
                      for c in 'xy'] + [1])


#: the integrators that drive the WCSPH dam break's equations besides its
#: PEC: {integrator: (step class or None for the scheme's own, evals a
#: step)}
INTEGRATORS = {
    'EulerIntegrator': ('EulerStep', 1),
    'TVDRK3Integrator': (None, 3),
    'LeapFrogIntegrator': ('LeapFrogStep', 1),
    'PEFRLIntegrator': ('PEFRLStep', 4),
}


def integrated(name):
    """The ``dam_break_2d --scheme wcsph`` application class under the
    integrator ``name`` (of ``INTEGRATORS``), its arrays given the ``e``
    and ``ae`` that ``LeapFrogStep`` and ``PEFRLStep`` advance (the
    equations leave ``ae`` 0)."""
    step, _ = INTEGRATORS[name]

    class Integrated(DamBreak2D):
        def configure_scheme(self):
            super().configure_scheme()
            solver = self.scheme.get_solver()
            extra = None if step is None else {
                a: getattr(_steps, step)() for a in ('fluid', 'boundary')}
            self.scheme.configure_solver(
                integrator_cls=getattr(_integrator, name),
                extra_steppers=extra, kernel=solver.kernel,
                adaptive_timestep=True, n_damp=solver.n_damp, dt=solver.dt,
                tf=solver.tf, output_at_times=solver.output_at_times)

        def create_particles(self):
            arrays = super().create_particles()
            for pa in arrays:
                for p in ('e', 'ae'):
                    if p not in pa.properties:
                        pa.add_property(p)
            return arrays

    Integrated.__name__ = 'DamBreak2D' + name[:-len('Integrator')]
    return Integrated


def _moving(s):
    """Seeded normal fluid velocities of 3 m/s a component."""
    st = s.states['fluid']
    rng = np.random.default_rng(17)
    for c in 'uvw':
        st[c] = torch.as_tensor(rng.normal(0.0, 3.0, st[c].shape[0]),
                                dtype=st[c].dtype, device=st[c].device)


GATES.update({
    'dam_break_3d dx=0.04': (DamBreak3D, ('--dx', '0.04'), None),
    'dam_break_3d dx=0.04 moving': (DamBreak3D, ('--dx', '0.04'), _moving),
    'dam_break_3d dx=0.04 delta': (DamBreak3D, ('--dx', '0.04',
                                                '--delta-sph'), None),
    'dam_break_3d dx=0.04 dense delta': (
        DamBreak3D, ('--dx', '0.04', '--delta-sph', '--engine', 'dense'),
        None),
    'GTVF dx=0.02': (DamBreak2D, ('--scheme', 'gtvf', '--dx', '0.02'),
                     None),
    'dam_break_2d wcsph dx=0.02': (DamBreak2D, ('--dx', '0.02'), None),
    'elliptical_drop nx=40': (EllipticalDrop, ('--nx', '40'), _tight_grid),
    'taylor_green nx=40': (TaylorGreen, ('--nx', '40', '--perturb', '0.1'),
                           None),
    'taylor_green wcsph nx=40': (TaylorGreen, (
        '--nx', '40', '--perturb', '0.1', '--scheme', 'wcsph'), None),
    'taylor_green wcsph nx=40 dense': (TaylorGreen, (
        '--nx', '40', '--perturb', '0.1', '--scheme', 'wcsph', '--engine',
        'dense'), None),
    'taylor_green gtvf nx=40': (TaylorGreen, (
        '--nx', '40', '--perturb', '0.1', '--scheme', 'gtvf'), None),
    'cavity nx=20': (LidDrivenCavity, ('--nx', '20'), None),
    'poiseuille': (PoiseuilleFlow, (), None),
    'taylor_green edac nx=40': (TaylorGreen, (
        '--nx', '40', '--perturb', '0.1', '--scheme', 'edac'), None),
    'cavity edac nx=20': (LidDrivenCavity, ('--nx', '20', '--scheme',
                                            'edac'), None),
    'dam_break_2d edac dx=0.04': (DamBreak2D, ('--dx', '0.04', '--scheme',
                                               'edac'), None),
    'taylor_green iisph nx=40': (TaylorGreen, (
        '--nx', '40', '--perturb', '0.1', '--scheme', 'iisph'), None),
    'dam_break_2d iisph dx=0.04': (DamBreak2D, ('--dx', '0.04', '--scheme',
                                                'iisph'), None),
})
GATES.update({
    'dam_break_2d wcsph dx=0.02 %s' % name[:-len('Integrator')]: (
        integrated(name), ('--dx', '0.02'), None) for name in INTEGRATORS})
GATES.update({
    'taylor_green wcsph %s nx=40' % name: (TaylorGreen, (
        '--nx', '40', '--perturb', '0.1', '--scheme', 'wcsph') + flags, None)
    for name, flags in WCSPH_OPTIONS.items()})


def _gate_run(case, chunk_steps, device):
    """One run of a gate case; returns (solver, dumps, chunks): the
    (count, t) of each dump call and the (count before, after) of each
    chunk."""
    cls, extra, prepare = GATES[case]
    app = cls()
    app.setup(['--disable-output', '-q', '--use-double', '--device', device,
               '--max-steps', str(GATE_STEPS), *extra])
    s = app.solver
    s.n_damp = 0
    s.chunk_steps = chunk_steps
    if prepare is not None:
        prepare(s)
    # an output time between steps 5 and 6 of the first dt
    s.set_output_at_times([5.5 * s.dt])
    dumps, chunks = [], []
    dump, run_chunk = s.dump_output, s._run_chunk

    def record_dump():
        dumps.append((s.count, s.t))
        dump()

    def record_chunk():
        before = s.count
        run_chunk()
        chunks.append((before, s.count))

    s.dump_output, s._run_chunk = record_dump, record_chunk
    app.solve()
    return s, dumps, chunks


def gate(case, device='cuda'):
    """Chunked against per-step on a gate case; raises where they
    differ.  Returns a dict of what it held."""
    got, got_dumps, chunks = _gate_run(case, 10, device)
    want, want_dumps, _ = _gate_run(case, 1, device)
    if (got.count, got.t, got.dt, got.rebuilds) != (
            want.count, want.t, want.dt, want.rebuilds):
        raise AssertionError('%s: chunked count, t, dt, rebuilds %r, '
                             'per-step %r' % (
                                 case, (got.count, got.t, got.dt,
                                        got.rebuilds),
                                 (want.count, want.t, want.dt,
                                  want.rebuilds)))
    worst = 0.0
    for name, ref in want.states.items():
        for p, v in ref.items():
            mine = got.states[name][p]
            fin = torch.isfinite(v)
            if not (torch.equal(torch.isfinite(mine), fin) and
                    torch.equal(mine[~fin], v[~fin])):
                raise AssertionError('%s: non-finite entries of %s.%s differ'
                                     % (case, name, p))
            if not bool(fin.any()):
                continue
            scale = max(float(v[fin].abs().max()), 1e-300)
            err = float((mine[fin] - v[fin]).abs().max()) / scale
            worst = max(worst, err)
            if not err <= TOL:
                raise AssertionError('%s: %s.%s chunked against per-step %.3g'
                                     ' > %.0e scaled' % (case, name, p, err,
                                                         TOL))
    t_out = float(got.output_at_times[0])
    landed = [c for c, t in got_dumps if abs(t - t_out) < 1e-9 * t_out]
    if got_dumps != want_dumps or len(landed) != 1 or not any(
            a < landed[0] - 1 and b == landed[0] for a, b in chunks):
        raise AssertionError('%s: no landing on %g inside a chunk (dumps '
                             '%s, %s; chunks %s)' % (case, t_out, got_dumps,
                                                     want_dumps, chunks))
    # on the card, one replay a chunk, and the chunk captured again after
    # each grow and each redo
    graphs = 1 + got.grid.grows + got.redos if device == 'cuda' else 0
    if GATES[case][0] is EllipticalDrop and got.grid.grows < 1 or \
            got.captures != graphs or \
            got.replays != (len(chunks) if graphs else 0):
        raise AssertionError('%s: %d grows, %d captures, %d replays of %d '
                             'chunks' % (case, got.grid.grows, got.captures,
                                         got.replays, len(chunks)))
    n = sum(st['x'].shape[0] for st in got.states.values())
    return dict(case=case, particles=n, steps=got.count, t=got.t,
                max_scaled_err=worst, landing_step=landed[0],
                chunks=len(chunks), captures=got.captures,
                replays=got.replays, reads=got.reads, grows=got.grid.grows,
                redos=got.redos, rebuilds=got.rebuilds,
                per_step_reads=want.reads)


def timed_solve(app, chunk_steps, warmup=WARMUP):
    """(median ms/step, [ms/step samples]) of ``app.solve()`` under
    ``chunk_steps``.  Per step: the host clock at each step's start, the
    card synchronised there (a pre-step callback, which keeps the run on
    the per-step loop anyway), one sample a step.  In chunks: the host
    clock after each chunk's read, which waits for the card, one sample
    a chunk over the chunks that replay a graph captured before them
    (the capture, the damped steps and setup drop out).  Samples start at
    step ``warmup``."""
    s = app.solver
    s.chunk_steps = chunk_steps
    stamps = []
    if chunk_steps == 1:
        def pre_step(solver):
            torch.cuda.synchronize()
            stamps.append((time.perf_counter(), solver.count, 0))
        s.add_pre_step_callback(pre_step)
    else:
        run_chunk = s._run_chunk

        def timed_chunk():
            run_chunk()
            stamps.append((time.perf_counter(), s.count, s.captures))
        s._run_chunk = timed_chunk
    app.solve()
    torch.cuda.synchronize()
    samples = [(b[0] - a[0]) / (b[1] - a[1]) * 1e3
               for a, b in zip(stamps, stamps[1:])
               if a[1] >= warmup and b[1] > a[1] and a[2] == b[2]]
    return float(np.median(samples)), samples


def main(label=''):
    smi = common.require_cuda()
    rows = []
    for case in GATES:
        row = dict(label=label, card=smi, **gate(case))
        print(json.dumps(row), flush=True)
        rows.append(row)
    for path, kw in PATHS.items():
        if path in STEP_PATHS:
            continue
        for config in configs(path):
            row = dict(label=label, card=smi, path=path, config=config,
                       steps=STEPS)
            for k in (10, 1):
                app = configure(make_app(dtype=torch.float32, steps=STEPS,
                                         **kw), config)
                ms, samples = timed_solve(app, k)
                s = app.solver
                n = sum(st['x'].shape[0] for st in s.states.values())
                row['chunk_steps=%d' % k] = dict(
                    ms_per_step=ms, min=min(samples), max=max(samples),
                    samples=len(samples), particle_steps_per_s=n / ms * 1e3,
                    captures=s.captures, replays=s.replays, reads=s.reads,
                    rebuilds=s.rebuilds)
                del app, s
            print(json.dumps(row), flush=True)
            rows.append(row)
    for path, kw in STEP_PATHS.items():
        row = dict(label=label, card=smi, path=path, config='reuse',
                   steps=STEPS)
        for k in (10, 1):
            app = make_app(dtype=torch.float32, steps=STEPS, **kw)
            iisph_solve.launches = 0
            ms, samples = timed_solve(app, k)
            s = app.solver
            sweeps = [n for a in s.acceleration_evals for n in a.sweeps]
            row['chunk_steps=%d' % k] = dict(
                ms_per_step=ms, min=min(samples), max=max(samples),
                samples=len(samples), steps=s.count, sweeps=sweeps,
                solve_launches=iisph_solve.launches,
                converged_reads=sum(a.converged_reads
                                    for a in s.acceleration_evals),
                captures=s.captures, replays=s.replays, reads=s.reads,
                rebuilds=s.rebuilds)
            del app, s
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == '__main__':
    main(sys.argv[1] if len(sys.argv) > 1 else '')
