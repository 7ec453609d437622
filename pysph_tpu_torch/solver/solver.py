"""The Solver: the time loop (port of ``pysph_tpu/solver/solver.py``).

The loop steps with adaptive and damped dt, ``max_steps`` and output: a
dump ``<fname>_<count>`` (hdf5 or npz, ``solver/output.py``) into
``output_directory`` before the first step, every ``pfreq`` steps, at
each of ``output_at_times`` (dt is shortened to land on them) and at the
end.  The particle state is a dict of per-array tensor dicts on the
configured device; the host arrays are refreshed for each dump and at
the end of ``solve``.

Steps run in chunks of ``chunk_steps`` (K, 10 as in the JAX solver),
the counterpart of its ``lax.scan`` chunk: ``t``, ``dt`` and the step
count stay on the device as float64 0-d tensors, and the host reads one
small tensor a chunk (t, dt, the uncapped dt, the steps done, the
grid's overflow flag and the count of binnings that ran).  On a CUDA
device the K steps are captured once into one CUDA graph and each chunk
is one replay; on the CPU the same code runs eagerly.  A chunk runs
where the JAX solver runs one: K > 1, ``count >= n_damp`` (the damped
steps stay on the host), no dt shortened for an output time pending,
no pre-step or post-stage callback, and, where chunks are CUDA graphs,
no iterated group that sweeps on the host (its ``converged`` is read
once a sweep, and a graph would replay one sweep count): IISPH's
pressure solve runs its sweeps in one ``iisph_solve`` launch, the loop
condition on the card, and ``GasDScheme``'s density iteration its
sweeps in slots gated on the card (``AccelerationEval._run_swept``;
``AccelerationEval.host_iterated``).  Elsewhere the per-step loop
runs, reading dt (and the overflow flag) once a step with adaptive dt,
the flag every ``GROW_CHECK_STEPS`` steps with a fixed one;
``chunk_steps = 1`` is that loop throughout.  The first ineligible step
of each reason is logged at INFO.

A chunk takes the same decisions as the per-step loop, in the same
float64 arithmetic, so both give the same bits: the chunk's length is
``min(K, steps to the next pfreq dump, steps to max_steps)``; on the
device each step lands on ``tf`` and on the next output time as the
host would, and an iteration past the length, past ``tf``, after
reaching the output time or after a binning flagged particles beyond
the grid is inactive: every state tensor is written back from a select
on the device's ``active`` flag, so it stays bit-identical, t and the
count stay, and no binning runs (the integrator's reuse test rebuilds
only where ``stale & active``, so the reference positions move where
the per-step loop moves them).  The binning handles live in the
integrator across steps and chunks; a binning that kept its lists
reports no overflow.  After the read the host dumps where due and grows
the grid (``CellGrid.grow``) if a binning of the chunk overflowed;
between the overflow and the grow, escaped particles are clamped into
the edge cells (correct, only slower), as in the per-step loop.

Capture (CUDA): the graph reads and writes static state tensors, which
``solver.states`` keeps across replays; a state tensor the host replaced
between chunks is copied into its static one first.  The chunk is
captured again after a grow (``ncells`` sizes the cell lists) and
wherever a constant baked into the graph changes (K, tf, cfl, adaptive
dt, the torch engine's capacities); each capture follows one inactive
warm-up step on a side stream, which makes what a first call allocates
or copies (the grid's limits after a grow) outside the capture.
``captures``, ``replays`` and ``reads`` count, and ``rebuilds`` the binnings that ran (read with each
chunk and at the end of ``solve``).  A capture or replay that fails
raises.  The launch counters of the kernel wrappers count Python calls,
so under capture they count a chunk's launches once, at capture:
launches on the card are (launches a capture) x replays plus the eager
ones.

The torch pair engine builds its lists at capacities held on the host
(``CellGrid.pair_capacity``; the first sized by the initial eval), so a
step on it captures like any other.  A list past its capacity drops
pairs, which changes the result (a grid overflow only clamps), so such
a step is redone, as the JAX solver redoes one: where a dest is on that
engine, the state before the chunk (or step) is kept (the state tensors,
the binning handles, the count of binnings), the chunk's read carries
the flag beside ``GROW`` (the per-step loop reads it after each step),
and after an overflow the host puts the state back, grows the
capacities (``CellGrid.grow_pairs``, one more read) and runs the chunk
again, captured anew; t, dt and the count are the host's from before it.
An evaluation of a chunk whose density iteration would sweep past its
slots sets the grid's ``sweep_overflow``; the chunk's read carries it
(``SWEEPS``), and the host puts the state back (the evaluators' own
binnings too), doubles the slots and runs the chunk again, as after a
dropped pair list, unless a binning of the chunk met a state that is
not finite (which never converges): that raises first.  Where an
equation writes h on a periodic grid (``CellGrid.keeps_width``), each
binning that the evaluators keep (``sph/acceleration_eval.py::Binning``:
the step's, and each ``update_nnps`` group's) has periodic counts of its
own and keeps its widest binning: a step where one outgrew its periodic
cells summed on cells that miss pairs, so the chunk stops after it, its
read carries one width a binning (``WIDE``, read with the carry in one
read; the per-step loop reads them after each step), and the host puts
the state back, sizes that binning for its width and runs the chunk (or
step) again; a binning whose widest over the last ``RESIZE_STEPS`` steps
fits about half its cells or less (``cell_grid.SHRINK``) is sized down
for it after the step (or chunk) that ends them, with no redo: where
binnings keep widths a chunk ends at each multiple of ``RESIZE_STEPS``,
and both loops decide at the same counts on the same widths, so that
they give the same bits
(``acceleration_eval.shrink_binnings``), and the next chunk is captured
at the new counts.  ``redos`` counts all three.

A binning that met a position or h that is not finite bins nothing and
sets the grid's ``nonfinite`` flag, which the chunk's read carries
(``BAD``) and the per-step loop reads with dt and the grow flag:
``FloatingPointError`` is raised there.
"""

import gc
import logging
import math
import os

import numpy as np
import torch

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.kernels import CubicSpline
from pysph_tpu_torch.sph.acceleration_eval import (
    grow_binnings, shrink_binnings, sized_binnings)
from pysph_tpu_torch.solver.output import dump
from pysph_tpu_torch.solver.utils import mkdir

logger = logging.getLogger(__name__)

EPSILON = 1e-14
#: steps between two reads of the grid's overflow flag where dt is fixed
#: (the per-step loop; a chunk reads it once)
GROW_CHECK_STEPS = 20
#: steps over which a binning's widths are kept before it may be sized
#: down (at each multiple of it, in both loops)
RESIZE_STEPS = 10
#: the chunk's device carry: float64 slots of ``Solver._carry``, then
#: (``WIDE`` on) the widest binning of each ``Binning`` that keeps one
(T, DT, DT_UN, COUNT, N_REAL, T_OUT, DONE, GROW, REBUILDS, PAIRS, SWEEPS,
 BAD, WIDE) = range(13)
N_CARRY = WIDE


class Solver(object):
    def __init__(self, dim=2, integrator=None, kernel=None, n_damp=0,
                 tf=1.0, dt=1e-3, adaptive_timestep=False, cfl=0.3,
                 output_at_times=(), fixed_h=False):
        self.integrator = integrator
        self.dim = dim
        self.kernel = kernel if kernel is not None else CubicSpline(dim)
        self.particles = None
        self.acceleration_evals = None
        self.grid = None
        self.config = None
        #: the DomainManager of ``set_domain``, or None
        self.domain = None
        self.t = 0.0
        self.count = 0
        self.pre_step_callbacks = []
        # kept as the reference's solver keeps it; no ported equation
        # changes h, so nothing reads it
        self.fixed_h = fixed_h
        self.pfreq = 100
        self.disable_output = False
        self.fname = self.__class__.__name__
        self.output_directory = self.fname + '_output'
        self.n_damp = n_damp
        self.adaptive_timestep = adaptive_timestep
        self.cfl = cfl
        self.output_at_times = np.asarray(output_at_times)
        self.tf = tf
        self.dt = dt
        self.max_steps = 1 << 31
        #: steps a chunk (1: the per-step loop)
        self.chunk_steps = 10
        #: chunk graphs captured, chunk graphs replayed, and the time
        #: loop's device-to-host reads (a chunk's, a step's dt and flag,
        #: a grow's box)
        self.captures = 0
        self.replays = 0
        self.reads = 0
        #: binnings that ran (the integrator's device count, as last read)
        self.rebuilds = 0
        #: chunks and steps run again after a torch engine pair list
        #: overflowed or an evaluation ran out of sweep slots
        self.redos = 0
        self.states = None
        self._prev_dt = None
        self._damping_factor = 1.0
        self._epsilon = EPSILON * tf
        self._carry = None
        self._static = self._static_layout = None
        self._graph = None
        self._graph_key = None
        self._logged = set()
        #: the binnings whose widths the chunk's ``_wide`` holds, in order
        self._wide_of = []
        self._wide = None
        #: {Binning: its widest binning since the last multiple of
        #: RESIZE_STEPS} (host floats)
        self._window = {}

    def setup(self, particles, equations, config):
        """Build the evaluators (one per stage of ``MultiStageEquations``,
        all on one ``CellGrid``, periodic on the axes of the domain of
        ``set_domain``) against the particles and move them to
        ``config.device``."""
        from pysph_tpu_torch.sph.acceleration_eval import (
            make_acceleration_evals)
        self.particles = particles
        self.config = config
        self.grid = CellGrid.from_particles(
            particles, dim=self.dim, radius_scale=self.kernel.radius_scale,
            domain=self.domain)
        self.acceleration_evals = make_acceleration_evals(
            particles, equations, self.kernel, config, self.grid)
        self.integrator.set_acceleration_evals(self.acceleration_evals)
        if self.domain is not None:
            self.integrator.set_domain(self.domain)
        self._sync_to_device()

    def set_domain(self, domain):
        """The simulation box (a ``DomainManager``), handed to the grid,
        the evaluators and the integrator (which wraps the positions
        after each stage) at ``setup``."""
        self.domain = domain

    def _sync_to_device(self):
        self.states = {pa.name: pa.to_device(self.config)
                       for pa in self.particles}

    def _sync_to_host(self):
        for pa in self.particles:
            pa.update_from_device(self.states[pa.name])

    # -- configuration -------------------------------------------------
    def add_pre_step_callback(self, callback):
        self.pre_step_callbacks.append(callback)

    def add_post_stage_callback(self, callback):
        """``callback(t, dt, stage)`` after each integrator stage (the
        last one added; a run with one steps in the per-step loop)."""
        self.integrator.set_post_stage_callback(callback)

    def set_final_time(self, tf):
        self.tf = tf
        self._epsilon = EPSILON * tf

    def set_print_freq(self, n):
        self.pfreq = n

    def set_output_fname(self, fname):
        self.fname = fname

    def set_output_directory(self, path):
        self.output_directory = path

    def set_output_at_times(self, output_at_times):
        self.output_at_times = np.asarray(output_at_times)

    # -- the time loop -------------------------------------------------
    def solve(self):
        self._epsilon = EPSILON * self.tf
        self.dump_output()
        self.integrator.initial_acceleration(self.states, self.t, self.dt)
        self.dt = self._get_timestep()

        while ((self.tf - self.t) > self._epsilon and
               self.count < self.max_steps):
            if self._chunk_eligible():
                self._run_chunk()
                continue
            for callback in self.pre_step_callbacks:
                callback(self)
            self._step()
            self.t += self.dt
            self.count += 1
            self._epsilon = EPSILON * self.tf * self.count
            self.dt = self._get_timestep()
            self._dump_output_if_needed()
            logger.debug('step %d t=%.6g dt=%.6g', self.count, self.t,
                         self.dt)

        self.rebuilds = int(self.integrator.rebuilds)
        self._sync_to_host()
        self.dump_output()

    # -- the K-step chunk ----------------------------------------------
    def _log_once(self, reason):
        if reason not in self._logged:
            self._logged.add(reason)
            logger.info('step %d: %s', self.count, reason)

    def _chunk_eligible(self):
        """Whether the next steps run as a chunk (the JAX solver's
        conditions); logs the first step of each reason that they do
        not."""
        for failed, reason in (
                (self.chunk_steps <= 1, 'chunk_steps <= 1'),
                (self.count < self.n_damp, 'damped steps (count < n_damp)'),
                (self._prev_dt is not None,
                 'a dt shortened for an output time'),
                (self.pre_step_callbacks, 'a pre-step callback'),
                (self.integrator.post_stage_callback is not None,
                 'a post-stage callback'),
                # converged read on the host once a sweep: a graph would
                # replay one sweep count; an iisph_solve and the gated
                # density sweeps (gasd_sweep, tsph_sweep) sweep on the card
                (self._graphed() and any(
                    a.host_iterated for a in self.acceleration_evals),
                 'an iterated group that no iisph_solve plan takes (nor '
                 'a gasd_sweep or tsph_sweep plan)')):
            if failed:
                self._log_once('per-step loop: %s' % reason)
                return False
        return True

    def _graphed(self):
        """Whether chunks are CUDA graphs: on a CUDA device."""
        return self.config.device.type == 'cuda'

    def _step(self):
        """One step of the per-step loop, redone from the state before it
        with the capacities grown where a torch engine pair list
        overflowed, or a binning re-sized where h outgrew its periodic
        cells (where a dest is on that engine or an equation writes h on
        a periodic grid: one read a step); a binning that fits about half its
        cells or less is sized down after it."""
        grid = self.grid
        wide = self._watch_width()
        if not (grid.pair_caps or wide):
            self.integrator.step(self.states, self.t, self.dt)
            return
        saved = self._save()
        zero = torch.zeros((), dtype=torch.float64, device=self.config.device)
        while True:
            grid.watch_pairs()
            for b in self._binnings():
                b.clear()
            self.integrator.step(self.states, self.t, self.dt)
            binnings = self._binnings()
            flag = grid.pair_overflow
            grid.pair_overflow = None
            vals = torch.stack([zero if flag is None else flag.to(zero.dtype)]
                               + [b.widest for b in binnings]).tolist()
            self.reads += 1
            grown = wide and grow_binnings(grid, binnings, vals[1:],
                                           'step %d' % self.count)
            if not vals[0] and not grown:
                self._note_widths(binnings, vals[1:], self.count + 1)
                return
            self._redo(saved, 'step', pairs=bool(vals[0]))

    def _note_widths(self, binnings, widths, count):
        """Keep the widest binnings of a step or chunk that stands, which
        ended at ``count``; at a multiple of ``RESIZE_STEPS`` size down
        the binnings whose widest since the last fits about half their cells
        (``shrink_binnings``)."""
        for b, w in zip(binnings, widths):
            self._window[b] = max(self._window.get(b, 0.0), w)
        if count % RESIZE_STEPS == 0:
            window, self._window = self._window, {}
            shrink_binnings(self.grid, list(window), list(window.values()),
                            'step %d' % count)

    def _binnings(self):
        """The evaluators' ``Binning``s that keep a width, in order."""
        return sized_binnings(self.acceleration_evals)

    def _save(self):
        """What a redo puts back: copies of the states (a chunk writes
        its static tensors in place) and of the binning handles (the
        evaluators' own too), the count of binnings and the grid's
        overflow flag."""
        ig = self.integrator
        states = {name: {p: v.clone() for p, v in st.items()}
                  for name, st in self.states.items()}
        handles = {i: (h, h.save()) for i, h in ig.handles.items()}
        rebuilds = None if ig.rebuilds is None else ig.rebuilds.clone()
        own = [a.nnps_state() for a in self.acceleration_evals]
        return states, handles, rebuilds, self.grid.overflow, own

    def _redo(self, saved, what, pairs=False, slots=False):
        """Put back what ``_save`` kept (a chunk's next run copies the
        states into its static tensors; a binning re-sized for an h that
        outgrew its cells bins anew at its new counts), double the sweep
        slots with ``slots``, and grow the torch engine's capacities that
        a list outgrew with ``pairs`` (one read)."""
        states, handles, rebuilds, overflow, own = saved
        for a_eval, kept in zip(self.acceleration_evals, own):
            a_eval.restore_nnps(kept)
        for name, st in self.states.items():
            st.clear()
            st.update(states[name])
        ig = self.integrator
        ig.handles = {i: h for i, (h, _) in handles.items()}
        for h, kept in handles.values():
            h.restore(kept)
        if rebuilds is not None:
            ig.rebuilds.copy_(rebuilds)
        self.grid.overflow = overflow
        # a binning of what the redo drops that was not finite does not
        # count (the run again meets it where it is real)
        if self.grid.nonfinite is not None:
            self.grid.nonfinite.zero_()
        self.redos += 1
        if slots:
            grown = [[p.grow() for p in a.sweep_plans()]
                     for a in self.acceleration_evals]
            logger.info('step %d: an evaluation ran out of sweep slots; '
                        'slots grown to %s, the %s run again', self.count,
                        grown, what)
        if pairs:
            grown = self.grid.grow_pairs()
            self.reads += 1
            logger.info('step %d: a torch engine pair list overflowed; '
                        'capacities grown to %s, the %s run again',
                        self.count, grown, what)

    def _next_output_time(self):
        """The first output time more than epsilon after t (inf if
        none): the one a chunk may land on."""
        ahead = self.output_at_times[self.output_at_times - self.t >
                                     self._epsilon]
        return float(np.min(ahead)) if len(ahead) else math.inf

    def _run_chunk(self):
        """One chunk: up to K steps with t and dt on the device, then one
        read and the host's part of the steps (grow, dump)."""
        n_real = min(self.chunk_steps, self.pfreq - self.count % self.pfreq,
                     self.max_steps - self.count)
        if self._watch_width():
            n_real = min(n_real, RESIZE_STEPS - self.count % RESIZE_STEPS)
        self._bind_static()
        inputs = [0.0] * N_CARRY
        inputs[T], inputs[DT], inputs[DT_UN] = self.t, self.dt, self.dt
        inputs[COUNT], inputs[N_REAL] = self.count, n_real
        inputs[T_OUT] = self._next_output_time()
        graph = self._captured_chunk() if self._graphed() else None
        wide = self._watch_width()
        saved = self._save() if self.grid.pair_caps or self._swept() or \
            wide else None
        self._carry.copy_(torch.tensor(inputs, dtype=torch.float64))
        if graph is not None:
            graph.replay()
            self.replays += 1
        else:
            self._chunk_body(self.chunk_steps)
        # the chunk's binnings ran inside it (in a graph's memory on CUDA)
        self.grid.overflow = None
        # the chunk's one read: the carry and the binnings' widths
        vals = (self._carry if self._wide is None else
                torch.cat([self._carry, self._wide])).tolist()
        self.reads += 1
        # a binning that outgrew its cells is re-sized for a redo; else one
        # that fits about half of them or less is sized down
        grown = wide and grow_binnings(self.grid, self._wide_of, vals[WIDE:],
                                       'step %d' % self.count)
        if vals[PAIRS] or grown:
            # the loop runs the chunk again, captured at the new sizes
            self._redo(saved, 'chunk', pairs=bool(vals[PAIRS]))
            return
        # a state that is not finite never converges: raise before more
        # slots are tried (they cannot make it finite)
        self.grid.check_finite(bool(vals[BAD]))
        if vals[SWEEPS]:
            self._redo(saved, 'chunk', slots=True)
            return
        self.t, self.dt = vals[T], vals[DT]
        self.count = int(vals[COUNT])
        self.rebuilds = int(vals[REBUILDS])
        self._epsilon = EPSILON * self.tf * self.count
        # the last step set a dt to land on an output time: resume with
        # the uncapped one after it, as the per-step loop does
        self._prev_dt = vals[DT_UN] if vals[DT] != vals[DT_UN] else None
        if wide:
            self._note_widths(self._wide_of, vals[WIDE:], self.count)
        if vals[GROW]:
            self._grow()
        self._dump_output_if_needed()
        logger.debug('chunk of %d steps to step %d t=%.6g dt=%.6g',
                     int(vals[DONE]), self.count, self.t, self.dt)

    def _bind_static(self):
        """Make the states' tensors the chunk's static ones: the first
        time (or when the state's layout changed) take the current ones
        and drop the graph; later, copy a tensor the host replaced since
        the last chunk into its static one."""
        layout = {name: {p: (v.shape, v.dtype) for p, v in st.items()}
                  for name, st in self.states.items()}
        if self._static is None or layout != self._static_layout:
            seen = set()
            for st in self.states.values():
                for p, v in st.items():
                    if id(v) in seen:       # one tensor under two names
                        st[p] = v = v.clone()
                    seen.add(id(v))
            self._static = {name: dict(st)
                            for name, st in self.states.items()}
            self._static_layout = layout
            device = self.config.device
            self._carry = torch.zeros(N_CARRY, dtype=torch.float64,
                                      device=device)
            self._graph = self._graph_key = None
            return
        for name, st in self.states.items():
            static = self._static[name]
            for p, v in st.items():
                if v is not static[p]:
                    static[p].copy_(v)
                    st[p] = static[p]

    def _write_back(self, active):
        """Write the step's new state tensors into the static ones where
        ``active`` (a 0-d device bool) is set, keep the static ones'
        values elsewhere, and put the static tensors back in the
        states."""
        new = []
        for name, st in self.states.items():
            static = self._static[name]
            for p, v in st.items():
                s = static.get(p)
                if s is None:
                    raise RuntimeError('a step added %s.%s: a chunk needs a '
                                       'fixed set of state tensors'
                                       % (name, p))
                if v is not s:
                    new.append((s, torch.where(active, v, s)))
                    st[p] = s
        for s, v in new:
            s.copy_(v)

    def _chunk_body(self, iters):
        """``iters`` steps from the carry (``_carry``: t, dt, its uncapped
        value, the count, the chunk's length and the next output time),
        each deciding on the device what the per-step loop decides on
        the host; writes back t, dt, the uncapped dt, the count, the
        steps done, whether a binning overflowed, the binnings run and
        whether a torch engine pair list overflowed, whether an evaluation
        ran out of sweep slots and whether a binning met a state that is
        not finite, and (into ``_wide``) each ``Binning``'s widest, where
        kept (the chunk stops after a step whose list overflowed, whose
        sweeps ran short or where a binning's h outgrew its periodic
        cells)."""
        c = self._carry
        t, dt, dt_un, count, n_real, t_out = (c[T], c[DT], c[DT_UN],
                                              c[COUNT], c[N_REAL], c[T_OUT])
        tf = self.tf
        eps_unit = EPSILON * tf
        wdt = self.config.dtype
        active = n_real > 0
        done = torch.zeros_like(t)
        grow = torch.zeros_like(active)
        pairs = torch.zeros_like(active)
        short = torch.zeros_like(active)
        watch = bool(self.grid.pair_caps)
        swept = self._swept()
        wide = self._watch_width()
        # an inactive step bins nothing, so a width only grows where active
        for b in self._binnings():
            b.clear()
        for i in range(iters):
            self.grid.overflow_any = torch.zeros_like(active)
            if watch:
                self.grid.pair_overflow = torch.zeros_like(active)
            if swept:
                self.grid.sweep_overflow = torch.zeros_like(active)
            self.integrator.step(self.states, t, dt, active)
            ovf = self.grid.overflow_any
            self.grid.overflow_any = None
            stop = ovf
            if wide:
                for b in self._binnings():
                    stop = stop | b.cells(self.grid).cells_small(b.widest)
            if watch:
                stop = stop | self.grid.pair_overflow
                pairs = pairs | (active & self.grid.pair_overflow)
                self.grid.pair_overflow = None
            if swept:
                stop = stop | self.grid.sweep_overflow
                short = short | self.grid.sweep_overflow
                self.grid.sweep_overflow = None
            self._write_back(active)
            t1 = t + dt
            c1 = count + 1
            eps = eps_unit * c1
            at_tf = (tf - t1).abs() < eps
            # _get_timestep: the adaptive dt (dt_un where nothing
            # constrains it), capped at tf
            raw = dt_un
            if self.adaptive_timestep:
                adapted = self.integrator.compute_time_step(
                    self.states, dt_un.to(wdt), self.cfl)
                if adapted is not None:
                    raw = adapted.to(torch.float64)
            raw = torch.where(t1 + raw > tf, tf - t1, raw)
            dt_next_un = torch.where(at_tf, dt, raw)
            # _dump_output_if_needed: land on the next output time
            tdiff = t_out - t1
            land = ~at_tf & (tdiff > 0.0) & (tdiff < dt_next_un) & \
                (tdiff.abs() > eps)
            dt_next = torch.where(land, tdiff, dt_next_un)
            t = torch.where(active, t1, t)
            count = torch.where(active, c1, count)
            dt = torch.where(active, dt_next, dt)
            dt_un = torch.where(active, dt_next_un, dt_un)
            done = done + active
            grow = grow | (active & ovf)
            # the next iteration runs if the loop would run it without a
            # dump, a grow or a redo on the host first
            active = active & (n_real > i + 1) & ((tf - t1) > eps) & \
                ~(tdiff.abs() < eps) & ~stop
        bad = self.grid.nonfinite_flag(c.device)
        c.copy_(torch.stack([t, dt, dt_un, count, n_real, t_out, done,
                             grow.to(torch.float64),
                             self.integrator.rebuilds,
                             pairs.to(torch.float64),
                             short.to(torch.float64),
                             bad.to(torch.float64)]))
        self._wide_of = self._binnings() if wide else []
        self._wide = torch.stack([b.widest for b in self._wide_of]) \
            if self._wide_of else None

    def _captured_chunk(self):
        """The CUDA graph of a chunk, captured again where what it bakes
        in changed (the grid's counts and each binning's, the torch
        engine's capacities)."""
        key = (self.chunk_steps, self.tf, self.cfl, self.adaptive_timestep,
               self.grid.dims, self.grid.pair_key(),
               tuple(a.sweep_key() for a in self.acceleration_evals),
               tuple(b.cells(self.grid).dims for b in self._binnings()))
        if self._graph is not None and self._graph_key == key:
            return self._graph
        self._graph = None
        # an inactive step (N_REAL = 0) leaves the state as it is
        self._carry.zero_()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._chunk_body(1)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # a dead solver's graph that the collector frees inside the
        # capture resets it there, which invalidates the capture: collect
        # before, not during it
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self._chunk_body(self.chunk_steps)
        finally:
            gc.enable()
        self.captures += 1
        self._graph, self._graph_key = graph, key
        return graph

    def _watch_width(self):
        """Whether the binnings keep their widest width and counts of
        their own (``CellGrid.keeps_width``): a periodic grid where an
        equation writes h."""
        return self.grid.keeps_width

    def _swept(self):
        """Whether an evaluator sweeps an iterated group in slots."""
        return any(a.sweep_plans() for a in self.acceleration_evals)

    def _grow(self):
        self.grid.grow(self.states.values())
        self.reads += 1
        logger.info('step %d: particles left the cell grid; grown to %s',
                    self.count, self.grid.dims)

    # -- timestep helpers ----------------------------------------------
    def _get_undamped_timestep(self):
        if self._prev_dt is not None:
            dt = self._prev_dt
            self._prev_dt = None
        else:
            dt = self.dt / self._damping_factor
        return dt

    def _compute_timestep(self):
        """The next dt; grows the grid if a binning since the last grow
        overflowed."""
        undamped = self._get_undamped_timestep()
        flag = self.grid.overflow
        bad = self.grid.nonfinite_flag(flag.device)
        dt = None
        if self.adaptive_timestep:
            dt = self.integrator.compute_time_step(self.states, undamped,
                                                   self.cfl)
        if dt is not None:
            # one device-to-host copy for all three
            dt, grow, nonfinite = torch.stack(
                [dt, flag.to(dt.dtype), bad.to(dt.dtype)]).tolist()
            self.reads += 1
        else:
            dt = undamped
            grow = nonfinite = False
            if self.count % GROW_CHECK_STEPS == 0:
                grow, nonfinite = torch.stack([flag, bad]).tolist()
                self.reads += 1
        self.grid.check_finite(nonfinite)
        if grow:
            self._grow()
        return dt

    def _damp_timestep(self, dt):
        n_damp = self.n_damp
        if self.count < n_damp and n_damp > 0:
            frac = (self.count + 1) / float(n_damp)
            self._damping_factor = 0.5 * (
                np.sin(np.pi * (-0.5 + frac)) + 1.0)
        else:
            self._damping_factor = 1.0
        return dt * self._damping_factor

    def _get_timestep(self):
        if abs(self.tf - self.t) < self._epsilon:
            return self.dt
        dt = self._compute_timestep()
        dt = self._damp_timestep(dt)
        if self.t + dt > self.tf:
            dt = self.tf - self.t
        return dt

    # -- output --------------------------------------------------------
    def _get_solver_data(self):
        dt = self._prev_dt if self._prev_dt is not None else self.dt
        return {'dt': dt / self._damping_factor, 't': self.t,
                'count': self.count}

    def dump_output(self):
        """Write ``<output_directory>/<fname>_<count:05d>`` from the
        device state (a sync point)."""
        if self.disable_output:
            return
        self._sync_to_host()
        mkdir(self.output_directory)
        fname = os.path.join(self.output_directory,
                             '%s_%05d' % (self.fname, self.count))
        dump(fname, self.particles, self._get_solver_data())

    def _dump_output_if_needed(self):
        """Dump every ``pfreq`` steps and at each of ``output_at_times``,
        and shorten dt to land exactly on the next of them."""
        if abs(self.t - self.tf) < self._epsilon:
            return
        due = self.count % self.pfreq == 0
        tdiff = self.output_at_times - self.t
        if len(tdiff):
            if np.any(np.abs(tdiff) < self._epsilon):
                due = True
            too_big = (tdiff > 0.0) & (tdiff < self.dt)
            if np.any(too_big):
                indices = np.where(too_big)[0]
                output_time = self.output_at_times[indices[0]]
                if (abs(output_time - self.t) < self._epsilon and
                        len(indices) > 1):
                    output_time = self.output_at_times[indices[1]]
                if abs(output_time - self.t) > self._epsilon:
                    self._prev_dt = self.dt
                    self.dt = float(output_time - self.t)
        if due:
            self.dump_output()
