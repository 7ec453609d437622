"""The Solver: the time loop (port of ``pysph_tpu/solver/solver.py``).

A plain Python loop over eager integrator steps, with adaptive and
damped dt, ``max_steps`` and output: a dump ``<fname>_<count>`` (hdf5 or
npz, ``solver/output.py``) into ``output_directory`` before the first
step, every ``pfreq`` steps, at each of ``output_at_times`` (dt is
shortened to land on them) and at the end.  The particle state is a dict
of per-array tensor dicts on the configured device; the host arrays are
refreshed for each dump and at the end of ``solve``.  Adaptive dt costs
one device-to-host copy per step, a dump one copy of the state.

The evaluators share one ``CellGrid``, whose binnings flag particles
beyond its cells (``CellGrid.overflow``); the solver grows the grid when
the flag is set.  With adaptive dt the flag rides on the dt's copy, so
a step still reads the device once; with a fixed dt the solver reads it
every ``GROW_CHECK_STEPS`` steps.  Between reads, escaped particles are
clamped into the edge cells, which is slower but correct.
"""

import logging
import os

import numpy as np
import torch

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.kernels import CubicSpline
from pysph_tpu_torch.solver.output import dump
from pysph_tpu_torch.solver.utils import mkdir

logger = logging.getLogger(__name__)

EPSILON = 1e-14
#: steps between two reads of the grid's overflow flag where dt is fixed
GROW_CHECK_STEPS = 20


class Solver(object):
    def __init__(self, dim=2, integrator=None, kernel=None, n_damp=0,
                 tf=1.0, dt=1e-3, adaptive_timestep=False, cfl=0.3,
                 output_at_times=()):
        self.integrator = integrator
        self.dim = dim
        self.kernel = kernel if kernel is not None else CubicSpline(dim)
        self.particles = None
        self.acceleration_evals = None
        self.grid = None
        self.config = None
        self.t = 0.0
        self.count = 0
        self.pre_step_callbacks = []
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
        self.states = None
        self._prev_dt = None
        self._damping_factor = 1.0
        self._epsilon = EPSILON * tf

    def setup(self, particles, equations, config):
        """Build the evaluators (one per stage of ``MultiStageEquations``,
        all on one ``CellGrid``) against the particles and move them to
        ``config.device``."""
        from pysph_tpu_torch.sph.acceleration_eval import (
            make_acceleration_evals)
        self.particles = particles
        self.config = config
        self.grid = CellGrid.from_particles(
            particles, dim=self.dim, radius_scale=self.kernel.radius_scale)
        self.acceleration_evals = make_acceleration_evals(
            particles, equations, self.kernel, config, self.grid)
        self.integrator.set_acceleration_evals(self.acceleration_evals)
        self._sync_to_device()

    def _sync_to_device(self):
        self.states = {pa.name: pa.to_device(self.config)
                       for pa in self.particles}

    def _sync_to_host(self):
        for pa in self.particles:
            pa.update_from_device(self.states[pa.name])

    # -- configuration -------------------------------------------------
    def add_pre_step_callback(self, callback):
        self.pre_step_callbacks.append(callback)

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
            for callback in self.pre_step_callbacks:
                callback(self)
            self.integrator.step(self.states, self.t, self.dt)
            self.t += self.dt
            self.count += 1
            self._epsilon = EPSILON * self.tf * self.count
            self.dt = self._get_timestep()
            self._dump_output_if_needed()
            logger.debug('step %d t=%.6g dt=%.6g', self.count, self.t,
                         self.dt)

        self._sync_to_host()
        self.dump_output()

    # -- timestep helpers ----------------------------------------------
    def _get_undamped_timestep(self):
        if self._prev_dt is not None:
            dt = self._prev_dt
            self._prev_dt = None
        else:
            dt = self.dt / self._damping_factor
        return dt

    def _compute_timestep(self):
        """The next dt; grows the grid if its last binning overflowed."""
        undamped = self._get_undamped_timestep()
        flag = self.grid.overflow
        dt = None
        if self.adaptive_timestep:
            dt = self.integrator.compute_time_step(self.states, undamped,
                                                   self.cfl)
        if dt is not None:
            # one device-to-host copy for both
            dt, grow = torch.stack([dt, flag.to(dt.dtype)]).tolist()
        else:
            dt = undamped
            grow = self.count % GROW_CHECK_STEPS == 0 and bool(flag)
        if grow:
            self.grid.grow(self.states.values())
            logger.info('step %d: particles left the cell grid; grown to '
                        '%s', self.count, self.grid.dims)
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
