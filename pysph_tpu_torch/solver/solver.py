"""The Solver: the time loop (port of ``pysph_tpu/solver/solver.py``).

A plain Python loop over eager integrator steps, with adaptive and
damped dt, ``output_at_times`` landing and ``max_steps``.  The particle
state is a dict of per-array tensor dicts on the configured device; the
host arrays are refreshed at the end of ``solve``.  Adaptive dt costs one
device-to-host copy per step.

Output dumps are not ported yet (ROADMAP Queue 1, output): a run must
disable them.
"""

import logging

import numpy as np

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.kernels import CubicSpline

logger = logging.getLogger(__name__)

EPSILON = 1e-14


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
        self.disable_output = False
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
            self._land_on_output_times()
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
        undamped = self._get_undamped_timestep()
        if self.adaptive_timestep:
            return self.integrator.compute_time_step(self.states, undamped,
                                                     self.cfl)
        return undamped

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
    def dump_output(self):
        if self.disable_output:
            return
        raise NotImplementedError(
            'output dumps are not ported yet (ROADMAP Queue 1, output): '
            'run with --disable-output')

    def _land_on_output_times(self):
        """Shorten dt to land exactly on the next of ``output_at_times``
        (the dumps themselves wait for the output port)."""
        if abs(self.t - self.tf) < self._epsilon:
            return
        tdiff = self.output_at_times - self.t
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
