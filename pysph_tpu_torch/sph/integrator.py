"""Time integrators (port of ``pysph_tpu/sph/integrator.py``).

An ``Integrator`` is built from per-array ``IntegratorStep`` objects
(``PECIntegrator(fluid=WCSPHStep())``) and a ``one_timestep(t, dt)``
recipe of ``initialize()``, ``stage1()`` .. ``stage5()``,
``compute_accelerations(index)`` (evaluator ``index`` of several, as
GTVF has), ``update_domain()`` and ``do_post_stage(stage_dt, stage)``,
run eagerly on the state dicts (updated in place).  The recipes are the
reference's: Euler, PEC, EPEC, TVDRK3, LeapFrog and PEFRL (1, 1, 2, 3,
1 and 4 evaluations a step).  ``update_domain()`` wraps the positions
of every array into a periodic domain (``set_domain``) after each
stage, on the device, with nothing read (``DomainManager.wrap_state``:
new tensors, which the solver's chunk writes back into its static ones
under its ``active`` select).  ``do_post_stage`` calls the post-stage
callback (``set_post_stage_callback``: ``callback(t + stage_dt, dt,
stage)``), a host function, so the solver runs a step with one in its
per-step loop.

Binning, as in ``pysph_tpu`` (``integrator.py:63-67, 307-318``): each
evaluator index keeps one ``GridHandle`` (``handles``) across steps.
``initial_acceleration`` bins evaluator 0 afresh; in a step, the first
evaluation of each index runs the reuse test (``prepare_reuse``: rebuild
only when a particle has moved half the slack margin, or h has grown)
and its later evaluations in the step reuse that binning, unless
``bin_every_eval`` is set, when every evaluation with ``update_nnps``
runs the test.  ``step(..., active)`` passes the solver's chunk flag to
the test, so an inactive step bins nothing, and to the evaluators (an
``iisph_solve`` sweeps under it).  ``rebuilds`` (a float64 0-d
tensor on the device) counts the binnings that ran; nothing is read.

``t`` and ``dt`` reach the stages and the evaluators as given: Python
floats in the solver's per-step loop, 0-d float64 tensors on the device
in its chunks (only arithmetic reads them, so a step captures into a
CUDA graph).

Adaptive dt follows the reference: the maxima of the ``dt_cfl`` /
``dt_force`` / ``dt_visc`` properties give ``hmin/f``,
``sqrt(hmin/sqrt(f))`` and ``hmin/f``.  The reductions run on the device
and nothing is read back here: the solver reads the result once a step
in its per-step loop, and its chunks keep it on the device.

The torch pair engine builds its pair lists at capacities held on the
host (``CellGrid.pair_capacity``), so a list that outgrew its capacity
drops pairs: ``initial_acceleration`` runs again from the same state
with the capacities grown until none overflowed (one read a run where a
dest is on that engine; the first capacities come from here); within a
step nothing is read, and the solver redoes a step or chunk that
overflowed.
"""

import torch

from pysph_tpu_torch.sph.acceleration_eval import (
    _bind_particle_phase, run_sized)


class Integrator(object):
    def __init__(self, **steppers):
        self.steppers = steppers
        self.acceleration_evals = None
        # Bin once a step and reuse the binning across steps while its
        # test holds (the grid's cell_slack is the margin); True runs the
        # test at every evaluation that updates the neighbours.
        self.bin_every_eval = False
        #: {evaluator index: GridHandle}, kept across steps
        self.handles = {}
        #: binnings that ran (0-d float64 tensor on the device, or None
        #: before the first)
        self.rebuilds = None
        self.post_stage_callback = None
        #: the DomainManager of ``set_domain`` (None: no periodic axis)
        self.domain = None
        self._checked = set()
        self._active = None
        self._states = None
        self._t = 0.0
        self._dt = 0.0

    def set_acceleration_evals(self, a_evals):
        if not isinstance(a_evals, (list, tuple)):
            a_evals = [a_evals]
        self.acceleration_evals = list(a_evals)
        self.handles = {}

    def set_domain(self, domain):
        """Wrap the positions into ``domain`` after each stage, and hand
        it to the evaluators (``AccelerationEval.set_domain``)."""
        self.domain = domain
        for a_eval in self.acceleration_evals or ():
            a_eval.set_domain(domain)

    def set_post_stage_callback(self, callback):
        """``callback(t + stage_dt, dt, stage)`` after each stage."""
        self.post_stage_callback = callback

    def step(self, states, t, dt, active=None):
        """Advance ``states`` (updated in place) by one timestep; with
        ``active`` (a 0-d device bool), bin only where it is set."""
        self._states, self._t, self._dt = states, t, dt
        self._active, self._checked = active, set()
        self.one_timestep(t, dt)
        self._states = self._active = None
        return states

    def initial_acceleration(self, states, t, dt):
        """The force evaluation before the first step: evaluator 0 only,
        on a fresh binning, as in ``pysph_tpu``; run again with the torch
        engine's capacities grown where a pair list overflowed
        (``run_sized``), the count of binnings as it was before."""
        rebuilds = None if self.rebuilds is None else self.rebuilds.clone()

        def run():
            self._states, self._t, self._dt = states, t, dt
            self._active, self._checked = None, set()
            self.rebuilds = None if rebuilds is None else rebuilds.clone()
            self._bin(0, force=True)
            self.acceleration_evals[0].compute(t, dt, states,
                                               self.handles[0])
            self._states = None

        run_sized(self.acceleration_evals[0].grid, states, run,
                  self.acceleration_evals)
        return states

    def _bin(self, index, force=False):
        """Bin evaluator ``index``'s arrays afresh (``force``) or run its
        reuse test, and count a binning that ran."""
        a_eval = self.acceleration_evals[index]
        handle = self.handles.get(index)
        if force:
            handle, flag = a_eval.prepare(self._states, handle)
        else:
            handle, flag = a_eval.prepare_reuse(self._states, handle,
                                                self._active)
        self.handles[index] = handle
        self._checked.add(index)
        if self.rebuilds is None:
            self.rebuilds = torch.zeros((), dtype=torch.float64,
                                        device=flag.device)
        self.rebuilds.add_(flag)

    def compute_accelerations(self, index=0, update_nnps=True):
        if (update_nnps and self.bin_every_eval) or \
                index not in self._checked:
            self._bin(index)
        self.acceleration_evals[index].compute(self._t, self._dt,
                                               self._states,
                                               self.handles[index],
                                               self._active)

    def update_domain(self):
        """Wrap every array's positions into the periodic domain (port
        of ``pysph_tpu``'s ``update_domain``,
        pysph_tpu/sph/integrator.py:323-336)."""
        if self.domain is None or not self.domain.is_periodic:
            return
        for name, st in self._states.items():
            st.update(self.domain.wrap_state(st))

    def do_post_stage(self, stage_dt, stage):
        if self.post_stage_callback is not None:
            self.post_stage_callback(self._t + stage_dt, self._dt, stage)

    def _run_stage(self, stage_name):
        a_eval = self.acceleration_evals[0]
        for arr_name, stepper in self.steppers.items():
            fn = getattr(stepper, stage_name, None)
            if fn is None:
                continue
            store = self._states[arr_name]
            _bind_particle_phase(fn, store, store['tag'] == 0, self._t,
                                 self._dt, a_eval.consts[arr_name],
                                 a_eval.kernel)

    def initialize(self):
        self._run_stage('initialize')

    def stage1(self):
        self._run_stage('stage1')

    def stage2(self):
        self._run_stage('stage2')

    def stage3(self):
        self._run_stage('stage3')

    def stage4(self):
        self._run_stage('stage4')

    def stage5(self):
        self._run_stage('stage5')

    def one_timestep(self, t, dt):
        raise NotImplementedError()

    def compute_time_step(self, states, dt_current, cfl):
        """The adaptive dt as a 0-d tensor on the states' device
        (``dt_current``, a float or a 0-d tensor of the working dtype,
        where no particle constrains it), or None when no array has a
        ``dt_*`` property.  Nothing is read back."""
        arrays = [s for s in states.values() if s['h'].numel() > 0]
        factors = {}
        for prop in ('dt_cfl', 'dt_force', 'dt_visc'):
            vals = [s[prop].max() for s in arrays if prop in s]
            if vals:
                factors[prop] = torch.stack(vals).max().clamp(min=-1.0)
        if not factors:
            return None
        hmin = torch.stack([s['h'].min() for s in arrays]).min()
        inf = torch.full_like(hmin, float('inf'))
        dt_min = inf
        for prop, f in factors.items():
            pos = f > 0
            if prop == 'dt_force':
                cand = torch.sqrt(hmin / torch.sqrt(torch.where(pos, f, 1.0)))
            else:
                cand = hmin / torch.where(pos, f, 1.0)
            dt_min = torch.minimum(dt_min, torch.where(pos, cand, inf))
        ok = (dt_min > 0) & torch.isfinite(dt_min)
        return torch.where(ok, cfl * dt_min, dt_current)


class EulerIntegrator(Integrator):
    """1-stage Euler."""

    def one_timestep(self, t, dt):
        self.compute_accelerations()
        self.stage1()
        self.update_domain()
        self.do_post_stage(dt, 1)


class PECIntegrator(Integrator):
    """Predict-Evaluate-Correct: one evaluation a step."""

    def one_timestep(self, t, dt):
        self.initialize()
        self.stage1()
        self.update_domain()
        self.do_post_stage(0.5 * dt, 1)
        self.compute_accelerations()
        self.stage2()
        self.update_domain()
        self.do_post_stage(dt, 2)


class EPECIntegrator(Integrator):
    """Evaluate-Predict-Evaluate-Correct."""

    def one_timestep(self, t, dt):
        self.initialize()
        self.compute_accelerations()
        self.stage1()
        self.update_domain()
        self.do_post_stage(0.5 * dt, 1)
        self.compute_accelerations()
        self.stage2()
        self.update_domain()
        self.do_post_stage(dt, 2)


class TVDRK3Integrator(Integrator):
    """3-stage SSP RK3."""

    def one_timestep(self, t, dt):
        self.initialize()
        self.compute_accelerations()
        self.stage1()
        self.update_domain()
        self.do_post_stage(1. / 3 * dt, 1)
        self.compute_accelerations()
        self.stage2()
        self.update_domain()
        self.do_post_stage(2. / 3 * dt, 2)
        self.compute_accelerations()
        self.stage3()
        self.update_domain()
        self.do_post_stage(dt, 3)


class LeapFrogIntegrator(PECIntegrator):
    """Kick-drift-kick leap-frog."""

    def one_timestep(self, t, dt):
        self.stage1()
        self.update_domain()
        self.do_post_stage(0.5 * dt, 1)
        self.compute_accelerations()
        self.stage2()
        self.update_domain()
        self.do_post_stage(dt, 2)


class PEFRLIntegrator(Integrator):
    """Position-Extended Forest-Ruth-Like 4th order symplectic
    integrator: four evaluations a step, the particles moving between
    them (the first evaluation's reuse test keeps the step's binning for
    the other three, as in ``pysph_tpu``)."""

    def one_timestep(self, t, dt):
        self.stage1()
        self.update_domain()
        self.do_post_stage(0.1786178958448091 * dt, 1)
        self.compute_accelerations()
        self.stage2()
        self.update_domain()
        self.do_post_stage(0.1123533131749906 * dt, 2)
        self.compute_accelerations()
        self.stage3()
        self.update_domain()
        self.do_post_stage(0.8876466868250094 * dt, 3)
        self.compute_accelerations()
        self.stage4()
        self.update_domain()
        self.do_post_stage(0.8213821041551909 * dt, 4)
        self.compute_accelerations()
        self.stage5()
        self.update_domain()
        self.do_post_stage(dt, 5)
