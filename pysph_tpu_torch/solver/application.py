"""The Application: the user-facing entry point of a simulation (port of
``pysph_tpu/solver/application.py``).

A subclass overrides ``initialize``, ``create_particles``,
``create_scheme`` (or ``create_equations`` and ``create_solver``),
``create_domain`` (a periodic box: ``base/domain.py``),
``add_user_options``, ``consume_user_options``, ``configure_scheme``,
``post_stage`` and ``post_process`` and calls ``run()``.  The command
line sets time stepping, output (``-d/--directory``, ``--pfreq``,
``--output-at-times``, ``--disable-output``), the SPH kernel
(``--kernel``), the dtype (``--use-double``), the device (``--device``,
default ``cuda``) and the pair engine (``--engine kernel|dense|torch``).
"""

import argparse
import logging
import os
import sys
import time

import torch

from pysph_tpu_torch.base import kernels as _kernels
from pysph_tpu_torch.config import ENGINES, Config
from pysph_tpu_torch.solver.utils import get_files

logger = logging.getLogger(__name__)

#: the ``--kernel`` choices of the JAX package (all in ``base/kernels.py``)
KERNELS = ('CubicSpline', 'Gaussian', 'QuinticSpline', 'SuperGaussian',
           'WendlandQuintic', 'WendlandQuinticC2_1D', 'WendlandQuinticC4',
           'WendlandQuinticC4_1D', 'WendlandQuinticC6',
           'WendlandQuinticC6_1D')


class Application(object):
    def __init__(self, fname=None, output_dir=None):
        self.solver = None
        self.scheme = None
        self.domain = None
        self.particles = []
        self.args = sys.argv[1:]
        self.fname = fname or self._guess_fname()
        self.output_dir = output_dir or (self.fname + '_output')
        self._setup_time = 0.0
        self._solve_time = 0.0
        self.initialize()

    def _guess_fname(self):
        """The example's module name (its file's, when run as a
        script): the stem of the output files."""
        module = self.__class__.__module__
        if module != '__main__':
            return module.rsplit('.', 1)[-1]
        f = getattr(sys.modules.get('__main__'), '__file__', None)
        if f:
            return os.path.splitext(os.path.basename(f))[0]
        return self.__class__.__name__.lower()

    # -- command line --------------------------------------------------
    def _setup_argparse(self):
        parser = argparse.ArgumentParser(
            description=self.__doc__ or '',
            formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        parser.add_argument('-v', '--verbose', action='store_true',
                            dest='verbose', default=False)
        parser.add_argument('-q', '--quiet', action='store_true',
                            dest='quiet', default=False)
        parser.add_argument('-d', '--directory', action='store',
                            dest='output_dir', default=self.output_dir,
                            help='Output directory.')
        parser.add_argument('--max-steps', action='store', type=int,
                            dest='max_steps', default=1 << 31,
                            help='Maximum number of steps to run.')
        parser.add_argument('--disable-output', action='store_true',
                            dest='disable_output', default=False,
                            help='Write no output files.')
        parser.add_argument('--pfreq', '--print-freq', action='store',
                            type=int, dest='freq', default=None,
                            help='Dump the particles every this many '
                                 'steps.')
        parser.add_argument('--output-at-times', action='store',
                            dest='output_at_times', default=None,
                            help='Comma-separated times to dump at.')
        parser.add_argument('--kernel', action='store', dest='kernel',
                            default=None, choices=KERNELS,
                            help='SPH kernel to use.')
        parser.add_argument('--timestep', '--dt', action='store',
                            type=float, dest='time_step', default=None)
        parser.add_argument('--tf', '--final-time', action='store',
                            type=float, dest='final_time', default=None)
        parser.add_argument('--adaptive-timestep', action='store_true',
                            dest='adaptive_timestep', default=None)
        parser.add_argument('--no-adaptive-timestep', action='store_false',
                            dest='adaptive_timestep', default=None)
        parser.add_argument('--cfl', '--cfl-factor', action='store',
                            type=float, dest='cfl', default=0.3)
        parser.add_argument('--n-damp', action='store', type=int,
                            dest='n_damp', default=None)
        parser.add_argument('--use-double', action='store_true',
                            dest='use_double', default=False,
                            help='Use float64 (default float32).')
        parser.add_argument('--device', action='store', dest='device',
                            default='cuda',
                            help='Torch device of the particle state.')
        parser.add_argument('--engine', action='store', dest='engine',
                            default='kernel', choices=ENGINES,
                            help='Pair engine: the hand-written kernels '
                                 'where the phases match them, the '
                                 'cell-blocked dense_pair kernel for the '
                                 'WCSPH phases, or the generic torch '
                                 'engine everywhere.')
        if self.scheme is not None:
            group = parser.add_argument_group(
                'Scheme options', conflict_handler='resolve')
            self.scheme.add_user_options(group)
        self.add_user_options(parser.add_argument_group(
            'Application options'))
        return parser

    def _process_command_line(self, argv):
        self.options = self._setup_argparse().parse_args(argv)
        o = self.options
        self.output_dir = o.output_dir
        self.config = Config(
            device=o.device,
            dtype=torch.float64 if o.use_double else torch.float32,
            engine=o.engine)

    def _setup_logging(self):
        o = self.options
        level = (logging.ERROR if o.quiet else
                 logging.DEBUG if o.verbose else logging.INFO)
        log = logging.getLogger('pysph_tpu_torch')
        log.setLevel(level)
        if not log.handlers:
            log.addHandler(logging.StreamHandler(sys.stderr))

    # -- user-overridable protocol -------------------------------------
    def initialize(self):
        pass

    def create_scheme(self):
        return None

    def create_equations(self):
        if self.scheme is not None:
            return self.scheme.get_equations()
        raise RuntimeError('Application.create_equations: override this '
                           'or provide a scheme.')

    def create_particles(self):
        raise RuntimeError('Application.create_particles: override this.')

    def create_domain(self):
        """The ``DomainManager`` of the run, or None (no periodic
        axis)."""
        return self.domain

    def create_solver(self):
        if self.scheme is not None:
            return self.scheme.get_solver()
        raise RuntimeError('Application.create_solver: override this or '
                           'provide a scheme.')

    def add_user_options(self, group):
        pass

    def consume_user_options(self):
        pass

    def configure_scheme(self):
        pass

    def post_stage(self, current_time, dt, stage):
        """Called after each integrator stage where overridden (the run
        then steps in the solver's per-step loop)."""
        pass

    def post_process(self, info_fname_or_directory):
        pass

    # -- output files --------------------------------------------------
    @property
    def info_filename(self):
        return os.path.join(self.output_dir, self.fname + '.info')

    @property
    def output_files(self):
        """The dump files of the run, sorted by step count."""
        return get_files(self.output_dir, self.fname)

    # -- setup + run ---------------------------------------------------
    def setup(self, argv=None):
        if argv is None:
            argv = self.args
        start = time.time()
        self.scheme = self.create_scheme()
        self._process_command_line(argv)
        self._setup_logging()
        if self.scheme is not None:
            self.scheme.consume_user_options(self.options)
        self.consume_user_options()
        self.configure_scheme()

        self.solver = self.create_solver()
        if self.solver is None:
            raise RuntimeError('create_solver returned None')
        self.equations = self.create_equations()
        self.particles = list(self.create_particles())
        if self.scheme is not None:
            # non-destructive: create_particles may add properties
            self.scheme.setup_properties(self.particles, clean=False)

        o = self.options
        solver = self.solver
        solver.disable_output = o.disable_output
        solver.set_output_directory(self.output_dir)
        solver.set_output_fname(self.fname)
        if o.freq is not None:
            solver.set_print_freq(o.freq)
        if o.output_at_times:
            solver.set_output_at_times(
                [float(t) for t in o.output_at_times.split(',') if t])
        if o.kernel is not None:
            # the solver sizes its CellGrid with this kernel's
            # radius_scale
            solver.kernel = getattr(_kernels, o.kernel)(dim=solver.dim)
        if o.time_step is not None:
            solver.dt = o.time_step
        if o.final_time is not None:
            solver.set_final_time(o.final_time)
        if o.adaptive_timestep is not None:
            solver.adaptive_timestep = o.adaptive_timestep
            solver.cfl = o.cfl
        if o.n_damp is not None:
            solver.n_damp = o.n_damp
        solver.max_steps = o.max_steps
        if type(self).post_stage is not Application.post_stage:
            solver.add_post_stage_callback(self.post_stage)
        self.domain = self.create_domain()
        if self.domain is not None:
            solver.set_domain(self.domain)
        solver.setup(self.particles, self.equations, self.config)
        self._setup_time = time.time() - start

    def solve(self):
        start = time.time()
        self.solver.solve()
        self._solve_time = time.time() - start
        logger.info('Run took %.2f s (setup %.2f s)', self._solve_time,
                    self._setup_time)

    def run(self, argv=None):
        """Parse args, set everything up and solve."""
        self.setup(argv)
        self.solve()
