"""SPH schemes: equations + integrator + solver for a formulation
(port of ``pysph_tpu/sph/scheme.py``: ``Scheme``, ``SchemeChooser``,
``TVFScheme``, ``WCSPHScheme``, ``GasDScheme``, ``GSPHScheme`` and
``ADKEScheme``; ``GTVFScheme`` is in ``sph/wc/gtvf.py``)."""


class Scheme(object):
    """An API for an SPH scheme."""

    def __init__(self, fluids, solids, dim):
        self.fluids = fluids
        self.solids = solids
        self.dim = dim
        self.solver = None

    def add_user_options(self, group):
        pass

    def attributes_changed(self):
        """Derive what depends on the scheme's parameters (called by
        ``configure``)."""

    def configure(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise RuntimeError('Parameter %s not defined for %s.' %
                                   (k, self.__class__.__name__))
            setattr(self, k, v)
        self.attributes_changed()

    def consume_user_options(self, options):
        pass

    def configure_solver(self, kernel=None, integrator_cls=None,
                         extra_steppers=None, **kw):
        raise NotImplementedError()

    def get_equations(self):
        raise NotImplementedError()

    def get_solver(self):
        return self.solver

    def setup_properties(self, particles, clean=True):
        raise NotImplementedError()

    def _ensure_properties(self, pa, desired_props, clean=True):
        """Add the desired props the array lacks (a dict entry gives
        ``add_property`` keywords, e.g. a stride); with ``clean``, remove
        the props not desired."""
        all_props = {}
        for p in desired_props:
            if isinstance(p, dict):
                all_props[p['name']] = p
            elif p not in all_props:
                all_props[p] = {'name': p}
        if clean:
            for prop in set(pa.properties) - set(all_props):
                pa.remove_property(prop)
        for prop in all_props:
            if prop not in pa.properties:
                kw = dict(all_props[prop])
                pa.add_property(kw.pop('name'), **kw)

    def _smart_getattr(self, obj, var):
        res = getattr(obj, var, None)
        if res is None:
            return getattr(self, var)
        return res


class SchemeChooser(Scheme):
    """Chooses one of several schemes with ``--scheme``; every other
    call goes to the chosen one."""

    def __init__(self, default, **schemes):
        self.default = default
        self.schemes = dict(schemes)
        self.scheme = schemes[default]
        self.solver = None

    def add_user_options(self, group):
        group.add_argument(
            '--scheme', action='store', dest='scheme',
            default=self.default, choices=list(self.schemes.keys()),
            help='Scheme to use (one of %s)' % list(self.schemes.keys()))
        for scheme in self.schemes.values():
            scheme.add_user_options(group)

    def configure(self, **kw):
        self.scheme.configure(**kw)

    def consume_user_options(self, options):
        self.scheme = self.schemes[options.scheme]
        self.scheme.consume_user_options(options)

    def configure_solver(self, kernel=None, integrator_cls=None,
                         extra_steppers=None, **kw):
        self.scheme.configure_solver(kernel=kernel,
                                     integrator_cls=integrator_cls,
                                     extra_steppers=extra_steppers, **kw)

    def get_equations(self):
        return self.scheme.get_equations()

    def get_solver(self):
        return self.scheme.get_solver()

    def setup_properties(self, particles, clean=True):
        self.scheme.setup_properties(particles, clean)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, 'scheme'), name)


class NotPortedScheme(Scheme):
    """Holds the place of a scheme the port lacks in a ``SchemeChooser``,
    so that the command line keeps the reference's choices; choosing it
    raises ``NotImplementedError`` naming the ROADMAP item."""

    def __init__(self, name, item):
        self.name = name
        self.item = item
        self.solver = None

    def consume_user_options(self, options):
        raise NotImplementedError('the %s scheme is not ported yet (%s)'
                                  % (self.name, self.item))


def add_bool_argument(group, arg, dest, help, default):
    group.add_argument('--%s' % arg, action='store_true', dest=dest,
                       help=help, default=default)
    group.add_argument('--no-%s' % arg, action='store_false', dest=dest,
                       help='Do not ' + help[0].lower() + help[1:])


class TVFScheme(Scheme):
    """Transport Velocity Formulation (Adami 2013): summation density,
    the generalised equation of state, and the pressure gradient with a
    background pressure ``pb``, laminar viscosity and the artificial
    stress, with the Adami walls; ``PECIntegrator`` with
    ``TransportVelocityStep`` and ``QuinticSpline`` by default."""

    def __init__(self, fluids, solids, dim, rho0, c0, nu, p0, pb, h0,
                 gx=0.0, gy=0.0, gz=0.0, alpha=0.0, tdamp=0.0):
        self.fluids = fluids
        self.solids = solids
        self.solver = None
        self.rho0 = rho0
        self.c0 = c0
        self.pb = pb
        self.p0 = p0
        self.nu = nu
        self.dim = dim
        self.h0 = h0
        self.gx = gx
        self.gy = gy
        self.gz = gz
        self.alpha = alpha
        self.tdamp = tdamp

    def add_user_options(self, group):
        group.add_argument('--alpha', action='store', type=float,
                           dest='alpha', default=None,
                           help='Alpha for the artificial viscosity.')
        group.add_argument('--tdamp', action='store', type=float,
                           dest='tdamp', default=None,
                           help='Time over which accelerations are '
                                'damped.')

    def consume_user_options(self, options):
        data = dict((var, self._smart_getattr(options, var))
                    for var in ('alpha', 'tdamp'))
        self.configure(**data)

    def get_timestep(self, cfl=0.25):
        dt_cfl = cfl * self.h0 / self.c0
        dt_viscous = 0.125 * self.h0 ** 2 / self.nu \
            if self.nu > 1e-12 else 1.0
        return min(dt_cfl, dt_viscous, 1.0)

    def configure_solver(self, kernel=None, integrator_cls=None,
                         extra_steppers=None, **kw):
        from pysph_tpu_torch.base.kernels import QuinticSpline
        from pysph_tpu_torch.sph.integrator import PECIntegrator
        from pysph_tpu_torch.sph.integrator_step import (
            TransportVelocityStep)
        from pysph_tpu_torch.solver.solver import Solver
        if kernel is None:
            kernel = QuinticSpline(dim=self.dim)
        steppers = dict(extra_steppers or {})
        for fluid in self.fluids:
            if fluid not in steppers:
                steppers[fluid] = TransportVelocityStep()
        cls = PECIntegrator if integrator_cls is None else integrator_cls
        integrator = cls(**steppers)
        if 'dt' not in kw:
            kw['dt'] = self.get_timestep()
        self.solver = Solver(dim=self.dim, integrator=integrator,
                             kernel=kernel, **kw)

    def get_equations(self):
        from pysph_tpu_torch.sph.equation import Group
        from pysph_tpu_torch.sph.wc.transport_velocity import (
            MomentumEquationArtificialStress,
            MomentumEquationArtificialViscosity,
            MomentumEquationPressureGradient, MomentumEquationViscosity,
            SetWallVelocity, SolidWallNoSlipBC, SolidWallPressureBC,
            StateEquation, SummationDensity)
        equations = []
        all = self.fluids + self.solids
        g1 = [SummationDensity(dest=fluid, sources=all)
              for fluid in self.fluids]
        equations.append(Group(equations=g1, real=False))

        g2 = [StateEquation(dest=fluid, sources=None, p0=self.p0,
                            rho0=self.rho0, b=1.0)
              for fluid in self.fluids]
        g2.extend(SetWallVelocity(dest=solid, sources=self.fluids)
                  for solid in self.solids)
        if g2:
            equations.append(Group(equations=g2, real=False))

        g3 = [SolidWallPressureBC(
            dest=solid, sources=self.fluids, b=1.0, rho0=self.rho0,
            p0=self.p0, gx=self.gx, gy=self.gy, gz=self.gz)
            for solid in self.solids]
        if g3:
            equations.append(Group(equations=g3, real=False))

        g4 = []
        for fluid in self.fluids:
            g4.append(MomentumEquationPressureGradient(
                dest=fluid, sources=all, pb=self.pb, gx=self.gx,
                gy=self.gy, gz=self.gz, tdamp=self.tdamp))
            if self.alpha > 0.0:
                g4.append(MomentumEquationArtificialViscosity(
                    dest=fluid, sources=all, c0=self.c0,
                    alpha=self.alpha))
            if self.nu > 0.0:
                g4.append(MomentumEquationViscosity(
                    dest=fluid, sources=self.fluids, nu=self.nu))
                if self.solids:
                    g4.append(SolidWallNoSlipBC(
                        dest=fluid, sources=self.solids, nu=self.nu))
            g4.append(MomentumEquationArtificialStress(
                dest=fluid, sources=self.fluids))
        equations.append(Group(equations=g4))
        return equations

    def setup_properties(self, particles, clean=True):
        from pysph_tpu_torch.base.utils import (
            get_particle_array_tvf_fluid, get_particle_array_tvf_solid)
        particle_arrays = dict((p.name, p) for p in particles)
        dummy = get_particle_array_tvf_fluid(name='junk')
        props = list(dummy.properties.keys())
        output_props = dummy.output_property_arrays
        for fluid in self.fluids:
            pa = particle_arrays[fluid]
            self._ensure_properties(pa, props, clean)
            pa.set_output_arrays(output_props)
        dummy = get_particle_array_tvf_solid(name='junk')
        props = list(dummy.properties.keys())
        output_props = dummy.output_property_arrays
        for solid in self.solids:
            pa = particle_arrays[solid]
            self._ensure_properties(pa, props, clean)
            pa.set_output_arrays(output_props)


class WCSPHScheme(Scheme):
    """Weakly-compressible SPH."""

    def __init__(self, fluids, solids, dim, rho0, c0, h0, hdx, gamma=7.0,
                 gx=0.0, gy=0.0, gz=0.0, alpha=0.1, beta=0.0, delta=0.1,
                 nu=0.0, tensile_correction=False, hg_correction=False,
                 update_h=False, delta_sph=False, summation_density=False):
        self.fluids = fluids
        self.solids = solids
        self.solver = None
        self.rho0 = rho0
        self.c0 = c0
        self.gamma = gamma
        self.dim = dim
        self.h0 = h0
        self.hdx = hdx
        self.gx = gx
        self.gy = gy
        self.gz = gz
        self.alpha = alpha
        self.beta = beta
        self.delta = delta
        self.nu = nu
        self.tensile_correction = tensile_correction
        self.hg_correction = hg_correction
        self.update_h = update_h
        self.delta_sph = delta_sph
        self.summation_density = summation_density

    def add_user_options(self, group):
        group.add_argument('--alpha', action='store', type=float,
                           dest='alpha', default=None,
                           help='Artificial viscosity alpha.')
        group.add_argument('--beta', action='store', type=float,
                           dest='beta', default=None,
                           help='Artificial viscosity beta.')
        group.add_argument('--delta', action='store', type=float,
                           dest='delta', default=None,
                           help='delta-SPH diffusion coefficient.')
        group.add_argument('--gamma', action='store', type=float,
                           dest='gamma', default=None,
                           help='Tait EOS gamma.')
        add_bool_argument(group, 'tensile-correction',
                          'tensile_correction',
                          'Use tensile instability correction.', None)
        add_bool_argument(group, 'hg-correction', 'hg_correction',
                          'Use the Hughes-Graham correction.', None)
        add_bool_argument(group, 'update-h', 'update_h',
                          'Update the smoothing length.', None)
        add_bool_argument(group, 'delta-sph', 'delta_sph',
                          'Use delta-SPH.', None)
        add_bool_argument(group, 'summation-density', 'summation_density',
                          'Use summation density.', None)

    def consume_user_options(self, options):
        vars = ['gamma', 'tensile_correction', 'hg_correction',
                'update_h', 'delta_sph', 'alpha', 'beta',
                'summation_density', 'delta']
        data = dict((var, self._smart_getattr(options, var))
                    for var in vars)
        self.configure(**data)

    def get_timestep(self, cfl=0.5):
        return cfl * self.h0 / self.c0

    def configure_solver(self, kernel=None, integrator_cls=None,
                         extra_steppers=None, **kw):
        """``PECIntegrator`` by default; under ``TVDRK3Integrator`` the
        arrays step with ``WCSPHTVDRK3Step``, else ``WCSPHStep``."""
        from pysph_tpu_torch.base.kernels import CubicSpline
        from pysph_tpu_torch.sph.integrator import (
            PECIntegrator, TVDRK3Integrator)
        from pysph_tpu_torch.sph.integrator_step import (
            WCSPHStep, WCSPHTVDRK3Step)
        from pysph_tpu_torch.solver.solver import Solver
        if kernel is None:
            kernel = CubicSpline(dim=self.dim)
        cls = PECIntegrator if integrator_cls is None else integrator_cls
        step_cls = WCSPHTVDRK3Step if cls is TVDRK3Integrator else \
            WCSPHStep
        steppers = dict(extra_steppers or {})
        for name in self.fluids + self.solids:
            if name not in steppers:
                steppers[name] = step_cls()
        integrator = cls(**steppers)
        if 'dt' not in kw:
            kw['dt'] = self.get_timestep()
        self.solver = Solver(dim=self.dim, integrator=integrator,
                             kernel=kernel, **kw)

    def get_equations(self):
        """The WCSPH equation groups: the main path's, with the delta-SPH
        groups (``delta_sph``) and laminar viscosity (``nu != 0``) as in
        ``pysph_tpu/sph/scheme.py``.  ``GradientCorrection`` is built
        without ``dim``, so it corrects two components in 3D as the
        reference does."""
        from pysph_tpu_torch.sph.basic_equations import (
            ContinuityEquation, SummationDensity, XSPHCorrection)
        from pysph_tpu_torch.sph.equation import Group
        from pysph_tpu_torch.sph.wc.basic import (
            ContinuityEquationDeltaSPH, ContinuityEquationDeltaSPHPreStep,
            MomentumEquation, MomentumEquationDeltaSPH, TaitEOS,
            TaitEOSHGCorrection)
        from pysph_tpu_torch.sph.wc.kernel_correction import (
            GradientCorrection, GradientCorrectionPreStep)
        from pysph_tpu_torch.sph.wc.viscosity import (
            LaminarViscosity, LaminarViscosityDeltaSPH)
        if self.update_h:
            raise NotImplementedError('update_h is not ported yet (ROADMAP '
                                      'Queue 1 item 28)')

        equations = []
        all = self.fluids + self.solids
        summation = self.summation_density
        delta_sph = self.delta_sph and not summation

        if summation:
            equations.append(Group(equations=[
                SummationDensity(dest=name, sources=all)
                for name in self.fluids], real=False))

        g1 = []
        for name in self.fluids:
            g1.append(TaitEOS(dest=name, sources=None, rho0=self.rho0,
                              c0=self.c0, gamma=self.gamma))
        for name in self.solids:
            cls = TaitEOSHGCorrection if self.hg_correction else TaitEOS
            g1.append(cls(dest=name, sources=None, rho0=self.rho0,
                          c0=self.c0, gamma=self.gamma))
        equations.append(Group(equations=g1, real=False))

        if delta_sph:
            equations.append(Group(equations=[
                GradientCorrectionPreStep(dest=name, sources=[name],
                                          dim=self.dim)
                for name in self.fluids], real=False))
            eq2 = []
            for name in self.fluids:
                eq2.extend([
                    GradientCorrection(dest=name, sources=[name]),
                    ContinuityEquationDeltaSPHPreStep(
                        dest=name, sources=[name])])
            equations.append(Group(equations=eq2))

        g2 = []
        for name in self.solids:
            g2.append(ContinuityEquation(dest=name, sources=self.fluids))
        for name in self.fluids:
            if not summation:
                g2.append(ContinuityEquation(dest=name, sources=all))
            if delta_sph:
                g2.append(ContinuityEquationDeltaSPH(
                    dest=name, sources=[name], c0=self.c0,
                    delta=self.delta))
            g2.append(MomentumEquation(
                dest=name, sources=all, c0=self.c0,
                alpha=0.0 if self.delta_sph else self.alpha,
                beta=self.beta, gx=self.gx, gy=self.gy, gz=self.gz,
                tensile_correction=self.tensile_correction))
            if self.delta_sph:
                g2.append(MomentumEquationDeltaSPH(
                    dest=name, sources=[name], rho0=self.rho0,
                    c0=self.c0, alpha=self.alpha))
            g2.append(XSPHCorrection(dest=name, sources=[name]))
            if abs(self.nu) > 1e-14:
                if self.delta_sph:
                    eq = LaminarViscosityDeltaSPH(
                        dest=name, sources=all, dim=self.dim,
                        rho0=self.rho0, nu=self.nu)
                else:
                    eq = LaminarViscosity(dest=name, sources=all,
                                          nu=self.nu)
                g2.insert(-1, eq)
        equations.append(Group(equations=g2))
        return equations

    def setup_properties(self, particles, clean=True):
        from pysph_tpu_torch.base.utils import get_particle_array_wcsph
        dummy = get_particle_array_wcsph(name='junk')
        props = list(dummy.properties.keys())
        output_props = ['x', 'y', 'z', 'u', 'v', 'w', 'rho', 'm', 'h',
                        'pid', 'gid', 'tag', 'p']
        if self.delta_sph:
            props += [{'name': 'm_mat', 'stride': 9},
                      {'name': 'gradrho', 'stride': 3}]
        for pa in particles:
            self._ensure_properties(pa, props, clean)
            pa.set_output_arrays(output_props)
            if pa.name in self.solids:
                if 'lb_weight' not in pa.constants:
                    pa.add_constant('lb_weight', 0.1)


class GasDScheme(Scheme):
    """Compressible gas dynamics with grad-h smoothing lengths: the
    ``mpm`` adaptive-h scheme (the default) iterates each particle's h
    with the summation density to convergence in one iterated group that
    re-bins every sweep; ``gsph`` scales h, sums the density, sets h from
    the volume and sums again, re-binning after each h update; then the
    ideal-gas EOS and ``MPMAccelerations``.  ``PECIntegrator`` with
    ``GasDFluidStep`` and ``Gaussian`` by default.  Walls
    (``WallBoundary``) and ghost particles (``MPMUpdateGhostProps``) are
    not ported: ``solids`` and ``has_ghosts`` raise."""

    def __init__(self, fluids, solids, dim, gamma, kernel_factor,
                 alpha1=1.0, alpha2=0.1, beta=2.0,
                 adaptive_h_scheme='mpm', update_alpha1=False,
                 update_alpha2=False, max_density_iterations=250,
                 density_iteration_tolerance=1e-3, has_ghosts=False):
        self.fluids = fluids
        self.solids = solids
        self.dim = dim
        self.solver = None
        self.gamma = gamma
        self.alpha1 = alpha1
        self.alpha2 = alpha2
        self.update_alpha1 = update_alpha1
        self.update_alpha2 = update_alpha2
        self.beta = beta
        self.kernel_factor = kernel_factor
        self.adaptive_h_scheme = adaptive_h_scheme
        self.density_iteration_tolerance = density_iteration_tolerance
        self.max_density_iterations = max_density_iterations
        self.has_ghosts = has_ghosts

    def _check_ported(self):
        if self.solids:
            raise NotImplementedError(
                'GasDScheme with solids %s: WallBoundary is not ported yet '
                '(ROADMAP Queue 1 item 28, remaining physics)'
                % list(self.solids))
        if self.has_ghosts:
            raise NotImplementedError(
                'GasDScheme with has_ghosts: MPMUpdateGhostProps needs ghost '
                'particles, which the periodic grid does not make (ROADMAP '
                'Queue 1 item 27)')

    def add_user_options(self, group):
        group.add_argument(
            '--adaptive-h', action='store', dest='adaptive_h_scheme',
            default=None, choices=['gsph', 'mpm'],
            help='Adaptive smoothing length scheme.')
        group.add_argument('--alpha1', action='store', type=float,
                           dest='alpha1', default=None,
                           help='Artificial viscosity alpha1.')
        group.add_argument('--beta', action='store', type=float,
                           dest='beta', default=None,
                           help='Artificial viscosity beta.')
        group.add_argument('--alpha2', action='store', type=float,
                           dest='alpha2', default=None,
                           help='Artificial viscosity alpha2.')
        group.add_argument('--gamma', action='store', type=float,
                           dest='gamma', default=None,
                           help='EOS gamma.')
        add_bool_argument(group, 'update-alpha1', dest='update_alpha1',
                          help='Update alpha1 dynamically.',
                          default=None)
        add_bool_argument(group, 'update-alpha2', dest='update_alpha2',
                          help='Update alpha2 dynamically.',
                          default=None)

    def consume_user_options(self, options):
        data = dict((var, self._smart_getattr(options, var)) for var in
                    ('gamma', 'alpha2', 'alpha1', 'beta',
                     'update_alpha1', 'update_alpha2',
                     'adaptive_h_scheme'))
        self.configure(**data)

    def configure_solver(self, kernel=None, integrator_cls=None,
                         extra_steppers=None, **kw):
        from pysph_tpu_torch.base.kernels import Gaussian
        from pysph_tpu_torch.sph.integrator import PECIntegrator
        from pysph_tpu_torch.sph.integrator_step import GasDFluidStep
        from pysph_tpu_torch.solver.solver import Solver
        self._check_ported()
        if kernel is None:
            kernel = Gaussian(dim=self.dim)
        steppers = dict(extra_steppers or {})
        for name in self.fluids:
            if name not in steppers:
                steppers[name] = GasDFluidStep()
        cls = PECIntegrator if integrator_cls is None else integrator_cls
        integrator = cls(**steppers)
        self.solver = Solver(dim=self.dim, integrator=integrator,
                             kernel=kernel, **kw)

    def get_equations(self):
        from pysph_tpu_torch.sph.equation import Group
        from pysph_tpu_torch.sph.gas_dynamics.basic import (
            IdealGasEOS, MPMAccelerations, ScaleSmoothingLength,
            SummationDensity, UpdateSmoothingLengthFromVolume)
        self._check_ported()
        equations = []
        if self.adaptive_h_scheme == 'mpm':
            g1 = [SummationDensity(
                dest=fluid, sources=self.fluids, k=self.kernel_factor,
                density_iterations=True, dim=self.dim,
                htol=self.density_iteration_tolerance)
                for fluid in self.fluids]
            equations.append(Group(
                equations=g1, update_nnps=True, iterate=True,
                max_iterations=self.max_density_iterations))
        elif self.adaptive_h_scheme == 'gsph':
            equations.append(Group(equations=[
                ScaleSmoothingLength(dest=f, sources=None, factor=2.0)
                for f in self.fluids], update_nnps=True))
            equations.append(Group(equations=[
                SummationDensity(dest=f, sources=self.fluids,
                                 dim=self.dim)
                for f in self.fluids], update_nnps=False))
            equations.append(Group(equations=[
                UpdateSmoothingLengthFromVolume(
                    dest=f, sources=None, k=self.kernel_factor,
                    dim=self.dim)
                for f in self.fluids], update_nnps=True))
            equations.append(Group(equations=[
                SummationDensity(dest=f, sources=self.fluids,
                                 dim=self.dim)
                for f in self.fluids], update_nnps=False))

        equations.append(Group(equations=[
            IdealGasEOS(dest=f, sources=None, gamma=self.gamma)
            for f in self.fluids]))
        equations.append(Group(equations=[
            MPMAccelerations(
                dest=f, sources=self.fluids,
                alpha1_min=self.alpha1, alpha2_min=self.alpha2,
                beta=self.beta, update_alpha1=self.update_alpha1,
                update_alpha2=self.update_alpha2)
            for f in self.fluids]))
        return equations

    def setup_properties(self, particles, clean=True):
        import numpy
        from pysph_tpu_torch.base.utils import get_particle_array_gasd
        self._check_ported()
        particle_arrays = dict((p.name, p) for p in particles)
        dummy = get_particle_array_gasd(name='junk')
        props = list(dummy.properties.keys())
        output_props = dummy.output_property_arrays
        for fluid in self.fluids:
            pa = particle_arrays[fluid]
            self._ensure_properties(pa, props, clean)
            pa.add_property('orig_idx', type='int')
            pa.orig_idx = numpy.arange(pa.get_number_of_particles())
            pa.set_output_arrays(output_props)


def _check_gas_ported(scheme):
    """Refuse walls and ghost particles, as ``GasDScheme`` does."""
    name = type(scheme).__name__
    if scheme.solids:
        raise NotImplementedError(
            '%s with solids %s: WallBoundary is not ported yet (ROADMAP '
            'Queue 1 item 28, remaining physics)' % (name,
                                                     list(scheme.solids)))
    if scheme.has_ghosts:
        raise NotImplementedError(
            '%s with has_ghosts: its ghost-property copy needs ghost '
            'particles, which the periodic grid does not make (ROADMAP '
            'Queue 1 item 27)' % name)


class GSPHScheme(Scheme):
    """Godunov SPH: h scaled, the summation density, h set from the
    volume and the density again (each h update re-binned), the ideal-gas
    EOS, ``GSPHGradients`` and ``GSPHAcceleration`` (a Riemann problem a
    pair, ``rsolver`` one of 11).  ``EulerIntegrator`` with ``GSPHStep``
    and ``Gaussian`` by default.  ``get_equations`` passes no ``tf`` to
    ``GSPHAcceleration``, so its hybrid blend takes tf = 1, as the
    reference's (ROADMAP Queue 3: reproduced on purpose).  Walls and
    ghost particles are not ported: ``solids`` and ``has_ghosts``
    raise."""

    def __init__(self, fluids, solids, dim, gamma, kernel_factor,
                 g1=0.0, g2=0.0, rsolver=2, interpolation=1,
                 monotonicity=1, interface_zero=True, hybrid=False,
                 blend_alpha=5.0, tf=1.0, niter=20, tol=1e-6,
                 has_ghosts=False):
        self.fluids = fluids
        self.solids = solids
        self.dim = dim
        self.solver = None
        self.gamma = gamma
        self.kernel_factor = kernel_factor
        self.g1 = g1
        self.g2 = g2
        self.rsolver = rsolver
        self.interpolation = interpolation
        self.monotonicity = monotonicity
        self.interface_zero = interface_zero
        self.hybrid = hybrid
        self.blend_alpha = blend_alpha
        self.tf = tf
        self.niter = niter
        self.tol = tol
        self.has_ghosts = has_ghosts
        self.rsolver_choices = {
            'non_diffusive': 0, 'van_leer': 1, 'exact': 2, 'hllc': 3,
            'ducowicz': 4, 'hlle': 5, 'roe': 6, 'llxf': 7,
            'hllc_ball': 8, 'hll_ball': 9, 'hllsy': 10}
        self.interpolation_choices = {'delta': 0, 'linear': 1,
                                      'cubic': 2}
        self.monotonicity_choices = {'first_order': 0, 'i02': 1,
                                     'iwin': 2}

    def add_user_options(self, group):
        group.add_argument(
            '--rsolver', action='store', type=str, dest='rsolver',
            default=None, choices=set(self.rsolver_choices),
            help='Riemann solver to use.')
        group.add_argument(
            '--interpolation', action='store', type=str,
            dest='interpolation', default=None,
            choices=set(self.interpolation_choices),
            help='Interpolation algorithm to use.')
        group.add_argument(
            '--monotonicity', action='store', type=str,
            dest='monotonicity', default=None,
            choices=set(self.monotonicity_choices),
            help='Monotonicity algorithm to use.')
        group.add_argument('--g1', action='store', type=float,
                           dest='g1', default=None,
                           help='Thermal conduction parameter.')
        group.add_argument('--g2', action='store', type=float,
                           dest='g2', default=None,
                           help='Thermal conduction parameter.')
        group.add_argument('--gamma', action='store', type=float,
                           dest='gamma', default=None,
                           help='Gamma for the state equation.')
        group.add_argument('--blend-alpha', action='store', type=float,
                           dest='blend_alpha', default=None,
                           help='Blending factor for hybrid scheme.')
        add_bool_argument(
            group, 'interface-zero', dest='interface_zero',
            help='Set interface position to zero for Riemann problem.',
            default=None)
        add_bool_argument(group, 'hybrid', dest='hybrid',
                          help='Use the hybrid scheme.', default=None)

    def consume_user_options(self, options):
        data = dict((var, self._smart_getattr(options, var)) for var in
                    ('gamma', 'g1', 'g2', 'interface_zero', 'hybrid',
                     'blend_alpha'))
        for var in ('monotonicity', 'rsolver', 'interpolation'):
            res = getattr(options, var, None)
            data[var] = (getattr(self, var) if res is None else
                         getattr(self, var + '_choices')[res])
        self.configure(**data)

    def configure_solver(self, kernel=None, integrator_cls=None,
                         extra_steppers=None, **kw):
        from pysph_tpu_torch.base.kernels import Gaussian
        from pysph_tpu_torch.sph.integrator import EulerIntegrator
        from pysph_tpu_torch.sph.integrator_step import GSPHStep
        from pysph_tpu_torch.solver.solver import Solver
        _check_gas_ported(self)
        if kernel is None:
            kernel = Gaussian(dim=self.dim)
        steppers = dict(extra_steppers or {})
        for name in self.fluids:
            if name not in steppers:
                steppers[name] = GSPHStep()
        cls = EulerIntegrator if integrator_cls is None else integrator_cls
        integrator = cls(**steppers)
        self.solver = Solver(dim=self.dim, integrator=integrator,
                             kernel=kernel, **kw)
        if 'tf' in kw:
            self.tf = kw['tf']

    def get_equations(self):
        from pysph_tpu_torch.sph.equation import Group
        from pysph_tpu_torch.sph.gas_dynamics.basic import (
            IdealGasEOS, ScaleSmoothingLength, SummationDensity,
            UpdateSmoothingLengthFromVolume)
        from pysph_tpu_torch.sph.gas_dynamics.gsph import (
            GSPHAcceleration, GSPHGradients)
        _check_gas_ported(self)
        all_pa = self.fluids + self.solids
        equations = []
        equations.append(Group(equations=[
            ScaleSmoothingLength(dest=f, sources=None, factor=2.0)
            for f in self.fluids], update_nnps=True))
        equations.append(Group(equations=[
            SummationDensity(dest=f, sources=all_pa, dim=self.dim)
            for f in self.fluids], update_nnps=False))
        equations.append(Group(equations=[
            UpdateSmoothingLengthFromVolume(
                dest=f, sources=None, k=self.kernel_factor,
                dim=self.dim)
            for f in self.fluids], update_nnps=True))
        equations.append(Group(equations=[
            SummationDensity(dest=f, sources=all_pa, dim=self.dim)
            for f in self.fluids], update_nnps=False))
        equations.append(Group(equations=[
            IdealGasEOS(dest=f, sources=None, gamma=self.gamma)
            for f in self.fluids]))
        equations.append(Group(equations=[
            GSPHGradients(dest=f, sources=all_pa)
            for f in self.fluids]))
        # no tf: the hybrid blend takes GSPHAcceleration's tf = 1, as the
        # reference's
        equations.append(Group(equations=[
            GSPHAcceleration(
                dest=f, sources=all_pa, g1=self.g1, g2=self.g2,
                monotonicity=self.monotonicity, rsolver=self.rsolver,
                interpolation=self.interpolation,
                interface_zero=self.interface_zero, hybrid=self.hybrid,
                blend_alpha=self.blend_alpha, gamma=self.gamma,
                niter=self.niter, tol=self.tol)
            for f in self.fluids]))
        return equations

    def setup_properties(self, particles, clean=True):
        import numpy
        from pysph_tpu_torch.base.utils import get_particle_array_gasd
        _check_gas_ported(self)
        particle_arrays = dict((p.name, p) for p in particles)
        dummy = get_particle_array_gasd(name='junk')
        props = (list(dummy.properties.keys()) +
                 'px py pz ux uy uz vx vy vz wx wy wz'.split())
        output_props = dummy.output_property_arrays
        for fluid in self.fluids:
            pa = particle_arrays[fluid]
            self._ensure_properties(pa, props, clean)
            pa.add_property('orig_idx', type='int')
            pa.orig_idx = numpy.arange(pa.get_number_of_particles())
            pa.set_output_arrays(output_props)


class ADKEScheme(Scheme):
    """Adaptive kernel estimation (Sigalotti et al.): the ADKE summation
    density (h reset to h0, then ``reduce`` sets h = k (g / rho)^eps h0),
    the plain summation density at that h (re-binned after), the
    ideal-gas EOS and ``ADKEAccelerations``.  ``PECIntegrator`` with
    ``ADKEStep`` and ``Gaussian`` by default.  Walls and ghost particles
    are not ported: ``solids`` and ``has_ghosts`` raise."""

    def __init__(self, fluids, solids, dim, gamma=1.4, alpha=1.0,
                 beta=2.0, k=1.0, eps=0.0, g1=0.0, g2=0.0,
                 has_ghosts=False):
        self.fluids = fluids
        self.solids = solids
        self.dim = dim
        self.solver = None
        self.gamma = gamma
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.eps = eps
        self.g1 = g1
        self.g2 = g2
        self.has_ghosts = has_ghosts

    def add_user_options(self, group):
        group.add_argument('--alpha', action='store', type=float,
                           dest='alpha', default=None,
                           help='Artificial viscosity alpha.')
        group.add_argument('--beta', action='store', type=float,
                           dest='beta', default=None,
                           help='Artificial viscosity beta.')
        group.add_argument('--gamma', action='store', type=float,
                           dest='gamma', default=None,
                           help='EOS gamma.')
        group.add_argument('--g1', action='store', type=float,
                           dest='g1', default=None,
                           help='ADKE artificial heat g1.')
        group.add_argument('--g2', action='store', type=float,
                           dest='g2', default=None,
                           help='ADKE artificial heat g2.')
        group.add_argument('--adke-k', action='store', type=float,
                           dest='k', default=None,
                           help='ADKE kernel scaling k.')
        group.add_argument('--adke-eps', action='store', type=float,
                           dest='eps', default=None,
                           help='ADKE sensitivity eps.')

    def consume_user_options(self, options):
        data = dict((var, self._smart_getattr(options, var)) for var in
                    ('gamma', 'alpha', 'beta', 'g1', 'g2', 'k', 'eps'))
        self.configure(**data)

    def get_equations(self):
        from pysph_tpu_torch.sph.basic_equations import SummationDensity
        from pysph_tpu_torch.sph.equation import Group
        from pysph_tpu_torch.sph.gas_dynamics.basic import (
            ADKEAccelerations, IdealGasEOS, SummationDensityADKE)
        _check_gas_ported(self)
        equations = []
        equations.append(Group([
            SummationDensityADKE(
                f, sources=self.fluids + self.solids, k=self.k,
                eps=self.eps) for f in self.fluids],
            update_nnps=False, iterate=False))
        equations.append(Group([
            SummationDensity(f, self.fluids + self.solids)
            for f in self.fluids], update_nnps=True))
        equations.append(Group(equations=[
            IdealGasEOS(e, sources=None, gamma=self.gamma)
            for e in self.fluids + self.solids]))
        equations.append(Group(equations=[
            ADKEAccelerations(
                dest=f, sources=self.fluids + self.solids,
                alpha=self.alpha, beta=self.beta, g1=self.g1,
                g2=self.g2, k=self.k, eps=self.eps)
            for f in self.fluids]))
        return equations

    def configure_solver(self, kernel=None, integrator_cls=None,
                         extra_steppers=None, **kw):
        from pysph_tpu_torch.base.kernels import Gaussian
        from pysph_tpu_torch.sph.integrator import PECIntegrator
        from pysph_tpu_torch.sph.integrator_step import ADKEStep
        from pysph_tpu_torch.solver.solver import Solver
        _check_gas_ported(self)
        if kernel is None:
            kernel = Gaussian(dim=self.dim)
        steppers = dict(extra_steppers or {})
        for name in self.fluids:
            if name not in steppers:
                steppers[name] = ADKEStep()
        cls = PECIntegrator if integrator_cls is None else integrator_cls
        integrator = cls(**steppers)
        self.solver = Solver(dim=self.dim, integrator=integrator,
                             kernel=kernel, **kw)

    def setup_properties(self, particles, clean=True):
        import numpy
        from pysph_tpu_torch.base.utils import get_particle_array
        _check_gas_ported(self)
        particle_arrays = dict((p.name, p) for p in particles)
        required_props = [
            'x', 'y', 'z', 'u', 'v', 'w', 'rho', 'h', 'm', 'cs', 'p',
            'e', 'au', 'av', 'aw', 'arho', 'ae', 'am', 'ah', 'x0',
            'y0', 'z0', 'u0', 'v0', 'w0', 'rho0', 'e0', 'h0', 'div',
            'wij', 'htmp', 'logrho']
        dummy = get_particle_array(additional_props=required_props,
                                   name='junk')
        dummy.set_output_arrays(
            ['x', 'y', 'u', 'v', 'rho', 'm', 'h', 'cs', 'p', 'e',
             'au', 'av', 'ae', 'pid', 'gid', 'tag'])
        props = list(dummy.properties.keys())
        output_props = dummy.output_property_arrays
        for name in self.solids + self.fluids:
            pa = particle_arrays[name]
            self._ensure_properties(pa, props, clean)
            if name in self.fluids:
                pa.add_property('orig_idx', type='int')
                pa.orig_idx = numpy.arange(
                    pa.get_number_of_particles())
            pa.set_output_arrays(output_props)
