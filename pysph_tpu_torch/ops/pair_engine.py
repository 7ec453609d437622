"""Planning: which pair phases a hand-written pair kernel runs.

Ten kernels take a dest's pair phases, all its sources in one call:

- ``wcsph_pair`` (``ops/wcsph_pair.py``, the dam_break_3d main path, the
  elliptical drop and the Taylor-Green vortex's ``--scheme wcsph``):
  every equation with sources is ``SummationDensity``,
  ``ContinuityEquation``, ``MomentumEquation`` (with or without the
  tensile correction), ``XSPHCorrection``, ``LaminarViscosity``,
  ``ContinuityEquationDeltaSPH``, ``MomentumEquationDeltaSPH`` or
  ``LaminarViscosityDeltaSPH``;
- ``dense_pair`` (``ops/dense_pair.py``): the same phase sets but for the
  three delta-SPH terms, walked one thread block per dest cell;
- ``delta_pair`` (``ops/delta_pair.py``, the delta-SPH pre-phases): every
  source takes ``GradientCorrectionPreStep`` alone, or
  ``GradientCorrection`` then ``ContinuityEquationDeltaSPHPreStep``, or
  the latter alone, the same for every source.  ``GradientCorrection``
  rewrites ``DWIJ`` for the equation after it: a symbol, which the rule
  below does not see, so ``delta_pair``'s planner accepts exactly that
  ordered pair;
- ``gtvf_pair`` (``ops/gtvf_pair.py``, the GTVF dam break and the
  Taylor-Green vortex's ``--scheme gtvf``, the walls of ``TVFScheme`` and
  ``EDACScheme``): the equations fall in one of its six phase sets
  (``SetWallVelocity``; ``ContinuityEquationGTVF`` +
  ``ContinuitySolid``; ``CorrectDensity``; ``VolumeSummation`` +
  ``SolidWallPressureBC``; ``MomentumEquationPressureGradient`` +
  ``MomentumEquationViscosity`` + ``MomentumEquationArtificialStress``;
  EDAC's wall set, ``SourceNumberDensity`` + ``VolumeSummation`` + EDAC's
  ``SolidWallPressureBC`` and ``SetWallVelocity``);
- ``tvf_pair`` (``ops/tvf_pair.py``, ``TVFScheme``'s and
  ``EDACScheme``'s groups: the Taylor-Green vortex, the wall examples,
  the EDAC runs): the equations of a dest fall in one of its two phase
  sets (``SummationDensity`` and EDAC's ``ComputeAveragePressure``; the
  TVF ``MomentumEquationPressureGradient``,
  ``MomentumEquationViscosity``, ``MomentumEquationArtificialStress``,
  ``MomentumEquationArtificialViscosity`` and ``SolidWallNoSlipBC``,
  EDAC's ``MomentumEquationPressureGradient``, ``MomentumEquation`` and
  ``EDACEquation``, and ``XSPHCorrection``);
- ``iisph_pair`` (``ops/iisph_pair.py``, ``IISPHScheme``'s groups: the
  IISPH dam break, drop and Taylor-Green vortex): the equations of a
  dest fall in one of its six phase sets (``NumberDensity``,
  ``SummationDensity``, ``SummationDensityBoundary``; ``ComputeDII`` and
  the viscosities, with their wall terms; ``ComputeRhoAdvection``,
  ``ComputeAII`` and their wall terms; ``ComputeDIJPJ``;
  ``PressureSolve`` and its wall term; ``PressureForce`` and its wall
  term), each plan taking the step's dt (``PairPlan.takes_dt``);
- ``gasd_pair`` (``ops/gasd_pair.py``, ``GasDScheme``'s MPM groups: the
  shock tube and the Sedov blast; ``ADKEScheme``'s: the shock tube, the
  accuracy test and the hydrostatic box): every source of a dest takes
  ``SummationDensity`` (the density set), every source
  ``MPMAccelerations`` (the momentum set), every source
  ``SummationDensityADKE`` (ADKE's density set) or every source
  ``ADKEAccelerations`` (ADKE's accelerations);
- ``gsph_pair`` (``ops/gsph_pair.py``, ``GSPHScheme``'s groups: the
  accuracy test, the hydrostatic box and the shock tube): every source
  of a dest takes ``GSPHGradients`` (the gradients) or every source
  ``GSPHAcceleration`` with the same constants (the accelerations), each
  plan taking the step's t and dt (``PairPlan.takes_time``);
- ``tsph_pair`` (``ops/tsph_pair.py``, ``TSPHScheme``'s groups: the
  accuracy test, the hydrostatic box, Sedov's blast and Cheng-Shu's
  wave): every source of a dest takes TSPH's ``SummationDensity`` (the
  density set), every source ``VelocityGradDivC1`` (the velocity
  gradient) or every source ``MomentumAndEnergy`` with the same
  constants (the momentum), in the kernel's dimensions;
- ``crksph_pair`` (``ops/crksph_pair.py``, ``CRKSPHScheme``'s groups: the
  accuracy test, the hydrostatic box and the Taylor-Green vortex): every
  source of a dest takes one of its six ordered sets (``_crksph_sets``),
  the same set with the same constants.  ``CRKSPHSymmetric`` rewrites
  ``DWIJ``, ``DWI`` and ``DWJ`` for the equation after it, as
  ``GradientCorrection`` does, so its planner accepts exactly those
  orders; a 1D dest raises ``NotImplementedError`` (ROADMAP Queue 1 item
  27) rather than leave it to the torch engine.

Every kernel takes every kernel with a ``kernel_kind`` (not the ``_1D``
ones: ROADMAP Queue 1 item 28; where a set is ``gasd_pair``'s or
``gsph_pair``'s, such a kernel raises ``NotImplementedError`` rather than
leave the 1D gas runs to the torch engine), and every kernel walks a
periodic grid (the wrapped stencil, the minimum image).

For each, each equation appears at most once per source, with at most
``MAX_SOURCES`` sources, and no equation reads a property that another
one accumulates (the kernels give every read the value from before the
phase).  The per-source term masks say which equations each source
takes.  Anything else raises ``PairIneligible`` and the evaluator runs
the torch pair engine instead.

``link_pairs`` links two plans of one kernel for one dest where nothing
between them moves the pairs: a dest's ``delta_pair`` moment plan and
its corrected gradient plan in the group right after it, a dest's
``tvf_pair`` density plan and its momentum plan in a later group (and
the mean-pressure plan of ``EDACScheme`` between them), a dest's
``gsph_pair`` gradients plan and its acceleration plan, a dest's
``crksph_pair`` number density plan and its momentum plan (and the
moments, density and velocity gradient plans between them); and a chain
of a dest's ``iisph_pair`` plans: the first that sees every later plan's
sources (a later plan may read fewer) emits, and every later one (each
pressure sweep's two among them, run again every sweep) reads.  The
first call then hands its neighbour list and packed copies to the later
ones (``PairPlan.link``, ``ops/pair_link.py``), which walk no
candidates.  The evaluator plans and links the groups of an iterated
group's sub-tree as they run in one sweep (``leaf_groups``).

``plan_sweep`` plans ``GasDScheme``'s iterated density group (one
dest's ``SummationDensity`` with ``density_iterations``, re-binned every
sweep) onto ``gasd_sweep`` (``ops/gasd_pair.py``), and ``TSPHScheme``'s
onto ``tsph_sweep`` (``ops/tsph_pair.py``): a ``SweepPlan``, whose sweeps
the evaluator runs gated on the card (``sph/
acceleration_eval.py::_run_swept``), and ``link_sweep`` links it to the
dest's ``MPMAccelerations`` plan after it (``TSPHScheme``'s: its
``VelocityGradDivC1`` plan, then its ``MomentumAndEnergy`` plan), which
then read the last sweep's neighbour list where the iteration ended
converged.

``plan_solve`` plans an iterated group onto ``iisph_solve``
(``ops/iisph_solve.py``) where its tree is exactly IISPH's pressure solve
(``ComputeDIJPJ``, then ``PressureSolve`` and at most walls'
``PressureSolveBoundary``, of one dest) and both sub-groups' plans read
the list of the dest's emitting ``iisph_pair`` launch: one launch then
runs every sweep, the loop condition on the card (``SolvePlan``).

The engine (``config.py``) picks the kernels: ``kernel`` plans the WCSPH
sets onto ``wcsph_pair``, the GTVF sets onto ``gtvf_pair``, the
delta-SPH pre-phases onto ``delta_pair``, TVF's and EDAC's sets onto
``tvf_pair``, IISPH's onto ``iisph_pair``, the MPM and ADKE sets onto
``gasd_pair``, GSPH's onto ``gsph_pair``, CRKSPH's onto
``crksph_pair`` and TSPH's onto ``tsph_pair``; ``dense`` plans the WCSPH
sets without delta-SPH terms onto ``dense_pair`` and nothing else, as the JAX
package's dense-slot engine refuses sequential and strided phases
(``pallas_engine.py:855-861``): the GTVF sets, the delta-SPH pre-phases
(their outputs ``m_mat`` and ``gradrho`` are strided) and the delta-SPH
main group (it reads the strided ``gradrho``) run on the torch engine.
"""

import logging
from typing import Callable, NamedTuple, Optional

from pysph_tpu_torch.base.kernels import kernel_kind
from pysph_tpu_torch.ops import crksph_pair as _cp
from pysph_tpu_torch.ops import delta_pair as _dl
from pysph_tpu_torch.ops import dense_pair as _dp
from pysph_tpu_torch.ops import gasd_pair as _gd
from pysph_tpu_torch.ops import gsph_pair as _gs
from pysph_tpu_torch.ops import gtvf_pair as _gp
from pysph_tpu_torch.ops import iisph_pair as _ip
from pysph_tpu_torch.ops import iisph_solve as _is
from pysph_tpu_torch.ops import pair_link as _pl
from pysph_tpu_torch.ops import tsph_pair as _ts
from pysph_tpu_torch.ops import tvf_pair as _tp
from pysph_tpu_torch.ops import wcsph_pair as _wp
from pysph_tpu_torch.sph.basic_equations import (
    ContinuityEquation, SummationDensity, XSPHCorrection)
from pysph_tpu_torch.sph.equation import _method_args
from pysph_tpu_torch.sph.wc.basic import (
    ContinuityEquationDeltaSPH, ContinuityEquationDeltaSPHPreStep,
    MomentumEquation, MomentumEquationDeltaSPH)
from pysph_tpu_torch.sph.wc.kernel_correction import (
    GradientCorrection, GradientCorrectionPreStep)
from pysph_tpu_torch.sph.wc.viscosity import (
    LaminarViscosity, LaminarViscosityDeltaSPH)


def _momentum_term(eq):
    return _wp.MOM | (_wp.TENS if eq.tensile_correction else 0)


#: the term bits of each equation type, or a function of the equation
_DENSE_TERMS = {ContinuityEquation: _wp.CONT, MomentumEquation: _momentum_term,
                XSPHCorrection: _wp.XSPH, LaminarViscosity: _wp.VISC,
                SummationDensity: _wp.SDEN}
_WCSPH_TERMS = {**_DENSE_TERMS, ContinuityEquationDeltaSPH: _wp.DCONT,
                MomentumEquationDeltaSPH: _wp.DMOM,
                LaminarViscosityDeltaSPH: _wp.LVD}
#: delta_pair's term masks by the equation types of a source, in order
_DELTA_SETS = {
    (GradientCorrectionPreStep,): _dl.MMAT,
    (GradientCorrection, ContinuityEquationDeltaSPHPreStep):
        _dl.CORR | _dl.GRAD,
    (ContinuityEquationDeltaSPHPreStep,): _dl.GRAD}

# pair symbols -> the props they read on both sides
_SYM_READS = {'HIJ': ('h',), 'EPS': ('h',), 'RHOIJ': ('rho',),
              'RHOIJ1': ('rho',), 'XIJ': ('x', 'y', 'z'),
              'VIJ': ('u', 'v', 'w'), 'R2IJ': ('x', 'y', 'z'),
              'RINV': ('x', 'y', 'z'), 'RIJ': ('x', 'y', 'z'),
              **{sym: ('x', 'y', 'z', 'h') for sym in (
                  'WIJ', 'WI', 'WJ', 'DWIJ', 'DWI', 'DWJ', 'GHIJ', 'GHI',
                  'GHJ', 'WDASHIJ', 'WDASHI', 'WDASHJ')},
              'WDP': ('h',)}


logger = logging.getLogger(__name__)


class PairIneligible(Exception):
    """The pair phases of a dest do not match a kernel's set."""


class PairSource(NamedTuple):
    """One source of a dest's fused ``wcsph_pair`` phases, its term mask
    and its equations' constants."""
    name: str
    terms: int
    c0: float = 0.0
    alpha: float = 0.0
    beta: float = 0.0
    eps: float = 0.0
    delta: float = 0.0
    delta_c0: float = 0.0
    dmom_alpha: float = 0.0
    dmom_c0: float = 0.0
    rho0: float = 0.0
    nu: float = 0.0
    eta: float = 0.0
    lvd_nu: float = 0.0
    lvd_rho0: float = 0.0
    lvd_dim: int = 0


def _gtvf_terms():
    # imported here: sph/wc/gtvf.py imports the integrator, which
    # imports the evaluator, which imports this module
    from pysph_tpu_torch.sph.wc import edac
    from pysph_tpu_torch.sph.wc.gtvf import (
        ContinuityEquationGTVF, CorrectDensity,
        MomentumEquationArtificialStress, MomentumEquationPressureGradient,
        MomentumEquationViscosity)
    from pysph_tpu_torch.sph.wc.transport_velocity import (
        ContinuitySolid, SetWallVelocity, SolidWallPressureBC,
        VolumeSummation)
    return {SetWallVelocity: _gp.SWV, ContinuityEquationGTVF: _gp.CGTVF,
            ContinuitySolid: _gp.CSOLID, CorrectDensity: _gp.CDENS,
            VolumeSummation: _gp.VSUM, SolidWallPressureBC: _gp.WALLP,
            MomentumEquationPressureGradient: _gp.MPG,
            MomentumEquationViscosity: _gp.MVISC,
            MomentumEquationArtificialStress: _gp.MAS,
            edac.SourceNumberDensity: _gp.SND,
            edac.SolidWallPressureBC: _gp.EWALLP,
            edac.SetWallVelocity: _gp.ESWV}


def _reads(eq):
    props = set()
    for arg in _method_args(eq.loop):
        if arg[:2] in ('d_', 's_'):
            props.add(arg[2:])
        props.update(_SYM_READS.get(arg, ()))
    return props


def _source_terms(sources, term_of, term_outputs, max_sources):
    """[(src, terms, eqs)] for ``sources`` ({src: [equations]}), or
    ``PairIneligible`` if an equation is not the kernel's, appears twice
    for a source, or reads what another one accumulates."""
    if len(sources) > max_sources:
        raise PairIneligible('%d sources (at most %d)'
                             % (len(sources), max_sources))
    out = []
    writes, reads = {}, set()
    for src, eqs in sources.items():
        terms = 0
        for eq in eqs:
            term = term_of.get(type(eq))
            if term is None:
                raise PairIneligible('equation %s' % eq.name)
            if callable(term):
                term = term(eq)
            if terms & term:
                raise PairIneligible('%s twice for source %s'
                                     % (eq.name, src))
            terms |= term
            own = {p for t, ps in term_outputs.items() if term & t
                   for p in ps}
            for p in own:
                writes.setdefault(p, set()).add(type(eq))
            reads |= {(p, type(eq)) for p in _reads(eq) - own}
        out.append((src, terms, eqs))
    for prop, cls in reads:
        if writes.get(prop, set()) - {cls}:
            raise PairIneligible('%s reads %r, which another equation '
                                 'accumulates' % (cls.__name__, prop))
    return out


def _tvf_terms():
    # imported here, as _gtvf_terms
    from pysph_tpu_torch.sph.wc import edac
    from pysph_tpu_torch.sph.wc.transport_velocity import (
        MomentumEquationArtificialStress,
        MomentumEquationArtificialViscosity,
        MomentumEquationPressureGradient, MomentumEquationViscosity,
        SolidWallNoSlipBC, SummationDensity)
    return {SummationDensity: _tp.SDEN,
            MomentumEquationPressureGradient: _tp.MPG,
            MomentumEquationViscosity: _tp.VISC,
            MomentumEquationArtificialStress: _tp.MAS,
            MomentumEquationArtificialViscosity: _tp.AVIS,
            SolidWallNoSlipBC: _tp.NOSLIP,
            edac.ComputeAveragePressure: _tp.AVGP,
            edac.MomentumEquationPressureGradient: _tp.EMPG,
            edac.MomentumEquation: _tp.EMOM,
            edac.EDACEquation: _tp.EDACEQ,
            XSPHCorrection: _tp.XSPH}


def _check_kind(kernel):
    if kernel_kind(kernel) is None:
        raise PairIneligible('kernel %r has no shape function in the pair '
                             'kernels (1D kernels: ROADMAP Queue 1 item '
                             '28)' % kernel)


def _plan_wcsph(dest, sources, kernel, op=_wp.wcsph_pair,
                term_of=_WCSPH_TERMS):
    _check_kind(kernel)
    plan_sources = []
    terms = 0
    for src, t, eqs in _source_terms(sources, term_of, _wp.TERM_OUTPUTS,
                                     _wp.MAX_SOURCES):
        params = {}
        for eq in eqs:
            if isinstance(eq, MomentumEquation):
                params.update(c0=eq.c0, alpha=eq.alpha, beta=eq.beta)
            elif isinstance(eq, XSPHCorrection):
                params['eps'] = eq.eps
            elif isinstance(eq, ContinuityEquationDeltaSPH):
                params.update(delta=eq.delta, delta_c0=eq.c0)
            elif isinstance(eq, MomentumEquationDeltaSPH):
                params.update(dmom_alpha=eq.alpha, dmom_c0=eq.c0,
                              rho0=eq.rho0)
            elif isinstance(eq, LaminarViscosity):
                params.update(nu=eq.nu, eta=eq.eta)
            elif isinstance(eq, LaminarViscosityDeltaSPH):
                params.update(lvd_nu=eq.nu, lvd_rho0=eq.rho0,
                              lvd_dim=eq.dim)
        plan_sources.append(PairSource(src, t, **params))
        terms |= t
    return PairPlan(dest, plan_sources, kernel, op,
                    _wp.wcsph_pair_reference, _wp.outputs_for(terms))


def _plan_dense(dest, sources, kernel):
    return _plan_wcsph(dest, sources, kernel, op=_dp.dense_pair,
                       term_of=_DENSE_TERMS)


def _plan_delta(dest, sources, kernel):
    _check_kind(kernel)
    if len(sources) > _dl.MAX_SOURCES:
        raise PairIneligible('%d sources (at most %d)'
                             % (len(sources), _dl.MAX_SOURCES))
    plan_sources = []
    for src, eqs in sources.items():
        terms = _DELTA_SETS.get(tuple(type(eq) for eq in eqs))
        if terms is None:
            raise PairIneligible('equations %s of source %s' % (
                [eq.name for eq in eqs], src))
        dim = eqs[0].dim if terms & (_dl.MMAT | _dl.CORR) else 0
        tol = eqs[0].tol if terms & _dl.CORR else 0.1
        plan_sources.append(_dl.DeltaSource(src, terms, dim, tol))
    first = plan_sources[0]
    if any(ds[1:] != first[1:] for ds in plan_sources):
        raise PairIneligible('sources of different delta-SPH phases')
    return PairPlan(dest, plan_sources, kernel, _dl.delta_pair,
                    _dl.delta_pair_reference, _dl.outputs_for(first.terms))


def _plan_gtvf(dest, sources, kernel):
    _check_kind(kernel)
    term_of = _gtvf_terms()
    plan_sources = []
    terms = 0
    for src, t, eqs in _source_terms(sources, term_of, _gp.TERM_OUTPUTS,
                                     _gp.MAX_SOURCES):
        gravity = next(((eq.gx, eq.gy, eq.gz) for eq in eqs
                        if term_of[type(eq)] in (_gp.WALLP, _gp.EWALLP)),
                       (0.0, 0.0, 0.0))
        nu = next((eq.nu for eq in eqs if term_of[type(eq)] == _gp.MVISC),
                  0.0)
        plan_sources.append(_gp.GtvfSource(src, t, tuple(eqs), gravity,
                                           nu))
        terms |= t
    if _gp.phase_of(terms) is None:
        raise PairIneligible('GTVF terms %#x span two phase sets' % terms)
    return PairPlan(dest, plan_sources, kernel, _gp.gtvf_pair,
                    _gp.gtvf_pair_reference, _gp.outputs_for(terms))


def _plan_tvf(dest, sources, kernel):
    _check_kind(kernel)
    term_of = _tvf_terms()
    plan_sources = []
    terms = 0
    for src, t, eqs in _source_terms(sources, term_of, _tp.TERM_OUTPUTS,
                                     _tp.MAX_SOURCES):
        params = {}
        for eq in eqs:
            term = term_of[type(eq)]
            if term in (_tp.MPG, _tp.EMPG):
                params['pb'] = eq.pb
            elif term == _tp.VISC:
                params['nu'] = eq.nu
            elif term == _tp.AVIS:
                params.update(alpha=eq.alpha, c0=eq.c0)
            elif term == _tp.NOSLIP:
                params['noslip_nu'] = eq.nu
            elif term == _tp.EDACEQ:
                params.update(cs=eq.cs, edac_nu=eq.nu)
            elif term == _tp.XSPH:
                params['eps'] = eq.eps
        plan_sources.append(_tp.TvfSource(src, t, tuple(eqs), **params))
        terms |= t
    if _tp.phase_of(terms) is None:
        raise PairIneligible('TVF terms %#x span two phase sets' % terms)
    if terms & _tp.MPG and terms & _tp.EMPG:
        raise PairIneligible('TVF\'s and EDAC\'s pressure gradients share '
                             'the background pressure')
    return PairPlan(dest, plan_sources, kernel, _tp.tvf_pair,
                    _tp.tvf_pair_reference, _tp.outputs_for(terms))


def _iisph_terms():
    # imported here, as _gtvf_terms
    from pysph_tpu_torch.sph import iisph
    return {iisph.NumberDensity: _ip.NDEN,
            iisph.SummationDensity: _ip.SDEN,
            iisph.SummationDensityBoundary: _ip.SDENB,
            iisph.ComputeDII: _ip.DII, iisph.ComputeDIIBoundary: _ip.DIIB,
            iisph.ViscosityAcceleration: _ip.VISC,
            iisph.ViscosityAccelerationBoundary: _ip.VISCB,
            iisph.ComputeRhoAdvection: _ip.RHOADV,
            iisph.ComputeRhoBoundary: _ip.RHOB,
            iisph.ComputeAII: _ip.AII, iisph.ComputeAIIBoundary: _ip.AIIB,
            iisph.ComputeDIJPJ: _ip.DIJPJ, iisph.PressureSolve: _ip.PSOLVE,
            iisph.PressureSolveBoundary: _ip.PSOLVEB,
            iisph.PressureForce: _ip.PFORCE,
            iisph.PressureForceBoundary: _ip.PFORCEB}


def _one(eqs, attr, what):
    """The one value of ``attr`` that the equations of a source that have
    it give, or 0.0; ``PairIneligible`` where they differ (the kernel
    takes one a source)."""
    values = {getattr(eq, attr) for eq in eqs if hasattr(eq, attr)}
    if len(values) > 1:
        raise PairIneligible('%s: %s differ (%s)' % (what, attr,
                                                     sorted(values)))
    return values.pop() if values else 0.0


def _plan_iisph(dest, sources, kernel):
    _check_kind(kernel)
    term_of = _iisph_terms()
    plan_sources = []
    terms = 0
    for src, t, eqs in _source_terms(sources, term_of, _ip.TERM_OUTPUTS,
                                     _ip.MAX_SOURCES):
        plan_sources.append(_ip.IisphSource(
            src, t, tuple(eqs), rho0=_one(eqs, 'rho0', src),
            nu=_one(eqs, 'nu', src)))
        terms |= t
    if _ip.phase_of(terms) is None:
        raise PairIneligible('IISPH terms %#x span two phase sets' % terms)
    return PairPlan(dest, plan_sources, kernel, _ip.iisph_pair,
                    _ip.iisph_pair_reference, _ip.outputs_for(terms),
                    takes_dt=True)


def _gasd_terms():
    # imported here, as _gtvf_terms
    from pysph_tpu_torch.sph.gas_dynamics import basic
    return {basic.SummationDensity: _gd.SDEN,
            basic.MPMAccelerations: _gd.MPM,
            basic.SummationDensityADKE: _gd.ADEN,
            basic.ADKEAccelerations: _gd.ADKE}


def _refuse_1d(name, kernel):
    """A gas set's kernel must have a shape function: the gas runs are 1D
    and 2D, where the _1D kernels are offered, and a refusal here would run
    them on the torch engine unannounced."""
    if kernel_kind(kernel) is None:
        raise NotImplementedError(
            '%s: kernel %r has no shape function in the pair kernels (1D '
            'kernels: ROADMAP Queue 1 item 28); run it with --engine torch'
            % (name, kernel))


def _plan_gasd(dest, sources, kernel):
    term_of = _gasd_terms()
    plan_sources = []
    terms = 0
    for src, t, eqs in _source_terms(sources, term_of, _gd.TERM_OUTPUTS,
                                     _gd.MAX_SOURCES):
        plan_sources.append(_gd.GasdSource(
            src, t, tuple(eqs), beta=_one(eqs, 'beta', src),
            alpha=_one(eqs, 'alpha', src), g1=_one(eqs, 'g1', src),
            g2=_one(eqs, 'g2', src)))
        terms |= t
    if _gd.phase_of(terms) is None or any(
            ps.terms != terms for ps in plan_sources):
        raise PairIneligible('gas-dynamics terms %#x: not one phase set for '
                             'every source' % terms)
    _refuse_1d('gasd_pair', kernel)
    return PairPlan(dest, plan_sources, kernel, _gd.gasd_pair,
                    _gd.gasd_pair_reference, _gd.TERM_OUTPUTS[terms])


def _tsph_terms():
    # imported here, as _gtvf_terms
    from pysph_tpu_torch.sph.gas_dynamics import tsph
    return {tsph.SummationDensity: _ts.SDEN,
            tsph.VelocityGradDivC1: _ts.GRADV,
            tsph.MomentumAndEnergy: _ts.MOM}


def _plan_tsph(dest, sources, kernel):
    term_of = _tsph_terms()
    plan_sources = []
    terms = 0
    for src, t, eqs in _source_terms(sources, term_of, _ts.TERM_OUTPUTS,
                                     _ts.MAX_SOURCES):
        dims = {eq.dim for eq in eqs}
        if dims != {kernel.dim}:
            raise PairIneligible('TSPH equations in %s dimensions, the '
                                 'kernel in %d' % (sorted(dims), kernel.dim))
        plan_sources.append(_ts.TsphSource(
            src, t, tuple(eqs), beta=_one(eqs, 'beta', src),
            fkern=_one(eqs, 'fkern', src) or 1.0))
        terms |= t
    if _ts.phase_of(terms) is None or any(
            ps.terms != terms for ps in plan_sources):
        raise PairIneligible('TSPH terms %#x: not one phase set for every '
                             'source' % terms)
    if len({ps[3:] for ps in plan_sources}) != 1:
        raise PairIneligible('MomentumAndEnergy: sources of different '
                             'constants')
    _refuse_1d('tsph_pair', kernel)
    return PairPlan(dest, plan_sources, kernel, _ts.tsph_pair,
                    _ts.tsph_pair_reference, _ts.TERM_OUTPUTS[terms])


def _gsph_terms():
    # imported here, as _gtvf_terms
    from pysph_tpu_torch.sph.gas_dynamics import gsph
    return {gsph.GSPHGradients: _gs.GRAD, gsph.GSPHAcceleration: _gs.ACC}


def _plan_gsph(dest, sources, kernel):
    term_of = _gsph_terms()
    plan_sources = []
    terms = 0
    for src, t, eqs in _source_terms(sources, term_of, _gs.TERM_OUTPUTS,
                                     _gs.MAX_SOURCES):
        params = next((_gs.params_of(eq) for eq in eqs
                       if term_of[type(eq)] == _gs.ACC), _gs.GsphParams())
        plan_sources.append(_gs.GsphSource(src, t, tuple(eqs), params))
        terms |= t
    if _gs.phase_of(terms) is None or any(
            ps.terms != terms for ps in plan_sources):
        raise PairIneligible('GSPH terms %#x: not one phase set for every '
                             'source' % terms)
    if len({ps.params for ps in plan_sources}) != 1:
        raise PairIneligible('GSPHAcceleration: sources of different '
                             'constants')
    if not 0 <= plan_sources[0].params.rsolver < _gs.RSOLVERS:
        raise ValueError('GSPHAcceleration: no Riemann solver %r (0-10)'
                         % plan_sources[0].params.rsolver)
    _refuse_1d('gsph_pair', kernel)
    return PairPlan(dest, plan_sources, kernel, _gs.gsph_pair,
                    _gs.gsph_pair_reference, _gs.TERM_OUTPUTS[terms],
                    takes_time=True)


def _crksph_sets():
    """``crksph_pair``'s term masks by the equation types of a source, in
    order."""
    # imported here, as _gtvf_terms
    from pysph_tpu_torch.sph.wc import crksph
    sym = crksph.CRKSPHSymmetric
    return {(crksph.NumberDensity,): _cp.NDEN,
            (crksph.CRKSPHPreStep,): _cp.MOMS,
            (sym, crksph.SummationDensityCRKSPH): _cp.RHO,
            (sym, crksph.VelocityGradient): _cp.GRADV,
            (sym, crksph.MomentumEquation): _cp.MOM,
            (sym, crksph.MomentumEquation, LaminarViscosity):
                _cp.MOM | _cp.VISC,
            (sym, crksph.EnergyEquation): _cp.ENERGY}


def _crksph_constants(eqs):
    """The kernel's constants of one source's equations."""
    from pysph_tpu_torch.sph.wc import crksph
    out = {}
    for eq in eqs:
        if isinstance(eq, (crksph.MomentumEquation, crksph.EnergyEquation)):
            out.update(cl=float(eq.cl), cq=float(eq.cq),
                       eta_crit=float(eq.eta_crit),
                       eta_fold=float(eq.eta_fold),
                       gamma=float(getattr(eq, 'gamma', 0.0)))
        elif isinstance(eq, LaminarViscosity):
            out.update(nu=float(eq.nu), eta=float(eq.eta))
    return out


def _plan_crksph(dest, sources, kernel):
    if len(sources) > _cp.MAX_SOURCES:
        raise PairIneligible('%d sources (at most %d)'
                             % (len(sources), _cp.MAX_SOURCES))
    sets = _crksph_sets()
    plan_sources = []
    for src, eqs in sources.items():
        terms = sets.get(tuple(type(eq) for eq in eqs))
        if terms is None:
            raise PairIneligible('equations %s of source %s' % (
                [eq.name for eq in eqs], src))
        dims = {eq.dim for eq in eqs if hasattr(eq, 'dim')}
        if dims - {kernel.dim}:
            raise PairIneligible('CRKSPH equations in %s dimensions, the '
                                 'kernel in %d' % (sorted(dims), kernel.dim))
        plan_sources.append(_cp.CrkSource(src, terms, tuple(eqs),
                                          **_crksph_constants(eqs)))
    first = plan_sources[0]
    if any(ps.terms != first.terms or ps[3:] != first[3:]
           for ps in plan_sources):
        raise PairIneligible('sources of different CRKSPH sets or '
                             'constants')
    _check_kind(kernel)
    _cp.sets_of(kernel.dim)
    return PairPlan(dest, plan_sources, kernel, _cp.crksph_pair,
                    _cp.crksph_pair_reference, _cp.TERM_OUTPUTS[first.terms])


_PLANNERS = {'kernel': (_plan_wcsph, _plan_gtvf, _plan_delta, _plan_tvf,
                        _plan_iisph, _plan_gasd, _plan_gsph, _plan_crksph,
                        _plan_tsph),
             'dense': (_plan_dense,)}


def plan_pair_phases(dest, sources, kernel, engine='kernel'):
    """``sources``: ordered {src name: [equations]}.  Returns the
    ``PairPlan`` of the first of the ``engine``'s kernels that takes
    them, or raises ``PairIneligible`` with each kernel's reason."""
    reasons = []
    for planner in _PLANNERS[engine]:
        try:
            return planner(dest, sources, kernel)
        except PairIneligible as e:
            reasons.append('%s: %s' % (planner.__name__[6:], e))
    raise PairIneligible('; '.join(reasons))


#: the equations of the delta planner's sets: none writes x y z h m rho
#: or has a post_loop, so a linked pair's two calls see the same pairs
#: in support and the same packed records
_DELTA_EQUATIONS = frozenset(t for eqs in _DELTA_SETS for t in eqs)


def _tvf_link_equations():
    """The equations that may lie between a linked ``tvf_pair`` density
    call and its momentum call, those calls' own included: ``tvf_pair``'s
    pair equations (TVF's and EDAC's), the EOS and the walls' velocity,
    pressure and volume (``TVFScheme``'s and ``EDACScheme``'s groups;
    ``ClampWallPressure`` a ``post_loop`` alone).  None writes x y z h,
    so every call sees the same pairs in support; the consuming calls
    pack the other props afresh."""
    # imported here, as _gtvf_terms
    from pysph_tpu_torch.sph.wc import edac
    from pysph_tpu_torch.sph.wc.transport_velocity import (
        SetWallVelocity, SolidWallPressureBC, StateEquation,
        VolumeSummation)
    return frozenset(_tvf_terms()) | {
        StateEquation, SetWallVelocity, SolidWallPressureBC,
        VolumeSummation, edac.SourceNumberDensity, edac.SolidWallPressureBC,
        edac.SetWallVelocity, edac.ClampWallPressure}


def _gsph_link_equations():
    """The equations that may lie between a linked ``gsph_pair``
    gradients call and its acceleration call, those calls' own: none
    writes a prop of the gradients' packed planes (``x y z h``, ``u v w
    m``, ``rho p cs e``), which the acceleration call reads from the
    gradients call's copy."""
    # imported here, as _gtvf_terms
    from pysph_tpu_torch.sph.gas_dynamics import gsph
    return frozenset((gsph.GSPHGradients, gsph.GSPHAcceleration))


def _crksph_link_equations():
    """The equations that may lie between a linked ``crksph_pair`` number
    density call and its momentum call, those calls' own included:
    ``CRKSPHScheme``'s pair equations, ``LaminarViscosity`` and its EOS
    (``StateEquation``, ``SpeedOfSound``).  None writes x y z h, so every
    call of the chain sees the same pairs in support; the reading calls
    pack their further props afresh."""
    # imported here, as _gtvf_terms
    from pysph_tpu_torch.sph.wc import crksph
    return frozenset(cls for eqs in _crksph_sets() for cls in eqs) | {
        crksph.StateEquation, crksph.SpeedOfSound}


def _crksph_capacity(emitter, consumer):
    dim = emitter.kernel.dim
    if dim not in _cp.CAPACITY:
        return 'no list capacity in %dD (CRKSPH at h = 2 dx: ~900 pairs a ' \
            'dest); its sets walk' % dim
    return None


def _delta_dims(moment, gradient):
    mdim, cdim = moment.sources[0].dim, gradient.sources[0].dim
    if mdim != moment.kernel.dim or cdim > mdim:
        return 'the moment in %d dimensions, the correction in %d' % (
            mdim, cdim)
    return None


def _terms_of(plan):
    terms = 0
    for ts in plan.sources:
        terms |= ts.terms
    return terms


def _tvf_phase(plan):
    return _tp.phase_of(_terms_of(plan))


class _LinkRule(NamedTuple):
    """How one kernel's plans link: ``emits(plan)`` and
    ``consumes(plan)`` pick the two calls; the consumer is the kernel's
    next plan for the dest within ``reach`` groups after the emitter's
    (None: any later group) but those that ``passes(plan)`` takes, which
    read the list too (``Link.middle``); every equation of the groups
    from the emitter's to the consumer's must be one of ``equations()``,
    and ``check(emitter, consumer)`` gives any further refusal."""
    op: Callable
    emits: Callable
    consumes: Callable
    reach: Optional[int]
    equations: Callable
    link: type
    check: Callable = lambda emitter, consumer: None
    passes: Callable = lambda plan: False


_LINK_RULES = (
    _LinkRule(_dl.delta_pair,
              lambda p: p.sources[0].terms == _dl.MMAT,
              lambda p: p.sources[0].terms == _dl.CORR | _dl.GRAD, 1,
              lambda: _DELTA_EQUATIONS, _dl.Link, _delta_dims),
    # EDACScheme with walls: its mean-pressure group (AVGP alone) lies
    # between the density and the momentum group and reads the list too
    _LinkRule(_tp.tvf_pair, lambda p: _tvf_phase(p) == _tp.DENSITY,
              lambda p: _tvf_phase(p) == _tp.MOMENTUM, None,
              _tvf_link_equations, _pl.Link,
              passes=lambda p: _terms_of(p) == _tp.AVGP),
    _LinkRule(_gs.gsph_pair,
              lambda p: _gs.phase_of(_terms_of(p)) == _gs.GRADIENTS,
              lambda p: _gs.phase_of(_terms_of(p)) == _gs.ACCELERATION, None,
              _gsph_link_equations, _pl.Link),
    # CRKSPHScheme's first evaluator: the number density emits, the
    # moments, density and velocity gradient read, the momentum consumes
    _LinkRule(_cp.crksph_pair, lambda p: _terms_of(p) in _cp.EMITTING,
              lambda p: _terms_of(p) in (_cp.MOM, _cp.MOM | _cp.VISC), None,
              _crksph_link_equations, _pl.Link, _crksph_capacity,
              passes=lambda p: _terms_of(p) in (_cp.MOMS, _cp.RHO,
                                                _cp.GRADV)),
)


def _link_refusal(rule, span, emitter, consumers):
    """Why the emitting plan and the ``consumers``, over the groups
    ``span`` (the emitter's to the last consumer's), cannot share a walk,
    or None."""
    names = [ps.name for ps in emitter.sources]
    for consumer in consumers:
        if names != [ps.name for ps in consumer.sources]:
            return 'sources %s and %s' % (
                names, [ps.name for ps in consumer.sources])
    why = rule.check(emitter, consumers[-1])
    if why is not None:
        return why
    return _span_refusal(span, rule.equations())


def _span_refusal(span, allowed):
    """Why the groups ``span`` (the emitter's to the last consumer's) do
    not keep the pairs: an equation not among ``allowed``, or a group
    before the last that re-bins; or None."""
    for group in span:
        for eq in group.equations:
            if type(eq) not in allowed:
                return '%s is not among the equations that keep the ' \
                    'pairs' % eq.name
    if any(group.update_nnps for group in span[:-1]):
        return 'a group between them re-bins (update_nnps)'
    return None


def _subsequence(names, of):
    """Whether ``names`` are among ``of``, in its order."""
    it = iter(of)
    return all(name in it for name in names)


def _link_iisph(groups, plans):
    """The links of ``iisph_pair``'s plans (``link_pairs``): for each
    dest, its first plan of an emitting set (``EMITTING``) whose sources
    include those of every later ``iisph_pair`` plan of the dest, in its
    order, emits, and every later plan reads its list (the last the
    consumer, the others ``Link.middle``), where every equation of the
    groups from the emitter's to the last is IISPH's (none moves ``x y z
    h``).  Each refusal is logged.  Returns the links."""
    from pysph_tpu_torch.sph import iisph
    chains = {}
    for a, group in enumerate(groups):
        for dest in dict.fromkeys(eq.dest for eq in group.equations):
            plan = plans.get((id(group), dest))
            if plan is not None and plan.op is _ip.iisph_pair and \
                    plan.link is None:
                chains.setdefault(dest, []).append((a, plan))
    allowed = {cls for cls in vars(iisph).values()
               if isinstance(cls, type) and issubclass(cls, iisph.Equation)}
    links = []
    for dest, chain in chains.items():
        link, why = None, 'one plan'
        for k, (a, emitter) in enumerate(chain[:-1]):
            names = [ps.name for ps in emitter.sources]
            later = [plan for _, plan in chain[k + 1:]]
            if _ip.phase_of(_terms_of(emitter)) not in _ip.EMITTING:
                why = 'the first plans are of no emitting set'
                continue
            if not all(_subsequence([ps.name for ps in p.sources], names)
                       for p in later):
                why = 'no plan\'s sources include the later plans\''
                continue
            if any(_ip.phase_of(_terms_of(p)) not in _ip.CONSUMING
                   for p in later):
                why = 'a later plan of no consuming set'
                break
            why = _span_refusal(groups[a:chain[-1][0] + 1], allowed)
            if why is not None:
                break
            link = _pl.Link(emitter, later[-1], later[:-1])
            for plan in [emitter] + later:
                plan.link = link
            links.append(link)
            break
        if link is None:
            logger.info('iisph_pair for %s: no link: %s', dest, why)
    return links


def link_pairs(groups, plans):
    """Link the plans of one kernel for one dest that can share a walk
    (``groups``, in order; ``plans``: {(id(group), dest): ``PairPlan``
    or None}): each ``delta_pair`` moment plan (``MMAT``) to the
    corrected gradient plan (``CORR | GRAD``) of the group right after
    it, where the moment is in the kernel's dimensions and the
    correction in no more and every equation of both groups is one of
    the delta planner's (none writes ``x y z h m rho`` or has a
    ``post_loop``); each ``tvf_pair`` density plan to the dest's next
    ``tvf_pair`` plan where that is a momentum plan and every equation
    from the density group to the momentum group is TVF's, the EOS or
    the walls' (``_tvf_link_equations``: none writes ``x y z h``); both
    with the same sources in the same order; each ``gsph_pair``
    gradients plan to the dest's next ``gsph_pair`` plan where that is an
    acceleration plan and every equation from the one group to the other
    is ``GSPHGradients`` or ``GSPHAcceleration`` (``_gsph_link_equations``:
    none writes a prop of the gradients' packed planes); each
    ``crksph_pair`` number density plan to the dest's momentum plan, the
    moments, density and velocity gradient plans between them reading too
    (``Link.middle``), where every equation from the one group to the
    other is CRKSPH's, ``LaminarViscosity`` or its EOS
    (``_crksph_link_equations``: none writes ``x y z h``) and the list has
    a capacity in the kernel's dimensions (2D).  The first call then
    emits the neighbour list and packed copies that the second reads (and
    the ``tvf_pair`` mean-pressure plans of ``AVGP`` alone between them,
    ``EDACScheme``'s with walls: ``Link.middle``) (``ops/pair_link.py``);
    and each dest's chain of ``iisph_pair`` plans (``_link_iisph``).  Each
    refusal is logged.  Returns the ``Link`` of each linked pair or
    chain."""
    links = []
    for a, g0 in enumerate(groups):
        for dest in dict.fromkeys(eq.dest for eq in g0.equations):
            emitter = plans.get((id(g0), dest))
            rule = next((r for r in _LINK_RULES if emitter is not None and
                         emitter.link is None and emitter.op is r.op and
                         r.emits(emitter)), None)
            if rule is None:
                continue
            end = len(groups) if rule.reach is None else \
                min(len(groups), a + 1 + rule.reach)
            consumer, middle = None, []
            for b in range(a + 1, end):
                plan = plans.get((id(groups[b]), dest))
                if plan is None or plan.op is not rule.op:
                    continue
                if rule.passes(plan):
                    middle.append(plan)
                    continue
                consumer = plan
                break
            if consumer is None or not rule.consumes(consumer):
                logger.info('%s for %s: no link: no consuming plan after '
                            'it', rule.op.__name__, dest)
                continue
            why = _link_refusal(rule, groups[a:b + 1], emitter,
                                middle + [consumer])
            if why is not None:
                logger.info('%s for %s: no link: %s', rule.op.__name__,
                            dest, why)
                continue
            link = rule.link(emitter, consumer, middle)
            for plan in [emitter, consumer] + middle:
                plan.link = link
            links.append(link)
    return links + _link_iisph(groups, plans)


class PairPlan(object):
    """The kernel call for one dest over all its sources: ``op`` is the
    kernel's wrapper, ``reference`` its plain version (same arguments;
    with ``takes_dt`` the step's dt is the last, with ``takes_time`` the
    step's t and dt are); ``link``: the ``pair_link.Link`` a linked plan
    runs through."""

    def __init__(self, dest, sources, kernel, op, reference, outputs,
                 takes_dt=False, takes_time=False):
        self.dest = dest
        self.sources = sources
        self.kernel = kernel
        self.op = op
        self.reference = reference
        self.outputs = outputs
        self.takes_dt = takes_dt
        self.takes_time = takes_time
        self.link = None

    def args(self, store, states, cells, grid, write_mask, pre, dt=0.0,
             t=0.0):
        """The arguments of ``op`` for the dest's ``store`` and the
        outputs' values before the phase ``pre``."""
        srcs = [(states[s.name], cells[s.name], s) for s in self.sources]
        args = (store, cells[self.dest], write_mask, pre, srcs, grid,
                self.kernel)
        if self.takes_time:
            return args + (t, dt)
        return args + (dt,) if self.takes_dt else args

    def execute(self, store, states, cells, grid, write_mask, dt=0.0,
                t=0.0):
        pre = {p: store[p] for p in self.outputs}
        args = self.args(store, states, cells, grid, write_mask, pre, dt, t)
        store.update(self.op(*args) if self.link is None
                     else self.link.run(self, args))


def plan_solve(group, plans, kernel):
    """The ``SolvePlan`` of the iterated ``group`` (its sub-groups' plans
    in ``plans``, as ``link_pairs`` linked them), or ``PairIneligible``:
    the group must be ``Group([ComputeDIJPJ(d, [d])], [PressureSolve(d,
    [d])(, PressureSolveBoundary(d, walls))], iterate=True)`` with both
    sub-groups of one write mask, their plans reading the neighbour list
    of the dest's emitting ``iisph_pair`` launch, and the kernel one of
    ``iisph_solve``'s kinds."""
    from pysph_tpu_torch.sph import iisph
    subs = group.equations
    if not group.has_subgroups or len(subs) != 2 or any(
            g.has_subgroups or g.iterate for g in subs):
        raise PairIneligible('not two groups of equations')
    dijpj, solve = subs[0].equations, subs[1].equations
    dest = dijpj[0].dest
    if [type(eq) for eq in dijpj] != [iisph.ComputeDIJPJ] or [
            type(eq) for eq in solve] not in (
                [iisph.PressureSolve],
                [iisph.PressureSolve, iisph.PressureSolveBoundary]) or any(
                    eq.dest != dest for eq in solve):
        raise PairIneligible('not ComputeDIJPJ, then PressureSolve and '
                             'PressureSolveBoundary, of one dest')
    if dijpj[0].sources != [dest] or solve[0].sources != [dest]:
        raise PairIneligible('ComputeDIJPJ or PressureSolve of %s over %s, '
                             '%s' % (dest, dijpj[0].sources,
                                     solve[0].sources))
    if subs[0].real != subs[1].real:
        raise PairIneligible('sub-groups of two write masks')
    if kernel_kind(kernel) not in _is.KINDS:
        raise PairIneligible('kernel %r: iisph_solve holds kinds %s'
                             % (kernel, _is.KINDS))
    first, second = (plans.get((id(g), dest)) for g in subs)
    link = getattr(first, 'link', None)
    if second is None or link is None or second.link is not link or \
            first.op is not _ip.iisph_pair or \
            not {id(first), id(second)} <= set(map(id, link.consumers)):
        raise PairIneligible('the sweeps\' plans read no emitting '
                             'iisph_pair launch\'s list')
    eq = solve[0]
    return SolvePlan(dest, first, second, subs[1], _is.SolveSpec(
        dest, eq.rho0, eq.omega, eq.tolerance, int(group.min_iterations),
        int(group.max_iterations)))


class SolvePlan(object):
    """An iterated group planned onto ``iisph_solve``: ``dijpj`` and
    ``solve`` are its sub-groups' ``iisph_pair`` plans (their sources and
    the link whose hand-off the solve reads), ``group`` the sub-group
    whose write mask the solve takes, ``spec`` the ``SolveSpec``."""

    def __init__(self, dest, dijpj, solve, group, spec):
        self.dest = dest
        self.dijpj = dijpj
        self.solve = solve
        self.group = group
        self.spec = spec

    def args(self, states, cells, grid, dt, active=None, log=None):
        """The arguments of ``iisph_solve`` on the states."""
        store = states[self.dest]
        handoff = self.solve.link.handoff
        if handoff is None:
            raise RuntimeError('iisph_solve: the iterated group of %s runs '
                               'without the hand-off of its emitting '
                               'iisph_pair launch' % self.dest)

        def srcs(plan):
            return [(states[s.name], cells[s.name], s) for s in plan.sources]
        return (store, cells[self.dest], self.group.write_mask(store),
                srcs(self.dijpj), srcs(self.solve), grid, self.dijpj.kernel,
                dt, self.spec, handoff, active, log)

    def execute(self, states, cells, grid, dt, active=None, log=None):
        out, _ = _is.iisph_solve(*self.args(states, cells, grid, dt, active,
                                            log))
        states[self.dest].update(out)


def _sweep_kinds():
    """{equation type: (its pair kernel's wrapper, the sweep op, the
    ``SweepSpec`` of an equation, the list's capacity by dim)} of the
    density iterations that ``plan_sweep`` takes."""
    from pysph_tpu_torch.sph.gas_dynamics import basic, tsph
    return {basic.SummationDensity: (_gd.gasd_pair, _gd.gasd_sweep,
                                     _gd.sweep_spec, _pl.CAPACITY),
            tsph.SummationDensity: (_ts.tsph_pair, _ts.tsph_sweep,
                                    _ts.sweep_spec, _ts.CAPACITY)}


def plan_sweep(group, plans, kernel):
    """The ``SweepPlan`` of the iterated ``group`` (its plan in
    ``plans``), or ``PairIneligible``: the group must be ``Group(
    [SummationDensity(d, sources, density_iterations=True)],
    iterate=True, update_nnps=True)`` of one dest, with ``GasDScheme``'s
    ``SummationDensity`` planned on ``gasd_pair``'s density set or
    ``TSPHScheme``'s on ``tsph_pair``'s."""
    eqs = group.equations
    if group.has_subgroups or not group.update_nnps:
        raise PairIneligible('not a re-binned group of equations')
    kinds = _sweep_kinds()
    if len(eqs) != 1 or type(eqs[0]) not in kinds or \
            not eqs[0].density_iterations:
        raise PairIneligible('not one SummationDensity with '
                             'density_iterations')
    op, sweep, spec, capacity = kinds[type(eqs[0])]
    plan = plans.get((id(group), eqs[0].dest))
    if plan is None or plan.op is not op:
        raise PairIneligible('its pair phase is not on %s' % op.__name__)
    if int(group.max_iterations) < 1:
        raise PairIneligible('max_iterations %r' % group.max_iterations)
    return SweepPlan(plan, group, spec(eqs[0]), sweep,
                     capacity[kernel.dim])


class _SweepReaders(NamedTuple):
    """The plans of a sweep's kernel that read its list: ``passes(plan)``
    a plan between the sweep and the consumer (``Link.middle``),
    ``consumes(plan)`` the last; ``equations()`` those that may lie
    between the sweep and the consumer (none writes x y z h)."""
    passes: Callable
    consumes: Callable
    equations: Callable


def _gasd_sweep_readers():
    from pysph_tpu_torch.sph.gas_dynamics import basic
    return _SweepReaders(
        lambda p: False,
        lambda p: _gd.phase_of(_terms_of(p)) == _gd.MOMENTUM,
        lambda: frozenset((basic.IdealGasEOS, basic.MPMAccelerations)))


def _tsph_sweep_readers():
    from pysph_tpu_torch.sph.gas_dynamics import tsph
    return _SweepReaders(
        lambda p: _terms_of(p) == _ts.GRADV,
        lambda p: _terms_of(p) == _ts.MOM,
        lambda: frozenset((tsph.IdealGasEOS, tsph.VelocityGradDivC1,
                           tsph.BalsaraSwitch, tsph.MomentumAndEnergy)))


#: how each sweep's kernel reads its list, by the kernel's wrapper
_SWEEP_READERS = {_gd.gasd_pair: _gasd_sweep_readers,
                  _ts.tsph_pair: _tsph_sweep_readers}


def link_sweep(sweep, groups, plans):
    """Link ``sweep`` (a ``SweepPlan``) to its dest's later plans of the
    same kernel in ``groups`` (the leaf groups in order) that read its
    last sweep's list: ``gasd_pair``'s momentum plan; ``tsph_pair``'s
    velocity gradient plan (``Link.middle``), then its momentum plan.
    Each must be over the same sources, and every equation of the groups
    from the sweep's to the consumer's must keep the pairs (no re-binning
    before it).  Returns the ``Link``, or None (logged)."""
    op = sweep.plan.op
    readers = _SWEEP_READERS[op]()
    names = [ps.name for ps in sweep.plan.sources]
    a = next(k for k, g in enumerate(groups) if g is sweep.group)
    middle, why = [], None
    for b in range(a + 1, len(groups)):
        plan = plans.get((id(groups[b]), sweep.dest))
        if plan is None or plan.op is not op:
            continue
        if [ps.name for ps in plan.sources] != names:
            why = 'sources %s and %s' % (
                names, [ps.name for ps in plan.sources])
        elif readers.passes(plan):
            middle.append(plan)
            continue
        elif not readers.consumes(plan):
            why = 'the next %s plan reads no list' % op.__name__
        else:
            why = _span_refusal(groups[a + 1:b + 1], readers.equations())
        if why is None:
            link = _SweepLink(sweep, plan, middle)
            sweep.link = link
            for p in middle + [plan]:
                p.link = link
            return link
        break
    else:
        why = 'no consuming plan after it'
    logger.info('%s sweep for %s: no link: %s', op.__name__, sweep.dest,
                why)
    return None


class _SweepLink(_pl.Link):
    """A ``SweepPlan`` and the plans that read its last sweep's list (the
    consumer and ``middle``): the sweep sets ``handoff``
    (``SweepPlan.hand_off``), the consumer takes it; where none did (the
    evaluator's host loop with ``solve_iterated`` off) they walk."""

    def run(self, plan, args):
        handoff = self.handoff
        if plan is self.consumer:
            self.handoff = None
        return plan.op(*args) if handoff is None else \
            plan.op(*args, handoff=handoff)


#: the fewest sweep slots a chunk's evaluation holds
MIN_SLOTS = 2


class SweepPlan(object):
    """An iterated density group planned onto a sweep op (``op``:
    ``gasd_sweep`` or ``tsph_sweep``): ``plan`` is its density plan on the
    sweep's pair kernel (the sources), ``group`` the group, ``spec`` the
    kernel's ``SweepSpec``, ``link`` the ``Link`` to the plans that read
    its list (or None), ``capacity`` its list's entries a dest.
    ``slots``: the sweeps a chunk's evaluation holds (None until the first
    chunk: ``MIN_SLOTS`` or the most that a converged evaluation outside a
    chunk took, ``seen``; doubled where an evaluation of a chunk ran out,
    the solver's redo); ``buffers``: the ``SweepBuffers`` on the card."""

    def __init__(self, plan, group, spec, op, capacity):
        self.plan = plan
        self.dest = plan.dest
        self.group = group
        self.spec = spec
        self.op = op
        self.capacity = capacity
        self.link = None
        self.slots = None
        self.seen = 0
        self.buffers = None
        self.min_iterations = int(group.min_iterations)
        self.max_iterations = int(group.max_iterations)

    def sized(self):
        """The slots, set where not yet."""
        if self.slots is None:
            self.slots = min(max(MIN_SLOTS, self.seen), self.max_iterations)
        return self.slots

    def grow(self):
        """Double the slots (at most ``max_iterations``)."""
        self.slots = min(2 * self.sized(), self.max_iterations)
        return self.slots

    def sweep(self, states, cells, grid, run=None):
        """One gated sweep on the states (in place where ``run`` is
        given); returns the particles not converged after it (a 0-d
        int32 tensor)."""
        store = states[self.dest]
        srcs = [(states[s.name], cells[s.name], s) for s in self.plan.sources]
        x = store['x']
        if x.is_cuda and (self.buffers is None or
                          not self.buffers.fits(store, srcs)):
            self.buffers = _gd.SweepBuffers(store, srcs, self.plan.kernel.dim,
                                            self.capacity)
        out, unconv = self.op(
            store, cells[self.dest], self.group.write_mask(store), srcs, grid,
            self.plan.kernel, self.spec, run, self.buffers)
        store.update(out)
        return unconv

    def hand_off(self, states, use):
        """Leave the last sweep's list for the linked plans, read where
        ``use`` (a 0-d device bool) is set."""
        if self.link is None:
            return
        store = states[self.dest]
        if store['x'].is_cuda:
            self.link.handoff = self.buffers.handoff(use)
        else:
            self.link.handoff = _pl.empty_handoff(
                store, [(states[s.name], None, s) for s in self.plan.sources])
