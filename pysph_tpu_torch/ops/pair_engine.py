"""Planning: which pair phases a hand-written pair kernel runs.

Four kernels take a dest's pair phases, all its sources in one call:

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
  Taylor-Green vortex's ``--scheme gtvf``): the equations fall in one of
  its five phase sets (``SetWallVelocity``; ``ContinuityEquationGTVF`` +
  ``ContinuitySolid``; ``CorrectDensity``; ``VolumeSummation`` +
  ``SolidWallPressureBC``; ``MomentumEquationPressureGradient`` +
  ``MomentumEquationViscosity`` + ``MomentumEquationArtificialStress``);
- ``tvf_pair`` (``ops/tvf_pair.py``, ``TVFScheme``'s groups: the
  Taylor-Green vortex and the wall examples): the equations of a dest
  fall in one of its two phase sets (``SummationDensity``; the TVF
  ``MomentumEquationPressureGradient``, ``MomentumEquationViscosity``,
  ``MomentumEquationArtificialStress``,
  ``MomentumEquationArtificialViscosity`` and ``SolidWallNoSlipBC``).

Every kernel takes every kernel with a ``kernel_kind`` (not the ``_1D``
ones: ROADMAP Queue 1 item 28), and every kernel walks a periodic grid
(the wrapped stencil, the minimum image).

For each, each equation appears at most once per source, with at most
``MAX_SOURCES`` sources, and no equation reads a property that another
one accumulates (the kernels give every read the value from before the
phase).  The per-source term masks say which equations each source
takes.  Anything else raises ``PairIneligible`` and the evaluator runs
the torch pair engine instead.

``link_pairs`` links two plans of one kernel for one dest where nothing
between them moves the pairs: a dest's ``delta_pair`` moment plan and
its corrected gradient plan in the group right after it, and a dest's
``tvf_pair`` density plan and its momentum plan in a later group.  The
first call then hands its neighbour list and packed copies to the
second (``PairPlan.link``, ``ops/pair_link.py``), which walks no
candidates.

The engine (``config.py``) picks the kernels: ``kernel`` plans the WCSPH
sets onto ``wcsph_pair``, the GTVF sets onto ``gtvf_pair`` and the
delta-SPH pre-phases onto ``delta_pair``; ``dense`` plans the WCSPH sets
without delta-SPH terms onto ``dense_pair`` and nothing else, as the JAX
package's dense-slot engine refuses sequential and strided phases
(``pallas_engine.py:855-861``): the GTVF sets, the delta-SPH pre-phases
(their outputs ``m_mat`` and ``gradrho`` are strided) and the delta-SPH
main group (it reads the strided ``gradrho``) run on the torch engine.
"""

import logging
from typing import Callable, NamedTuple, Optional

from pysph_tpu_torch.base.kernels import kernel_kind
from pysph_tpu_torch.ops import delta_pair as _dl
from pysph_tpu_torch.ops import dense_pair as _dp
from pysph_tpu_torch.ops import gtvf_pair as _gp
from pysph_tpu_torch.ops import pair_link as _pl
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
            MomentumEquationArtificialStress: _gp.MAS}


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
            SolidWallNoSlipBC: _tp.NOSLIP}


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
                        if term_of[type(eq)] == _gp.WALLP),
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
            if term_of[type(eq)] == _tp.MPG:
                params['pb'] = eq.pb
            elif term_of[type(eq)] == _tp.VISC:
                params['nu'] = eq.nu
            elif term_of[type(eq)] == _tp.AVIS:
                params.update(alpha=eq.alpha, c0=eq.c0)
            elif term_of[type(eq)] == _tp.NOSLIP:
                params['noslip_nu'] = eq.nu
        plan_sources.append(_tp.TvfSource(src, t, tuple(eqs), **params))
        terms |= t
    if _tp.phase_of(terms) is None:
        raise PairIneligible('TVF terms %#x span two phase sets' % terms)
    return PairPlan(dest, plan_sources, kernel, _tp.tvf_pair,
                    _tp.tvf_pair_reference, _tp.outputs_for(terms))


_PLANNERS = {'kernel': (_plan_wcsph, _plan_gtvf, _plan_delta, _plan_tvf),
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
    call and its momentum call, those calls' own included: TVF's pair
    equations, the EOS and the walls' velocity and pressure
    (``TVFScheme``'s groups).  None writes x y z h, so both calls see
    the same pairs in support; the momentum call packs the other props
    afresh."""
    # imported here, as _gtvf_terms
    from pysph_tpu_torch.sph.wc.transport_velocity import (
        SetWallVelocity, SolidWallPressureBC, StateEquation)
    return frozenset(_tvf_terms()) | {StateEquation, SetWallVelocity,
                                      SolidWallPressureBC}


def _delta_dims(moment, gradient):
    mdim, cdim = moment.sources[0].dim, gradient.sources[0].dim
    if mdim != moment.kernel.dim or cdim > mdim:
        return 'the moment in %d dimensions, the correction in %d' % (
            mdim, cdim)
    return None


def _tvf_phase(plan):
    terms = 0
    for ts in plan.sources:
        terms |= ts.terms
    return _tp.phase_of(terms)


class _LinkRule(NamedTuple):
    """How one kernel's plans link: ``emits(plan)`` and
    ``consumes(plan)`` pick the two calls; the consumer is the kernel's
    next plan for the dest within ``reach`` groups after the emitter's
    (None: any later group); every equation of the groups from the
    emitter's to the consumer's must be one of ``equations()``, and
    ``check(emitter, consumer)`` gives any further refusal."""
    op: Callable
    emits: Callable
    consumes: Callable
    reach: Optional[int]
    equations: Callable
    link: type
    check: Callable = lambda emitter, consumer: None


_LINK_RULES = (
    _LinkRule(_dl.delta_pair,
              lambda p: p.sources[0].terms == _dl.MMAT,
              lambda p: p.sources[0].terms == _dl.CORR | _dl.GRAD, 1,
              lambda: _DELTA_EQUATIONS, _dl.Link, _delta_dims),
    _LinkRule(_tp.tvf_pair, lambda p: _tvf_phase(p) == _tp.DENSITY,
              lambda p: _tvf_phase(p) == _tp.MOMENTUM, None,
              _tvf_link_equations, _pl.Link),
)


def _link_refusal(rule, span, emitter, consumer):
    """Why the emitting and the consuming plan, over the groups ``span``
    (the emitter's to the consumer's), cannot share a walk, or None."""
    names = [ps.name for ps in emitter.sources]
    if names != [ps.name for ps in consumer.sources]:
        return 'sources %s and %s' % (
            names, [ps.name for ps in consumer.sources])
    why = rule.check(emitter, consumer)
    if why is not None:
        return why
    allowed = rule.equations()
    for group in span:
        for eq in group.equations:
            if type(eq) not in allowed:
                return '%s is not among the equations that keep the ' \
                    'pairs' % eq.name
    return None


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
    with the same sources in the same order.  The first call then emits
    the neighbour list and packed copies that the second reads
    (``ops/pair_link.py``); each refusal is logged.  Returns the
    ``Link`` of each linked pair."""
    links = []
    for a, g0 in enumerate(groups):
        for dest in dict.fromkeys(eq.dest for eq in g0.equations):
            emitter = plans.get((id(g0), dest))
            rule = next((r for r in _LINK_RULES if emitter is not None and
                         emitter.op is r.op and r.emits(emitter)), None)
            if rule is None:
                continue
            end = len(groups) if rule.reach is None else \
                min(len(groups), a + 1 + rule.reach)
            consumer = None
            for b in range(a + 1, end):
                consumer = plans.get((id(groups[b]), dest))
                if consumer is not None and consumer.op is rule.op:
                    break
                consumer = None
            if consumer is None or not rule.consumes(consumer):
                logger.info('%s for %s: no link: no consuming plan after '
                            'it', rule.op.__name__, dest)
                continue
            why = _link_refusal(rule, groups[a:b + 1], emitter, consumer)
            if why is not None:
                logger.info('%s for %s: no link: %s', rule.op.__name__,
                            dest, why)
                continue
            emitter.link = consumer.link = rule.link(emitter, consumer)
            links.append(emitter.link)
    return links


class PairPlan(object):
    """The kernel call for one dest over all its sources: ``op`` is the
    kernel's wrapper, ``reference`` its plain version (same arguments);
    ``link``: the ``pair_link.Link`` a linked plan runs through."""

    def __init__(self, dest, sources, kernel, op, reference, outputs):
        self.dest = dest
        self.sources = sources
        self.kernel = kernel
        self.op = op
        self.reference = reference
        self.outputs = outputs
        self.link = None

    def execute(self, store, states, cells, grid, write_mask):
        pre = {p: store[p] for p in self.outputs}
        srcs = [(states[s.name], cells[s.name], s) for s in self.sources]
        args = (store, cells[self.dest], write_mask, pre, srcs, grid,
                self.kernel)
        store.update(self.op(*args) if self.link is None
                     else self.link.run(self, args))
