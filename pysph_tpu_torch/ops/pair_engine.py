"""Planning: which pair phases a hand-written pair kernel runs.

Four kernels take a dest's pair phases, all its sources in one call:

- ``wcsph_pair`` (``ops/wcsph_pair.py``, the dam_break_3d main path and
  the elliptical drop): every equation with sources is
  ``ContinuityEquation``, ``MomentumEquation`` (non-tensile),
  ``XSPHCorrection``, ``ContinuityEquationDeltaSPH`` or
  ``MomentumEquationDeltaSPH``, with the ``WendlandQuintic``,
  ``CubicSpline`` or ``Gaussian`` kernel;
- ``dense_pair`` (``ops/dense_pair.py``): the same phase sets but for the
  two delta-SPH terms, walked one thread block per dest cell;
- ``delta_pair`` (``ops/delta_pair.py``, the delta-SPH pre-phases): every
  source takes ``GradientCorrectionPreStep`` alone, or
  ``GradientCorrection`` then ``ContinuityEquationDeltaSPHPreStep``, or
  the latter alone, the same for every source, with the kernels of
  ``wcsph_pair``.  ``GradientCorrection`` rewrites ``DWIJ`` for the
  equation after it: a symbol, which the rule below does not see, so
  ``delta_pair``'s planner accepts exactly that ordered pair;
- ``gtvf_pair`` (``ops/gtvf_pair.py``, the GTVF dam break): the
  equations fall in one of its five phase sets (``SetWallVelocity``;
  ``ContinuityEquationGTVF`` + ``ContinuitySolid``; ``CorrectDensity``;
  ``VolumeSummation`` + ``SolidWallPressureBC``;
  ``MomentumEquationPressureGradient`` +
  ``MomentumEquationArtificialStress``), with ``WendlandQuintic``;
- ``tvf_pair`` (``ops/tvf_pair.py``, the Taylor-Green vortex's TVF
  groups): the equations of a dest fall in one of its two phase sets
  (``SummationDensity``; the TVF ``MomentumEquationPressureGradient``,
  ``MomentumEquationViscosity``, ``MomentumEquationArtificialStress``
  and ``MomentumEquationArtificialViscosity``), with any kernel of
  ``KERNEL_KIND``.  It is the one kernel with a periodic walk: on a
  periodic grid the other planners refuse.

For each, each equation appears at most once per source, with at most
``MAX_SOURCES`` sources, and no equation reads a property that another
one accumulates (the kernels give every read the value from before the
phase).  The per-source term masks say which equations each source
takes.  Anything else raises ``PairIneligible`` and the evaluator runs
the torch pair engine instead.

``link_delta`` links a dest's ``delta_pair`` moment plan to its
corrected gradient plan in the group right after it where nothing
between them moves the pairs: the moment call then hands its neighbour
list and packed copies to the gradient call (``PairPlan.link``,
``ops/delta_pair.py``), which walks no candidates.

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
from typing import NamedTuple

from pysph_tpu_torch.base.kernels import (
    KERNEL_KIND, WCSPH_KINDS, WendlandQuintic)
from pysph_tpu_torch.ops import delta_pair as _dl
from pysph_tpu_torch.ops import dense_pair as _dp
from pysph_tpu_torch.ops import gtvf_pair as _gp
from pysph_tpu_torch.ops import tvf_pair as _tp
from pysph_tpu_torch.ops import wcsph_pair as _wp
from pysph_tpu_torch.sph.basic_equations import (
    ContinuityEquation, XSPHCorrection)
from pysph_tpu_torch.sph.equation import _method_args
from pysph_tpu_torch.sph.wc.basic import (
    ContinuityEquationDeltaSPH, ContinuityEquationDeltaSPHPreStep,
    MomentumEquation, MomentumEquationDeltaSPH)
from pysph_tpu_torch.sph.wc.kernel_correction import (
    GradientCorrection, GradientCorrectionPreStep)

_DENSE_TERMS = {ContinuityEquation: _wp.CONT, MomentumEquation: _wp.MOM,
                XSPHCorrection: _wp.XSPH}
_WCSPH_TERMS = {**_DENSE_TERMS, ContinuityEquationDeltaSPH: _wp.DCONT,
                MomentumEquationDeltaSPH: _wp.DMOM}
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
              'WIJ': ('x', 'y', 'z', 'h'), 'DWIJ': ('x', 'y', 'z', 'h')}


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


def _gtvf_terms():
    # imported here: sph/wc/gtvf.py imports the integrator, which
    # imports the evaluator, which imports this module
    from pysph_tpu_torch.sph.wc.gtvf import (
        ContinuityEquationGTVF, CorrectDensity,
        MomentumEquationArtificialStress, MomentumEquationPressureGradient)
    from pysph_tpu_torch.sph.wc.transport_velocity import (
        ContinuitySolid, SetWallVelocity, SolidWallPressureBC,
        VolumeSummation)
    return {SetWallVelocity: _gp.SWV, ContinuityEquationGTVF: _gp.CGTVF,
            ContinuitySolid: _gp.CSOLID, CorrectDensity: _gp.CDENS,
            VolumeSummation: _gp.VSUM, SolidWallPressureBC: _gp.WALLP,
            MomentumEquationPressureGradient: _gp.MPG,
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
            if terms & term:
                raise PairIneligible('%s twice for source %s'
                                     % (eq.name, src))
            terms |= term
            own = set(term_outputs[term])
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
        SummationDensity)
    return {SummationDensity: _tp.SDEN,
            MomentumEquationPressureGradient: _tp.MPG,
            MomentumEquationViscosity: _tp.VISC,
            MomentumEquationArtificialStress: _tp.MAS,
            MomentumEquationArtificialViscosity: _tp.AVIS}


def _plan_wcsph(dest, sources, kernel, op=_wp.wcsph_pair,
                term_of=_WCSPH_TERMS):
    if KERNEL_KIND.get(type(kernel)) not in WCSPH_KINDS:
        raise PairIneligible('kernel %r' % kernel)
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
        plan_sources.append(PairSource(src, t, **params))
        terms |= t
    return PairPlan(dest, plan_sources, kernel, op,
                    _wp.wcsph_pair_reference, _wp.outputs_for(terms))


def _plan_dense(dest, sources, kernel):
    return _plan_wcsph(dest, sources, kernel, op=_dp.dense_pair,
                       term_of=_DENSE_TERMS)


def _plan_delta(dest, sources, kernel):
    if KERNEL_KIND.get(type(kernel)) not in WCSPH_KINDS:
        raise PairIneligible('kernel %r' % kernel)
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
    if type(kernel) is not WendlandQuintic:
        raise PairIneligible('kernel %r' % kernel)
    term_of = _gtvf_terms()
    plan_sources = []
    terms = 0
    for src, t, eqs in _source_terms(sources, term_of, _gp.TERM_OUTPUTS,
                                     _gp.MAX_SOURCES):
        gravity = next(((eq.gx, eq.gy, eq.gz) for eq in eqs
                        if term_of[type(eq)] == _gp.WALLP),
                       (0.0, 0.0, 0.0))
        plan_sources.append(_gp.GtvfSource(src, t, tuple(eqs), gravity))
        terms |= t
    if _gp.phase_of(terms) is None:
        raise PairIneligible('GTVF terms %#x span two phase sets' % terms)
    return PairPlan(dest, plan_sources, kernel, _gp.gtvf_pair,
                    _gp.gtvf_pair_reference, _gp.outputs_for(terms))


def _plan_tvf(dest, sources, kernel):
    if type(kernel) not in KERNEL_KIND:
        raise PairIneligible('kernel %r' % kernel)
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
        plan_sources.append(_tp.TvfSource(src, t, tuple(eqs), **params))
        terms |= t
    if _tp.phase_of(terms) is None:
        raise PairIneligible('TVF terms %#x span two phase sets' % terms)
    return PairPlan(dest, plan_sources, kernel, _tp.tvf_pair,
                    _tp.tvf_pair_reference, _tp.outputs_for(terms))


_PLANNERS = {'kernel': (_plan_wcsph, _plan_gtvf, _plan_delta, _plan_tvf),
             'dense': (_plan_dense,)}
#: the planners whose kernels walk a periodic grid
_PERIODIC = (_plan_tvf,)


def plan_pair_phases(dest, sources, kernel, engine='kernel',
                     periodic=False):
    """``sources``: ordered {src name: [equations]}.  Returns the
    ``PairPlan`` of the first of the ``engine``'s kernels that takes
    them (on a ``periodic`` grid, of those with a periodic walk), or
    raises ``PairIneligible`` with each kernel's reason."""
    reasons = []
    for planner in _PLANNERS[engine]:
        if periodic and planner not in _PERIODIC:
            reasons.append('%s: no periodic walk (ROADMAP Queue 1 item 34)'
                           % planner.__name__[6:])
            continue
        try:
            return planner(dest, sources, kernel)
        except PairIneligible as e:
            reasons.append('%s: %s' % (planner.__name__[6:], e))
    raise PairIneligible('; '.join(reasons))


#: the equations of the delta planner's sets: none writes x y z h m rho
#: or has a post_loop, so a linked pair's two calls see the same pairs
#: in support and the same packed records
_DELTA_EQUATIONS = frozenset(t for eqs in _DELTA_SETS for t in eqs)


def _link_refusal(moment_group, gradient_group, moment, gradient):
    """Why the moment plan and the gradient plan of the group after it
    cannot share a walk, or None."""
    names = [ps.name for ps in moment.sources]
    if names != [ps.name for ps in gradient.sources]:
        return 'sources %s and %s' % (
            names, [ps.name for ps in gradient.sources])
    mdim, cdim = moment.sources[0].dim, gradient.sources[0].dim
    if mdim != moment.kernel.dim or cdim > mdim:
        return 'the moment in %d dimensions, the correction in %d' % (
            mdim, cdim)
    for group in (moment_group, gradient_group):
        for eq in group.equations:
            if type(eq) not in _DELTA_EQUATIONS:
                return '%s is no delta-SPH pre-phase equation' % eq.name
    return None


def link_delta(groups, plans):
    """Link each ``delta_pair`` moment plan (``MMAT``) to the corrected
    gradient plan (``CORR | GRAD``) of the same dest in the group right
    after it (``groups``, in order; ``plans``: {(id(group), dest):
    ``PairPlan`` or None}), where both have the same sources, the moment
    is in the kernel's dimensions and the correction in no more, and
    every equation of both groups is one of the delta planner's (none
    writes ``x y z h m rho`` or has a ``post_loop``): the moment call
    then emits the neighbour list and packed copies that the gradient
    call reads (``ops/delta_pair.py``).  Returns the ``Link`` of each
    linked pair."""
    links = []
    for g0, g1 in zip(groups, groups[1:]):
        for dest in dict.fromkeys(eq.dest for eq in g1.equations):
            moment = plans.get((id(g0), dest))
            gradient = plans.get((id(g1), dest))
            if moment is None or gradient is None or \
                    moment.op is not _dl.delta_pair or \
                    gradient.op is not _dl.delta_pair or \
                    moment.sources[0].terms != _dl.MMAT or \
                    gradient.sources[0].terms != _dl.CORR | _dl.GRAD:
                continue
            why = _link_refusal(g0, g1, moment, gradient)
            if why is not None:
                logger.info('delta_pair for %s: no link: %s', dest, why)
                continue
            moment.link = gradient.link = _dl.Link(moment, gradient)
            links.append(moment.link)
    return links


class PairPlan(object):
    """The kernel call for one dest over all its sources: ``op`` is the
    kernel's wrapper, ``reference`` its plain version (same arguments);
    ``link``: the ``delta_pair.Link`` a linked plan runs through."""

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
