"""Planning: which pair phases the hand-written pair kernel runs.

A dest's pair phases match the kernel (``ops/wcsph_pair.py``) when

- every equation with sources is exactly ``ContinuityEquation``,
  ``MomentumEquation`` (non-tensile) or ``XSPHCorrection``, each at most
  once per source, with at most ``MAX_SOURCES`` sources;
- the smoothing kernel is ``WendlandQuintic`` or ``CubicSpline``;
- no equation reads a property that another one accumulates (the kernel
  gives every read the value from before the phase).

Periodic domains never reach here: the evaluator refuses them.
Anything else raises ``PairIneligible`` and the evaluator runs the
torch pair engine instead.
"""

from typing import NamedTuple

from pysph_tpu_torch.base.kernels import KERNEL_KIND
from pysph_tpu_torch.ops import wcsph_pair as _wp
from pysph_tpu_torch.sph.basic_equations import (
    ContinuityEquation, XSPHCorrection)
from pysph_tpu_torch.sph.equation import _method_args
from pysph_tpu_torch.sph.wc.basic import MomentumEquation

_TERM_OF = {ContinuityEquation: _wp.CONT, MomentumEquation: _wp.MOM,
            XSPHCorrection: _wp.XSPH}

# pair symbols -> the props they read on both sides
_SYM_READS = {'HIJ': ('h',), 'EPS': ('h',), 'RHOIJ': ('rho',),
              'RHOIJ1': ('rho',), 'XIJ': ('x', 'y', 'z'),
              'VIJ': ('u', 'v', 'w'), 'R2IJ': ('x', 'y', 'z'),
              'RINV': ('x', 'y', 'z'), 'RIJ': ('x', 'y', 'z'),
              'WIJ': ('x', 'y', 'z', 'h'), 'DWIJ': ('x', 'y', 'z', 'h')}


class PairIneligible(Exception):
    """The pair phases of a dest do not match the kernel's set."""


class PairSource(NamedTuple):
    """One source of a dest's fused pair phases and its term mask."""
    name: str
    terms: int
    c0: float = 0.0
    alpha: float = 0.0
    beta: float = 0.0
    eps: float = 0.0


def _reads(eq):
    props = set()
    for arg in _method_args(eq.loop):
        if arg[:2] in ('d_', 's_'):
            props.add(arg[2:])
        props.update(_SYM_READS.get(arg, ()))
    return props


def plan_pair_phases(dest, sources, kernel):
    """``sources``: ordered {src name: [equations]}.  Returns a
    ``PairPlan`` or raises ``PairIneligible``."""
    if type(kernel) not in KERNEL_KIND:
        raise PairIneligible('kernel %r' % kernel)
    if len(sources) > _wp.MAX_SOURCES:
        raise PairIneligible('%d sources (at most %d)'
                             % (len(sources), _wp.MAX_SOURCES))
    plan_sources = []
    writes, reads = {}, set()
    for src, eqs in sources.items():
        params = {}
        terms = 0
        for eq in eqs:
            term = _TERM_OF.get(type(eq))
            if term is None:
                raise PairIneligible('equation %s' % eq.name)
            if terms & term:
                raise PairIneligible('%s twice for source %s'
                                     % (eq.name, src))
            if term == _wp.MOM:
                params.update(c0=eq.c0, alpha=eq.alpha, beta=eq.beta)
            elif term == _wp.XSPH:
                params['eps'] = eq.eps
            terms |= term
            own = set(_wp.TERM_OUTPUTS[term])
            for p in own:
                writes.setdefault(p, set()).add(type(eq))
            reads |= {(p, type(eq)) for p in _reads(eq) - own}
        plan_sources.append(PairSource(src, terms, **params))
    for prop, cls in reads:
        if writes.get(prop, set()) - {cls}:
            raise PairIneligible('%s reads %r, which another equation '
                                 'accumulates' % (cls.__name__, prop))
    return PairPlan(dest, plan_sources, kernel)


class PairPlan(object):
    """The kernel call for one dest over all its sources."""

    def __init__(self, dest, sources, kernel):
        self.dest = dest
        self.sources = sources
        self.kernel = kernel
        terms = 0
        for s in sources:
            terms |= s.terms
        self.outputs = _wp.outputs_for(terms)

    def execute(self, store, states, cells, grid, write_mask):
        pre = {p: store[p] for p in self.outputs}
        srcs = [(states[s.name], cells[s.name], s) for s in self.sources]
        store.update(_wp.wcsph_pair(store, cells[self.dest], write_mask,
                                    pre, srcs, grid, self.kernel))
