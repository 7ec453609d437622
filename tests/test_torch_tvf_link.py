"""The linked ``tvf_pair`` pair on the CPU: the density call emits its
neighbour list, the momentum call of a later group reads it
(``ops/pair_engine.py::link_pairs``, ``ops/pair_link.py``).

- The linker links the Taylor-Green vortex's density and momentum plans
  and the two-source TVF channel's with ``nu = 0``; it refuses with
  ``nu > 0`` (the no-slip wall sends the momentum group to the torch
  engine), when an equation between the groups writes ``x``, and when
  the two plans' sources differ.
- ``pair_link.neighbours_reference`` on the periodic grid, with a tenth
  of the particles on the box's edges and corners and on grids of 2, 3
  and 4 cells an axis, is the walk order of ``cell_walk.periodic_spans``
  (the kernels' ``walk_rows_periodic``).
- On CPU tensors both calls run the plain version: an emitting call
  returns an empty hand-off, the linked pair equals the walking one, and
  a consuming call without its hand-off, a density call given one, a
  momentum call that emits and a hand-off of other sources raise.
- The linked evaluator against pysph_tpu in float64 for one eval at
  1e-10 of max|ref|: the channel and the Taylor-Green vortex.
- ``roofline.tvf_work`` of a consuming call counts its pairs and no
  candidates.
"""

import numpy as np
import pytest
import torch

from pysph_tpu.base.domain import DomainManager as JaxDomain
from pysph_tpu.base.kernels import QuinticSpline as JaxQuintic
from pysph_tpu.sph import scheme as jax_scheme
from pysph_tpu.tools.sph_evaluator import SPHEvaluator as JaxEvaluator
from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.kernels import QuinticSpline
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.examples.taylor_green import TaylorGreen
from pysph_tpu_torch.ops import cell_walk, pair_link
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.ops.pair_engine import link_pairs, plan_pair_phases
from pysph_tpu_torch.sph import scheme
from pysph_tpu_torch.sph.equation import Equation, Group
from pysph_tpu_torch.sph.wc import transport_velocity as tv
from pysph_tpu_torch.tools.sph_evaluator import SPHEvaluator
from pysph_tpu_torch.tools_dev import roofline, tvf_check
from pysph_tpu_torch.tools_dev.common import linked_calls
from pysph_tpu_torch.tools_dev.time_walks import plan_calls
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401
from test_torch_taylor_green import _check_eval, _jax_eval, _port_eval
from test_torch_tvf import P0, SCHEME_PROPS, _channel, _scaled_err

TOL = 1e-10


def _linked(plans):
    """[(dest, density plan, momentum plan)] of the links among
    ``plans``."""
    return [(p.dest, p, p.link.consumer) for p in plans
            if p is not None and p.link is not None and p is p.link.emitter]


def _tg_app(nx=16):
    app = TaylorGreen()
    app.setup(['--use-double', '--device', 'cpu', '--nx', str(nx),
               '--disable-output', '-q'])
    return app


def test_link_forms_on_taylor_green():
    """The fluid's density plan and its momentum plan, two groups later
    (the EOS between), share a link, and no other plan has one."""
    a_eval = _tg_app().solver.acceleration_evals[0]
    plans = list(a_eval._plans.values())
    (dest, density, momentum), = _linked(plans)
    assert dest == 'fluid' and density.link is momentum.link
    assert isinstance(density.link, pair_link.Link)
    assert (density.op, momentum.op) == (tp.tvf_pair, tp.tvf_pair)
    assert density.outputs == ('V', 'rho')
    assert momentum.outputs == ('au', 'av', 'aw', 'auhat', 'avhat', 'awhat')
    assert [p for p in plans if p is not None and p.link is not None] == \
        [density, momentum]


def _channel_eval(nu, jax=False):
    """One eval of ``TVFScheme`` on the channel of ``test_torch_tvf.py``
    (fluid and wall, periodic in x, gravity) with viscosity ``nu``, in
    the port on the kernel engine (or in pysph_tpu with ``jax``)."""
    kw = dict(dim=2, rho0=1.0, c0=10.0, nu=nu, p0=P0, pb=P0, h0=0.12,
              gy=-1.0, alpha=0.1, tdamp=0.5)
    dom = dict(xmin=0.0, xmax=1.0, periodic_in_x=True)
    if jax:
        from pysph_tpu.base.utils import (
            get_particle_array_tvf_fluid as jf,
            get_particle_array_tvf_solid as js)
        arrays = _channel(jf, js)
        sch = jax_scheme.TVFScheme(['fluid'], ['solid'], **kw)
        sch.setup_properties(arrays, clean=False)
        ev = JaxEvaluator(arrays, sch.get_equations(), dim=2,
                          kernel=JaxQuintic(dim=2),
                          domain_manager=JaxDomain(**dom))
    else:
        from pysph_tpu_torch.base.utils import (
            get_particle_array_tvf_fluid, get_particle_array_tvf_solid)
        arrays = _channel(get_particle_array_tvf_fluid,
                          get_particle_array_tvf_solid)
        sch = scheme.TVFScheme(['fluid'], ['solid'], **kw)
        sch.setup_properties(arrays, clean=False)
        ev = SPHEvaluator(arrays, sch.get_equations(), dim=2,
                          kernel=QuinticSpline(dim=2),
                          domain_manager=DomainManager(**dom),
                          config=Config(engine='kernel', device='cpu',
                                        dtype=torch.float64))
    ev.evaluate(t=0.2, dt=1e-4)
    return arrays, ev


def test_channel_links_two_sources_and_matches_jax():
    """``nu = 0``: the fluid's density and momentum plans over fluid and
    wall are linked, and the linked eval equals pysph_tpu's at 1e-10 of
    max|ref|; ``nu > 0``: the momentum group holds the no-slip wall,
    runs on the torch engine and nothing links."""
    arrays, ev = _channel_eval(0.0)
    (dest, density, momentum), = _linked(ev.func_eval._plans.values())
    assert dest == 'fluid'
    assert [s.name for s in density.sources] == \
        [s.name for s in momentum.sources] == ['fluid', 'solid']
    jmap = {pa.name: pa for pa in _channel_eval(0.0, jax=True)[0]}
    for pa in arrays:
        for p in SCHEME_PROPS[pa.name]:
            want = np.asarray(getattr(jmap[pa.name], p))
            err = _scaled_err(getattr(pa, p), want)
            assert err <= TOL, '%s.%s: %.3g' % (pa.name, p, err)
    _, ev = _channel_eval(0.01)
    assert _linked(ev.func_eval._plans.values()) == []


class _Shift(Equation):
    def initialize(self, d_idx, d_x):
        d_x[d_idx] += 0.0


def _link_case(between=(), momentum_sources=('f',)):
    """The plans of a density group and a momentum group of dest ``f``
    with the groups ``between`` (lists of equations) between them, and
    the links ``link_pairs`` makes of them."""
    kernel = QuinticSpline(dim=2)
    density = Group([tv.SummationDensity('f', ['f'])], real=False)
    srcs = list(momentum_sources)
    momentum = Group([tv.MomentumEquationPressureGradient('f', srcs, pb=P0),
                      tv.MomentumEquationArtificialStress('f', srcs)])
    groups = [density] + [Group(eqs, real=False) for eqs in between] + [
        momentum]
    plans = {(id(density), 'f'): plan_pair_phases(
        'f', {'f': list(density.equations)}, kernel),
        (id(momentum), 'f'): plan_pair_phases(
            'f', {s: list(momentum.equations) for s in srcs}, kernel)}
    return plans, link_pairs(groups, plans)


def test_link_forms_only_where_nothing_moves_between():
    eos = [tv.StateEquation('f', None, p0=P0, rho0=1.0)]
    plans, links = _link_case(between=[eos])
    (link,) = links
    assert [p.link for p in plans.values()] == [link, link]
    assert link.emitter.outputs == ('V', 'rho')
    assert len(_link_case()[1]) == 1
    assert _link_case(between=[eos, [_Shift('f', None)]])[1] == []
    assert _link_case(between=[[_Shift('g', None)]])[1] == []
    assert _link_case(momentum_sources=('f', 'g'))[1] == []


def _walk_order(dest, dcells, sources, spans, grid, p):
    """The in-support source positions of the dest at sorted position
    ``p`` in the order of ``walk_rows_periodic``: the sources in order,
    each's rows and ranges of ``periodic_spans`` (``spans``, by
    source), positions ascending, numbered after the sources before
    it."""
    i = int(dcells.order[p])
    rs = grid.radius_scale
    want, base = [], 0
    for (src, cells, _), rows in zip(sources, spans):
        order = cells.order.long()
        for row in rows[p]:
            for k0, k1 in row:
                j = order[k0:k1]
                d = [grid.image(a, dest[c][i] - src[c][j])
                     for a, c in enumerate('xyz')]
                r2 = d[0] ** 2 + d[1] ** 2 + d[2] ** 2
                sup = torch.maximum(rs * dest['h'][i], rs * src['h'][j])
                want += (base + torch.arange(k0, k1)[r2 < sup * sup]
                         ).tolist()
        base += src['x'].shape[0]
    return want


@pytest.mark.parametrize('nx', [8, 10, 16])
def test_neighbours_reference_is_the_periodic_walk_order(nx):
    """On the Taylor-Green vortex's periodic grid (2 x 2 cells at nx=8,
    3 x 3 at 10, 4 x 4 at 16), with a tenth of the particles on the
    box's edges and corners: each dest's positions in
    ``neighbours_reference`` are those of the periodic walk, in its
    order, and the counts are the exact lists'."""
    s = _tg_app(nx).solver
    tvf_check.on_edges(s.states, s.domain)
    (_, _, _, args), _ = linked_calls(plan_calls(s, [0]))[0]
    dest, dcells, _, _, sources, grid, _ = args
    assert grid.is_periodic and grid.dims[:2] == {8: (2, 2), 10: (3, 3),
                                                  16: (4, 4)}[nx]
    count, positions = pair_link.neighbours_reference(dest, dcells, sources,
                                                      grid)
    n = dest['x'].shape[0]
    i, _ = grid.neighbor_pairs(dest, dcells, sources[0][0], sources[0][1],
                               (0, n))
    assert int(count.sum()) == i.numel() == positions.numel()
    offsets = (torch.cumsum(count.long(), 0) - count.long()).tolist()
    spans = [cell_walk.periodic_spans(grid, dcells, cells).tolist()
             for _, cells, _ in sources]
    for p in range(n):
        got = positions[offsets[p]:offsets[p] + int(count[p])].tolist()
        assert got == _walk_order(dest, dcells, sources, spans, grid, p), p


def _tg_calls():
    s = _tg_app().solver
    tvf_check.perturb(s.states)
    return linked_calls(plan_calls(s, [0]))[0]


def test_plain_handoff_and_its_misuse_raise():
    """On the CPU the linked pair runs the plain versions: the density
    call's hand-off is empty (the plain momentum call walks), the linked
    momentum equals the walking one, and a momentum call without its
    hand-off, a density call given one, an emitting momentum call, a
    hand-off of other sources and the card's check of CPU calls
    raise."""
    (_, _, density, dargs), (_, _, momentum, margs) = _tg_calls()
    link = density.link
    with pytest.raises(ValueError, match='off the card'):
        tvf_check.check_linked([(0, 'fluid', density, dargs),
                                (0, 'fluid', momentum, margs)], 'cpu', TOL)
    with pytest.raises(RuntimeError, match='hand-off'):
        link.run(momentum, margs)
    _, handoff = tp.tvf_pair(*dargs, emit=True)
    assert handoff.buf.numel() == handoff.nbr.numel() == 0
    assert handoff.count is None
    assert handoff.sources == (('fluid', dargs[0]['x'].shape[0]),)
    with pytest.raises(ValueError, match='only a density call'):
        tp.tvf_pair(*margs, emit=True)
    with pytest.raises(ValueError, match='takes no hand-off'):
        tp.tvf_pair(*dargs, handoff=handoff)
    with pytest.raises(ValueError, match='a hand-off of'):
        tp.tvf_pair(*margs, handoff=handoff._replace(
            sources=(('other', 1),)))
    out = link.run(density, dargs)
    assert all(torch.equal(out[p], v)
               for p, v in tp.tvf_pair(*dargs).items())
    assert link.handoff is not None
    got = link.run(momentum, margs)
    assert link.handoff is None
    assert all(torch.equal(got[p], v)
               for p, v in tp.tvf_pair(*margs).items())


def test_linked_evaluator_matches_jax():
    """The Taylor-Green vortex's first eval on the kernel engine, its
    density and momentum plans linked, from the perturbed lattice of
    ``test_torch_taylor_green.py`` against pysph_tpu's XLA engine (its
    overflow checked) at 1e-10 of max|ref|."""
    ref, inputs, _ = _jax_eval('perturbed')
    s = _port_eval(inputs, 'kernel')
    assert len(_linked(s.acceleration_evals[0]._plans.values())) == 1
    _check_eval(s, ref)


def test_linked_pair_counts_one_walk():
    """The work of a linked pair (``roofline.tvf_work``) holds one
    walk's support tests: the consuming momentum call counts its pairs'
    work and no candidate."""
    (_, _, _, dargs), (_, _, _, margs) = _tg_calls()
    walked = roofline.tvf_work(*margs)
    listed = roofline.tvf_work(*margs, walks=False)
    assert walked['candidates'] > walked['pairs'] > 0
    assert listed['candidates'] == listed['visited'] == 0
    assert (listed['pairs'], listed['bytes']) == (walked['pairs'],
                                                  walked['bytes'])
    image = roofline.IMAGE_FLOPS * 2
    assert walked['flops'] - listed['flops'] == \
        walked['candidates'] * (roofline.SUPPORT_FLOPS + image)
    assert roofline.tvf_work(*dargs)['candidates'] == walked['candidates']
