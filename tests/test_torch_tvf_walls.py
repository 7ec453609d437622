"""The Adami walls on ``tvf_pair`` against pysph_tpu (float64, on the CPU,
inputs seeded with numpy), and the two oracle gates of
``tests/test_reference_parity.py`` through the port.

- ``SolidWallNoSlipBC`` alone (``tvf_pair``'s ``NOSLIP`` term: on the
  kernel engine its plain version ``tvf_pair_reference``; and the torch
  engine) against the JAX equation through the JAX ``SPHEvaluator``, at
  1e-10 of ``max|ref|``, on a channel periodic in x and on an open box.
- ``TVFScheme`` with a wall array for one evaluation on the open box,
  on both engines, at 1e-10: on the kernel engine the fluid's density
  and momentum groups on ``tvf_pair``, linked, the wall's two groups on
  ``gtvf_pair``, no dest on the torch engine
  (``tests/test_torch_tvf.py::test_tvf_scheme_with_a_solid_matches_jax``
  holds the channel periodic in x).
- ``tvf_pair``'s pack: a wall source packs the ghost velocity's plane 4,
  and a consuming call all its planes but 0.
- The port's counterparts of ``test_dam_break_2d_adami_wall_bc_1e6``
  (``:305``: the Adami wall pressure, velocity and no-slip terms with
  Monaghan's momentum, against the float64 all-pairs numpy oracle at
  1e-6 relative L2) and ``test_wcsph_vs_scalar_reference_1e6`` (``:189``:
  10 EPEC steps of the nx=10 drop against ``NumpyWCSPH`` at 1e-6), with
  that module's oracle helpers.
- The ``edac`` choices of the ported examples name ROADMAP item 35.
- Each wall example (``examples/poiseuille.py``, ``couette``, ``cavity
  --nx 12``, ``rayleigh_taylor``, ``periodic_cylinders``) for two steps
  on the CPU with dumps, and its ``post_process``; the cavity's raises
  ``NotImplementedError`` naming ROADMAP item 30
  (``tests/test_torch_tvf_wall_examples.py`` holds them to pysph_tpu);
  and the chunks against the per-step loop on the walls
  (``time_chunks.gate``: the cavity on its open grid, Poiseuille's
  channel periodic in x).
"""

import importlib
import shutil
import tempfile
import types

import numpy as np
import pytest
import torch

from pysph_tpu.base.domain import DomainManager as JaxDomain
from pysph_tpu.base.kernels import QuinticSpline as JaxQuintic
from pysph_tpu.base.utils import (
    get_particle_array_tvf_fluid as jax_fluid,
    get_particle_array_tvf_solid as jax_solid)
from pysph_tpu.sph import scheme as jax_scheme
from pysph_tpu.sph.equation import Group as JaxGroup
from pysph_tpu.sph.wc import transport_velocity as jax_tv
from pysph_tpu.tools.sph_evaluator import SPHEvaluator as JaxEvaluator
from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.kernels import QuinticSpline
from pysph_tpu_torch.base.utils import (
    get_particle_array_tvf_fluid, get_particle_array_tvf_solid)
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.sph import scheme
from pysph_tpu_torch.sph.equation import Group
from pysph_tpu_torch.sph.wc import transport_velocity as tv
from pysph_tpu_torch.tools.sph_evaluator import SPHEvaluator
from pysph_tpu_torch.tools_dev import time_chunks
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401
from test_reference_parity import (
    NumpyWCSPH, _drop_particles, _gauss2d, _rel_l2)

TOL = 1e-10
CPU = dict(device='cpu', dtype=torch.float64)
NU = 0.01
GEOMETRIES = ['channel', 'box']
ENGINES = ['kernel', 'torch']


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


def _walls(make_fluid, make_solid, geometry, seed=8):
    """Fluid inside three layers of wall: ``channel``, between a bottom
    and a top wall, periodic in x on [0, 1]; ``box``, closed on all
    sides (an open grid).  Positions jittered by 5% of dx, seeded
    velocities, densities and volumes, and the wall's ghost velocity."""
    rng = np.random.default_rng(seed)
    dx = 0.1
    if geometry == 'channel':
        xs = np.arange(dx / 2, 1.0, dx)
        xf, yf = np.meshgrid(xs, np.arange(dx / 2, 0.6, dx))
        xw, yw = np.meshgrid(xs, np.concatenate([
            -np.arange(dx / 2, 0.3, dx), 0.6 + np.arange(dx / 2, 0.3, dx)]))
    else:
        g = np.arange(-0.3 + dx / 2, 0.9, dx)
        x, y = np.meshgrid(g, g)
        inside = (x > 0) & (x < 0.6) & (y > 0) & (y < 0.6)
        xf, yf, xw, yw = x[inside], y[inside], x[~inside], y[~inside]
    xf, yf, xw, yw = (a.ravel() for a in (xf, yf, xw, yw))
    nf, nw = xf.size, xw.size
    fluid = make_fluid(
        name='fluid', x=xf + 0.05 * dx * rng.normal(size=nf),
        y=yf + 0.05 * dx * rng.normal(size=nf), h=1.2 * dx,
        m=dx * dx * (1.0 + 0.05 * rng.normal(size=nf)),
        rho=1.0 + 0.01 * rng.normal(size=nf),
        u=rng.normal(0.0, 0.3, nf), v=rng.normal(0.0, 0.3, nf),
        uhat=rng.normal(0.0, 0.3, nf), vhat=rng.normal(0.0, 0.3, nf),
        p=10.0 * rng.normal(size=nf),
        V=(1.0 + 0.02 * rng.normal(size=nf)) / (dx * dx))
    solid = make_solid(
        name='solid', x=xw, y=yw, h=1.2 * dx, m=dx * dx,
        rho=1.0 + 0.01 * rng.normal(size=nw),
        u=np.where(yw > 0.6, 1.0, 0.0),
        ug=rng.normal(0.0, 0.3, nw), vg=rng.normal(0.0, 0.3, nw),
        p=10.0 * rng.normal(size=nw),
        V=(1.0 + 0.02 * rng.normal(size=nw)) / (dx * dx))
    return [fluid, solid]


def _domain(cls, geometry):
    return cls(xmin=0.0, xmax=1.0, periodic_in_x=True) \
        if geometry == 'channel' else None


def _compare(arrays, jarrays, props):
    jmap = {pa.name: pa for pa in jarrays}
    checked = 0
    for pa in arrays:
        for p in props.get(pa.name, ()):
            want = np.asarray(getattr(jmap[pa.name], p))
            got = np.asarray(getattr(pa, p))
            if np.abs(want).max() == 0.0:
                assert np.abs(got).max() == 0.0, (pa.name, p)
                continue
            err = _scaled_err(got, want)
            assert err <= TOL, '%s.%s: %.3g' % (pa.name, p, err)
            checked += 1
    return checked


@pytest.mark.parametrize('engine', ENGINES)
@pytest.mark.parametrize('geometry', GEOMETRIES)
def test_noslip_alone_matches_jax(geometry, engine):
    """``SolidWallNoSlipBC`` (fluid <- wall) for one evaluation: on the
    kernel engine a ``tvf_pair`` plan with the one term ``NOSLIP`` and
    its ``nu``, run by its plain version."""
    jarrays = _walls(jax_fluid, jax_solid, geometry)
    jev = JaxEvaluator(jarrays, [JaxGroup(equations=[
        jax_tv.SolidWallNoSlipBC('fluid', ['solid'], nu=NU)])], dim=2,
        kernel=JaxQuintic(dim=2),
        domain_manager=_domain(JaxDomain, geometry))
    jev.evaluate(t=0.0, dt=1e-4)
    arrays = _walls(get_particle_array_tvf_fluid,
                    get_particle_array_tvf_solid, geometry)
    ev = SPHEvaluator(arrays, [Group(equations=[
        tv.SolidWallNoSlipBC('fluid', ['solid'], nu=NU)])], dim=2,
        kernel=QuinticSpline(dim=2),
        domain_manager=_domain(DomainManager, geometry),
        config=Config(engine=engine, **CPU))
    ev.evaluate(t=0.0, dt=1e-4)
    assert ev.grid.is_periodic == (geometry == 'channel')
    plans = [p for p in ev.func_eval._plans.values() if p is not None]
    if engine == 'kernel':
        assert [(p.op, [(s.name, s.terms, s.noslip_nu) for s in p.sources])
                for p in plans] == [(tp.tvf_pair,
                                     [('solid', tp.NOSLIP, NU)])]
    else:
        assert plans == []
    assert _compare(arrays, jarrays, {'fluid': ('au', 'av')}) == 2


SCHEME_PROPS = {'fluid': ('V', 'rho', 'p', 'au', 'av', 'auhat', 'avhat'),
                'solid': ('ug', 'vg', 'uf', 'vf', 'p', 'rho', 'wij')}


@pytest.mark.parametrize('engine', ENGINES)
def test_tvf_scheme_with_walls_matches_jax(engine, geometry='box'):
    """``TVFScheme``'s groups with a wall array (summation density over
    fluid and wall, the wall velocity and pressure, the pressure
    gradient, artificial viscosity, viscosity, the no-slip wall and the
    artificial stress, gravity) for one evaluation at 1e-10 of
    ``max|ref|``."""
    kw = dict(dim=2, rho0=1.0, c0=10.0, nu=NU, p0=100.0, pb=100.0,
              h0=0.12, gy=-1.0, alpha=0.1)
    jarrays = _walls(jax_fluid, jax_solid, geometry)
    js = jax_scheme.TVFScheme(['fluid'], ['solid'], **kw)
    js.setup_properties(jarrays, clean=False)
    jev = JaxEvaluator(jarrays, js.get_equations(), dim=2,
                       kernel=JaxQuintic(dim=2),
                       domain_manager=_domain(JaxDomain, geometry))
    jev.evaluate(t=0.2, dt=1e-4)
    arrays = _walls(get_particle_array_tvf_fluid,
                    get_particle_array_tvf_solid, geometry)
    ps = scheme.TVFScheme(['fluid'], ['solid'], **kw)
    ps.setup_properties(arrays, clean=False)
    ev = SPHEvaluator(arrays, ps.get_equations(), dim=2,
                      kernel=QuinticSpline(dim=2),
                      domain_manager=_domain(DomainManager, geometry),
                      config=Config(engine=engine, **CPU))
    ev.evaluate(t=0.2, dt=1e-4)
    if engine == 'kernel':
        plans = [p for p in ev.func_eval._plans.values() if p is not None]
        assert [p.op for p in plans] == [tp.tvf_pair, gp.gtvf_pair,
                                         gp.gtvf_pair, tp.tvf_pair]
        assert plans[0].link is not None and plans[0].link is plans[3].link
        assert [(s.name, s.terms) for s in plans[3].sources] == [
            ('fluid', tp.MPG | tp.AVIS | tp.VISC | tp.MAS),
            ('solid', tp.MPG | tp.AVIS | tp.NOSLIP)]
        assert set(ev.func_eval.engine_choices.values()) == {'kernel'}
    assert _compare(arrays, jarrays, SCHEME_PROPS) >= 12


def test_a_wall_source_packs_its_ghost_velocity():
    """The wall's terms read plane 4 (``ug vg wg``) and not the
    velocities; a consuming momentum call packs every plane but 0, so
    the wall's ``p``, ``rho`` and ``ug``, written between the density
    and the momentum call, are packed afresh."""
    assert tp.PACK_RECORDS[4] == ('ug', 'vg', 'wg', None)
    slots, planes = tp.pack_layout(tp.MPG | tp.NOSLIP)
    assert slots == (0, 1, 4) and planes[2] == ('ug', 'vg', 'wg', None)
    assert tp.pack_layout(tp.MPG | tp.AVIS | tp.NOSLIP)[0] == (0, 1, 2, 4)
    assert tp.pack_layout(tp.MPG | tp.VISC | tp.MAS)[0] == (0, 1, 2, 3)
    assert tp.phase_of(tp.MPG | tp.NOSLIP) == tp.MOMENTUM
    assert tp.phase_of(tp.SDEN | tp.NOSLIP) is None
    arrays = _walls(get_particle_array_tvf_fluid,
                    get_particle_array_tvf_solid, 'box')
    state = arrays[1].to_device(Config(**CPU))
    order = torch.arange(state['x'].shape[0]).flip(0)
    cells = types.SimpleNamespace(order=order)
    src = tp.TvfSource('solid', tp.MPG | tp.NOSLIP, ())
    (packed,) = tp.pack_sources_reference([(state, cells, src)])
    assert packed.shape == (3, order.numel(), 4)
    assert torch.equal(packed[2, :, 0], state['ug'][order])
    assert torch.equal(packed[2, :, 1], state['vg'][order])
    assert torch.equal(packed[2, :, 3], torch.zeros_like(order,
                                                         dtype=torch.float64))


@pytest.mark.parametrize('engine', ENGINES)
def test_dam_break_2d_adami_wall_bc_1e6(engine):
    """The port's counterpart of ``test_dam_break_2d_adami_wall_bc_1e6``
    (``tests/test_reference_parity.py:305``): the Adami generalised wall
    pressure, the wall velocity and the no-slip wall with Monaghan's
    momentum (a wall source), through the port's ``SPHEvaluator`` on a
    fluid block resting on a two-layer floor, against the same
    independent float64 all-pairs numpy oracle (``_gauss2d``) at 1e-6
    relative L2 on the wall's p and rho and the fluid's au and av."""
    from pysph_tpu_torch.base.kernels import Gaussian
    from pysph_tpu_torch.base.utils import get_particle_array
    from pysph_tpu_torch.sph.wc.basic import MomentumEquation, TaitEOS

    dx = 0.05
    rho0, c0, gamma, g = 1000.0, 40.0, 7.0, -9.81
    p0 = rho0 * c0 * c0 / gamma
    nu, alpha = 1e-4, 0.1
    xf, yf = np.mgrid[dx / 2:0.4:dx, dx / 2:0.3:dx]
    xf, yf = xf.ravel(), yf.ravel()
    rng = np.random.RandomState(3)
    rhof = rho0 * (1.0 + 0.02 * rng.rand(xf.size))
    uf_ = 0.1 * rng.randn(xf.size)
    vf_ = 0.1 * rng.randn(xf.size)
    xb, yb = np.mgrid[-2 * dx:0.4 + 2 * dx:dx,
                      -dx / 2:-2 * dx - dx:-dx]
    xb, yb = xb.ravel(), yb.ravel()
    h = 1.3 * dx
    m = rho0 * dx * dx
    extra = dict(V=0.0, uf=0.0, vf=0.0, wf=0.0, wij=0.0, ug=0.0,
                 vg=0.0, wg=0.0, auhat=0.0, avhat=0.0, awhat=0.0,
                 cs=0.0, dt_cfl=0.0, dt_force=0.0, au=0.0, av=0.0,
                 aw=0.0)
    fluid = get_particle_array(
        name='fluid', x=xf, y=yf, m=m, rho=rhof, h=h, u=uf_, v=vf_,
        p=0.0, **extra)
    wall = get_particle_array(
        name='wall', x=xb, y=yb, m=m, rho=rho0, h=h, p=0.0, **extra)
    eqs = [
        Group(equations=[
            TaitEOS('fluid', None, rho0=rho0, c0=c0, gamma=gamma),
            tv.VolumeSummation('fluid', ['fluid', 'wall']),
            tv.VolumeSummation('wall', ['fluid', 'wall']),
        ], real=False),
        Group(equations=[tv.SetWallVelocity('wall', ['fluid'])],
              real=False),
        Group(equations=[tv.SolidWallPressureBC('wall', ['fluid'],
                                                rho0=rho0, p0=p0, gy=g)],
              real=False),
        Group(equations=[
            MomentumEquation('fluid', ['fluid', 'wall'], c0=c0,
                             alpha=alpha, beta=0.0, gy=g),
            tv.SolidWallNoSlipBC('fluid', ['wall'], nu=nu),
        ]),
    ]
    ev = SPHEvaluator([fluid, wall], eqs, dim=2, kernel=Gaussian(dim=2),
                      config=Config(engine=engine, **CPU))
    ev.evaluate(t=0.0, dt=1e-4)

    # the float64 numpy oracle (all pairs), as the JAX gate's
    B = rho0 * c0 * c0 / gamma
    pf = B * ((rhof / rho0) ** gamma - 1.0)
    csf = c0 * (rhof / rho0) ** (0.5 * (gamma - 1.0))
    xall = np.concatenate([xf, xb])
    yall = np.concatenate([yf, yb])
    nf = xf.size

    def WDW(xd, yd, xs, ys):
        return _gauss2d(xd[:, None] - xs[None, :],
                        yd[:, None] - ys[None, :], h)

    w_aa, _, _ = WDW(xall, yall, xall, yall)
    V_all = np.sum(w_aa, axis=1)
    w_bf, _, _ = WDW(xb, yb, xf, yf)
    wij_b = np.sum(w_bf, axis=1)
    has = wij_b > 1e-12
    den = np.where(has, wij_b, 1.0)
    ufw = np.where(has, w_bf @ uf_ / den, 0.0)
    vfw = np.where(has, w_bf @ vf_ / den, 0.0)
    ug, vg = -ufw, -vfw
    gdotx = g * (yb[:, None] - yf[None, :])
    pw_num = np.sum(w_bf * (pf[None, :] + rhof[None, :] * gdotx), axis=1)
    den_p = np.where(wij_b > 1e-14, wij_b, 1.0)
    pw = np.where(wij_b > 1e-14, pw_num / den_p, 0.0)
    rhow = rho0 * (pw / p0 + 1.0)
    pall = np.concatenate([pf, pw])
    rhoall = np.concatenate([rhof, rhow])
    csall = np.concatenate([csf, np.zeros(xb.size)])
    uall = np.concatenate([uf_, np.zeros(xb.size)])
    vall = np.concatenate([vf_, np.zeros(xb.size)])
    dxp = xf[:, None] - xall[None, :]
    dyp = yf[:, None] - yall[None, :]
    du = uf_[:, None] - uall[None, :]
    dv = vf_[:, None] - vall[None, :]
    w, dwx, dwy = _gauss2d(dxp, dyp, h)
    r2 = dxp * dxp + dyp * dyp
    eps = 0.01 * h * h
    vdotx = du * dxp + dv * dyp
    rhoij1 = 2.0 / (rhof[:, None] + rhoall[None, :])
    cij = 0.5 * (csf[:, None] + csall[None, :])
    muij = h * vdotx / (r2 + eps)
    piij = np.where(vdotx < 0, (-alpha * cij * muij) * rhoij1, 0.0)
    tmp = (pf / rhof ** 2)[:, None] + (pall / rhoall ** 2)[None, :]
    au = np.sum(-m * (tmp + piij) * dwx, axis=1)
    av = np.sum(-m * (tmp + piij) * dwy, axis=1) + g
    dxw = xf[:, None] - xb[None, :]
    dyw = yf[:, None] - yb[None, :]
    _, dwxw, dwyw = _gauss2d(dxw, dyw, h)
    r2w = dxw * dxw + dyw * dyw
    eta_f, eta_w = nu * rhof, nu * rhow
    etaij = 2.0 * (eta_f[:, None] * eta_w[None, :]) / \
        (eta_f[:, None] + eta_w[None, :])
    Fij = dxw * dwxw + dyw * dwyw
    Vi = (1.0 / V_all[:nf]) ** 2
    Vj = (1.0 / V_all[nf:]) ** 2
    fac = (1.0 / m) * (Vi[:, None] + Vj[None, :]) * etaij * Fij / \
        (r2w + eps)
    au += np.sum(fac * (uf_[:, None] - ug[None, :]), axis=1)
    av += np.sum(fac * (vf_[:, None] - vg[None, :]), axis=1)

    assert _rel_l2(np.asarray(wall.p), pw) <= 1e-6
    assert _rel_l2(np.asarray(wall.rho), rhow) <= 1e-6
    assert _rel_l2(np.asarray(fluid.au), au) <= 1e-6
    assert _rel_l2(np.asarray(fluid.av), av) <= 1e-6


@pytest.mark.parametrize('engine', ENGINES)
def test_wcsph_vs_scalar_reference_1e6(engine):
    """The port's counterpart of ``test_wcsph_vs_scalar_reference_1e6``
    (``tests/test_reference_parity.py:189``): Tait EOS, continuity,
    Monaghan's momentum and XSPH on the nx=10 drop, 10 EPEC steps,
    against ``NumpyWCSPH`` at 1e-6 relative L2 on rho, p, x, y, u and
    v; the kernel engine runs the pair group on ``wcsph_pair``, the
    torch engine at its capacities, each step redone where they were
    outgrown (``run_sized``, as the solver does)."""
    from pysph_tpu_torch.base.cell_grid import CellGrid
    from pysph_tpu_torch.base.kernels import Gaussian
    from pysph_tpu_torch.base.utils import get_particle_array_wcsph
    from pysph_tpu_torch.ops import wcsph_pair as wp
    from pysph_tpu_torch.sph.acceleration_eval import (
        AccelerationEval, run_sized)
    from pysph_tpu_torch.sph.basic_equations import (
        ContinuityEquation, XSPHCorrection)
    from pysph_tpu_torch.sph.integrator import EPECIntegrator
    from pysph_tpu_torch.sph.integrator_step import WCSPHStep
    from pysph_tpu_torch.sph.wc.basic import MomentumEquation, TaitEOS

    c0, alpha = 1400.0, 0.1
    parts = _drop_particles(nx=10)
    oracle = NumpyWCSPH(*parts, rho0=1.0, c0=c0, gamma=7.0, alpha=alpha,
                        beta=0.0)
    x, y, m, h, rho, u, v = parts
    pa = get_particle_array_wcsph(
        name='fluid', x=x, y=y, m=m, rho=rho, h=h, u=u, v=v,
        cs=np.full(x.size, c0))
    equations = [
        Group(equations=[TaitEOS('fluid', None, rho0=1.0, c0=c0,
                                 gamma=7.0)], real=False),
        Group(equations=[
            ContinuityEquation('fluid', ['fluid']),
            MomentumEquation('fluid', ['fluid'], c0=c0, alpha=alpha,
                             beta=0.0),
            XSPHCorrection('fluid', ['fluid']),
        ]),
    ]
    config = Config(engine=engine, **CPU)
    grid = CellGrid.from_particles([pa], dim=2, radius_scale=3.0)
    a_eval = AccelerationEval([pa], equations, Gaussian(dim=2), config,
                              grid)
    assert set(a_eval.engine_choices.values()) == {engine}
    assert {p.op for p in a_eval._plans.values() if p is not None} == (
        {wp.wcsph_pair} if engine == 'kernel' else set())
    integrator = EPECIntegrator(fluid=WCSPHStep())
    integrator.set_acceleration_evals([a_eval])
    states = {'fluid': pa.to_device(config)}
    dt = 0.25 * 1.3 * 0.1 / (141 + c0)
    t = 0.0
    for _ in range(10):
        # as the solver does: a step whose torch engine lists outgrew
        # their capacities runs again with them grown
        run_sized(grid, states, lambda: integrator.step(states, t, dt))
        oracle.epec_step(dt)
        t += dt
    s = {p: val.numpy() for p, val in states['fluid'].items()}
    for prop, ref in (('rho', oracle.rho), ('p', oracle.p),
                      ('x', oracle.x), ('y', oracle.y),
                      ('u', oracle.u), ('v', oracle.v)):
        err = _rel_l2(s[prop], ref)
        assert err <= 1e-6, '%s rel L2 %.3g > 1e-6' % (prop, err)


@pytest.mark.parametrize('example,argv', [
    ('taylor_green', ['--nx', '8']), ('dam_break_2d', ['--dx', '0.5']),
    ('cavity', ['--nx', '8'])])
def test_edac_is_refused_naming_its_item(example, argv):
    """``--scheme edac`` raises ``NotImplementedError`` naming ROADMAP
    Queue 1 item 35, the item that ports EDAC."""
    mod = importlib.import_module('pysph_tpu_torch.examples.' + example)
    cls = {'taylor_green': 'TaylorGreen', 'dam_break_2d': 'DamBreak2D',
           'cavity': 'LidDrivenCavity'}[example]
    with pytest.raises(NotImplementedError,
                       match=r'ROADMAP Queue 1 item 35\b'):
        getattr(mod, cls)().setup(['--device', 'cpu', '-q',
                                   '--disable-output', '--scheme', 'edac']
                                  + argv)


#: {example: (application class, arguments)}
EXAMPLES = {
    'poiseuille': ('PoiseuilleFlow', []),
    'couette': ('CouetteFlow', []),
    'cavity': ('LidDrivenCavity', ['--nx', '12']),
    'rayleigh_taylor': ('RayleighTaylor', []),
    'periodic_cylinders': ('PeriodicCylinders', []),
}


@pytest.mark.parametrize('example', list(EXAMPLES))
def test_example_runs_and_post_processes(example):
    tmp = tempfile.mkdtemp()
    try:
        name, argv = EXAMPLES[example]
        app = getattr(importlib.import_module(
            'pysph_tpu_torch.examples.' + example), name)()
        app.run(['--device', 'cpu', '-q', '-d', tmp, '--max-steps', '2',
                 '--pfreq', '1'] + argv)
        assert app.solver.count == 2 and len(app.output_files) == 3
        for st in app.solver.states.values():
            assert all(bool(v.isfinite().all()) for v in st.values()
                       if v.is_floating_point())
        if example == 'cavity':
            with pytest.raises(NotImplementedError,
                               match=r'ROADMAP Queue 1 item 30\b'):
                app.post_process(app.info_filename)
            return
        out = app.post_process(app.info_filename)
        data = np.load(tmp + '/results.npz')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if example in ('poiseuille', 'couette'):
        y, u, ue = out
        assert np.array_equal(data['u'], u) and data['ue'].max() > 0
    elif example == 'rayleigh_taylor':
        t, ymin = out
        assert len(t) == 3 and data['spike_y'].tolist() == ymin
    else:
        assert np.isfinite(data['umax'])


@pytest.mark.parametrize('case', ['cavity nx=20', 'poiseuille'])
def test_chunks_match_the_per_step_loop(case):
    held = time_chunks.gate(case, 'cpu')
    assert held['steps'] == time_chunks.GATE_STEPS
    assert held['max_scaled_err'] <= time_chunks.TOL
