"""The port's TVF equations, ``QuinticSpline`` and ``TVFScheme`` against
pysph_tpu (float64, on the CPU, inputs seeded with numpy).

- ``QuinticSpline``'s W, dW/dq and gradient against the JAX kernel's at
  1e-10 relative, in 1D, 2D and 3D.
- Each TVF equation of ``sph/wc/transport_velocity.py`` new to the port
  (``SummationDensity``, ``VolumeFromMassDensity``, TVF's
  ``ContinuityEquation``, ``MomentumEquationPressureGradient`` with its
  damped body force, ``MomentumEquationViscosity``,
  ``MomentumEquationArtificialStress``), and the whole momentum phase
  set of ``tvf_pair``, through the port's ``SPHEvaluator`` on a box
  periodic in x and y (and one open box) against the JAX
  ``SPHEvaluator``, at 1e-10 of ``max|ref|``: on the kernel engine (on
  the CPU, ``tvf_pair``'s plain version) and on the torch engine.
- The port's counterpart of ``test_taylor_green_periodic_tvf_1e6``
  (``tests/test_reference_parity.py:443``): the periodic TVF pipeline
  through the port's ``SPHEvaluator`` against the same float64
  minimum-image all-pairs oracle, at 1e-6 relative L2.
- ``TVFScheme`` with a solid array (a channel periodic in x, with
  gravity) against the JAX scheme for one evaluation.
"""

import numpy as np
import pytest
import torch

from pysph_tpu.base.domain import DomainManager as JaxDomain
from pysph_tpu.base.kernels import QuinticSpline as JaxQuintic
from pysph_tpu.base.utils import get_particle_array as jax_array
from pysph_tpu.sph import scheme as jax_scheme
from pysph_tpu.sph.equation import Group as JaxGroup
from pysph_tpu.sph.wc import transport_velocity as jax_tv
from pysph_tpu.tools.sph_evaluator import SPHEvaluator as JaxEvaluator
from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.kernels import Gaussian, QuinticSpline
from pysph_tpu_torch.base.utils import get_particle_array
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.sph import scheme
from pysph_tpu_torch.sph.equation import Group
from pysph_tpu_torch.sph.wc import transport_velocity as tv
from pysph_tpu_torch.tools.sph_evaluator import SPHEvaluator
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = 1e-10
CPU = dict(device='cpu', dtype=torch.float64)
PROPS = ('V', 'rho', 'arho', 'au', 'av', 'aw', 'auhat', 'avhat', 'awhat')
P0 = 100.0


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


def test_quintic_spline_matches_jax():
    q = np.linspace(0.0, 3.4, 341)
    for dim in (1, 2, 3):
        jk, pk = JaxQuintic(dim=dim), QuinticSpline(dim=dim)
        assert pk.radius_scale == jk.radius_scale == 3.0
        assert abs(pk.fac - jk.fac) <= 1e-15 * jk.fac
        for h in (0.3, 1.7):
            r = q * h
            t = torch.as_tensor(r, dtype=torch.float64)
            w_j = np.asarray(jk.kernel(rij=r, h=h))
            dw_j = np.asarray(jk.dwdq(rij=r, h=h))
            assert _scaled_err(pk.kernel(rij=t, h=h).numpy(), w_j) <= TOL
            assert _scaled_err(pk.dwdq(rij=t, h=h).numpy(), dw_j) <= TOL
            xij = np.stack([r * 0.6, r * 0.8, np.zeros_like(r)])
            g_j = np.asarray(jk.gradient(xij, r, h))
            g_p = pk.gradient(torch.as_tensor(xij), t, h).numpy()
            assert _scaled_err(g_p, g_j) <= TOL


def _fluid(make, nx=10, seed=4):
    """A perturbed lattice of the unit box with seeded velocities,
    transport velocities, density, number density and pressure."""
    rng = np.random.default_rng(seed)
    dx = 1.0 / nx
    x, y = np.mgrid[dx / 2:1:dx, dx / 2:1:dx]
    x = (x.ravel() + 0.1 * dx * rng.normal(size=nx * nx)) % 1.0
    y = (y.ravel() + 0.1 * dx * rng.normal(size=nx * nx)) % 1.0
    n = x.size
    props = dict(x=x, y=y, h=1.1 * dx * np.ones(n),
                 m=dx * dx * (1.0 + 0.05 * rng.normal(size=n)),
                 rho=1.0 + 0.02 * rng.normal(size=n),
                 p=P0 * 0.05 * rng.normal(size=n),
                 V=nx * nx * (1.0 + 0.02 * rng.normal(size=n)))
    for c in ('u', 'v', 'uhat', 'vhat'):
        props[c] = rng.normal(0.0, 0.5, n)
    return make(name='fluid', additional_props=[
        'V', 'uhat', 'vhat', 'what', 'auhat', 'avhat', 'awhat', 'arho'],
        **props)


def _equations(mod, group, case):
    """The groups of an equation case, from the module ``mod`` (the JAX
    or the port's ``transport_velocity``) and ``group`` (its Group)."""
    f = ['fluid']
    sets = {
        'SummationDensity': [mod.SummationDensity('fluid', f)],
        'VolumeFromMassDensity': [mod.VolumeFromMassDensity('fluid', None)],
        'ContinuityEquation': [mod.ContinuityEquation('fluid', f)],
        'MomentumEquationPressureGradient': [
            mod.MomentumEquationPressureGradient(
                'fluid', f, pb=P0, gx=0.3, gy=-1.0, tdamp=1.0)],
        'MomentumEquationViscosity': [
            mod.MomentumEquationViscosity('fluid', f, nu=0.01)],
        'MomentumEquationArtificialStress': [
            mod.MomentumEquationArtificialStress('fluid', f)],
        'momentum phase set': [
            mod.MomentumEquationPressureGradient('fluid', f, pb=P0),
            mod.MomentumEquationArtificialViscosity('fluid', f, c0=10.0,
                                                    alpha=0.1),
            mod.MomentumEquationViscosity('fluid', f, nu=0.01),
            mod.MomentumEquationArtificialStress('fluid', f)],
    }
    return [group(equations=sets[case])]


_DOMAIN = dict(xmin=0.0, xmax=1.0, ymin=0.0, ymax=1.0, periodic_in_x=True,
               periodic_in_y=True)
CASES = ['SummationDensity', 'VolumeFromMassDensity', 'ContinuityEquation',
         'MomentumEquationPressureGradient', 'MomentumEquationViscosity',
         'MomentumEquationArtificialStress', 'momentum phase set']


def _jax_eval(case, periodic, t):
    pa = _fluid(jax_array)
    ev = JaxEvaluator([pa], _equations(jax_tv, JaxGroup, case), dim=2,
                      kernel=JaxQuintic(dim=2),
                      domain_manager=JaxDomain(**_DOMAIN) if periodic
                      else None)
    ev.evaluate(t=t, dt=1e-4)
    return {p: np.asarray(getattr(pa, p)) for p in PROPS}


def _port_eval(case, periodic, t, engine):
    pa = _fluid(get_particle_array)
    ev = SPHEvaluator([pa], _equations(tv, Group, case), dim=2,
                      kernel=QuinticSpline(dim=2),
                      domain_manager=DomainManager(**_DOMAIN) if periodic
                      else None, config=Config(engine=engine, **CPU))
    ev.evaluate(t=t, dt=1e-4)
    return {p: getattr(pa, p) for p in PROPS}, ev


@pytest.mark.parametrize('engine', ['kernel', 'torch'])
@pytest.mark.parametrize('case,periodic', [(c, True) for c in CASES] +
                         [('momentum phase set', False)])
def test_tvf_equation_matches_jax(case, periodic, engine):
    t = 0.4     # inside tdamp: the body force is damped
    want = _jax_eval(case, periodic, t)
    got, ev = _port_eval(case, periodic, t, engine)
    assert ev.grid.is_periodic == periodic
    planned = {p.op for p in ev.func_eval._plans.values() if p is not None}
    pair = case not in ('VolumeFromMassDensity', 'ContinuityEquation')
    assert planned == ({tp.tvf_pair} if pair and engine == 'kernel'
                       else set())
    checked = 0
    for p, w in want.items():
        if np.abs(w).max() == 0.0:
            assert np.abs(got[p]).max() == 0.0, p
            continue
        err = _scaled_err(got[p], w)
        assert err <= TOL, '%s.%s: %.3g' % (case, p, err)
        checked += 1
    assert checked >= 1


def _gauss2d(dx, dy, h):
    """Gaussian W, dW/dx, dW/dy in 2D for equal smoothing lengths."""
    r = np.sqrt(dx * dx + dy * dy)
    q = r / h
    w = np.where(q <= 3.0, np.exp(-q * q) / (np.pi * h * h), 0.0)
    dwdq = np.where(q <= 3.0, -2.0 * q * w, 0.0)
    with np.errstate(divide='ignore', invalid='ignore'):
        tmp = np.where(r > 1e-12, dwdq / (h * r), 0.0)
    return w, tmp * dx, tmp * dy


def _rel_l2(a, b):
    return np.sqrt(np.sum((a - b) ** 2) / np.sum(b ** 2))


@pytest.mark.parametrize('engine', ['kernel', 'torch'])
def test_taylor_green_periodic_tvf_1e6(engine):
    """The periodic TVF pipeline (SummationDensity -> StateEquation ->
    pressure gradient + viscosity + artificial stress) on a fully
    periodic box through the port's ``SPHEvaluator``, against a float64
    minimum-image all-pairs oracle at 1e-6 relative L2 on rho, p, au,
    av and auhat (the inputs of ``test_reference_parity.py:443``)."""
    L, nx = 1.0, 12
    dx = L / nx
    rho0, U = 1.0, 1.0
    p0 = (10.0 * U) ** 2 * rho0
    nu = 0.01
    xg, yg = np.mgrid[dx / 2:L:dx, dx / 2:L:dx]
    x, y = xg.ravel(), yg.ravel()
    rng = np.random.RandomState(11)
    x = (x + 0.05 * dx * rng.randn(x.size)) % L
    y = (y + 0.05 * dx * rng.randn(y.size)) % L
    u = -U * np.cos(2 * np.pi * x) * np.sin(2 * np.pi * y)
    v = U * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y)
    uhat, vhat = u * 1.02, v * 0.98
    h = 1.2 * dx
    m = rho0 * dx * dx
    fluid = get_particle_array(
        name='fluid', x=x, y=y, m=m, rho=rho0, h=h, u=u, v=v, p=0.0,
        V=0.0, uhat=uhat, vhat=vhat, what=0.0, au=0.0, av=0.0, aw=0.0,
        auhat=0.0, avhat=0.0, awhat=0.0)
    eqs = [
        Group(equations=[tv.SummationDensity('fluid', ['fluid'])],
              real=False),
        Group(equations=[tv.StateEquation('fluid', None, p0=p0, rho0=rho0,
                                          b=1.0)], real=False),
        Group(equations=[
            tv.MomentumEquationPressureGradient('fluid', ['fluid'], pb=p0),
            tv.MomentumEquationViscosity('fluid', ['fluid'], nu=nu),
            tv.MomentumEquationArtificialStress('fluid', ['fluid'])]),
    ]
    ev = SPHEvaluator([fluid], eqs, dim=2, kernel=Gaussian(dim=2),
                      domain_manager=DomainManager(**_DOMAIN),
                      config=Config(engine=engine, **CPU))
    ev.evaluate(t=0.0, dt=1e-4)
    assert set(ev.func_eval.engine_choices.values()) == {engine}

    def mi(d):
        return d - L * np.round(d / L)

    dxp = mi(x[:, None] - x[None, :])
    dyp = mi(y[:, None] - y[None, :])
    w, dwx, dwy = _gauss2d(dxp, dyp, h)
    V = np.sum(w, axis=1)
    rho = m * V
    p = p0 * (rho / rho0 - 1.0)
    pij = (rho[None, :] * p[:, None] + rho[:, None] * p[None, :]) / \
        (rho[:, None] + rho[None, :])
    Vi2 = (1.0 / V) ** 2
    fac = (Vi2[:, None] + Vi2[None, :]) / m
    au = np.sum(-pij * fac * dwx, axis=1)
    av = np.sum(-pij * fac * dwy, axis=1)
    auhat = np.sum(-p0 * fac * dwx, axis=1)
    r2 = dxp * dxp + dyp * dyp
    eps = 0.01 * h * h
    eta = nu * rho
    etaij = 2.0 * eta[:, None] * eta[None, :] / (eta[:, None] + eta[None, :])
    Fij = dxp * dwx + dyp * dwy
    visc = fac * etaij * Fij / (r2 + eps)
    au += np.sum(visc * (u[:, None] - u[None, :]), axis=1)
    av += np.sum(visc * (v[:, None] - v[None, :]), axis=1)
    dui, dvi = uhat - u, vhat - v
    Ax = 0.5 * ((rho * u * dui)[:, None] + (rho * u * dui)[None, :]) \
        * dwx + 0.5 * ((rho * u * dvi)[:, None] +
                       (rho * u * dvi)[None, :]) * dwy
    Ay = 0.5 * ((rho * v * dui)[:, None] + (rho * v * dui)[None, :]) \
        * dwx + 0.5 * ((rho * v * dvi)[:, None] +
                       (rho * v * dvi)[None, :]) * dwy
    au += np.sum(fac * Ax, axis=1)
    av += np.sum(fac * Ay, axis=1)

    assert _rel_l2(np.asarray(fluid.rho), rho) <= 1e-6
    assert _rel_l2(np.asarray(fluid.p), p) <= 1e-6
    assert _rel_l2(np.asarray(fluid.au), au) <= 1e-6
    assert _rel_l2(np.asarray(fluid.av), av) <= 1e-6
    assert _rel_l2(np.asarray(fluid.auhat), auhat) <= 1e-6


def _channel(make_fluid, make_solid, seed=8):
    """Fluid between two wall layers of three rows, periodic in x."""
    rng = np.random.default_rng(seed)
    nx, dx = 10, 0.1
    xs = np.arange(dx / 2, 1.0, dx)
    xf, yf = np.meshgrid(xs, np.arange(dx / 2, 0.6, dx))
    xw, yw = np.meshgrid(xs, np.concatenate([
        -np.arange(dx / 2, 0.3, dx), 0.6 + np.arange(dx / 2, 0.3, dx)]))
    nf, nw = xf.size, xw.size
    fluid = make_fluid(
        name='fluid', x=xf.ravel() + 0.05 * dx * rng.normal(size=nf),
        y=yf.ravel() + 0.05 * dx * rng.normal(size=nf), h=1.2 * dx,
        m=dx * dx, rho=1.0 + 0.01 * rng.normal(size=nf),
        u=rng.normal(0.0, 0.3, nf), v=rng.normal(0.0, 0.3, nf),
        uhat=rng.normal(0.0, 0.3, nf), vhat=rng.normal(0.0, 0.3, nf),
        V=nx * nx * np.ones(nf))
    solid = make_solid(name='solid', x=xw.ravel(), y=yw.ravel(),
                       h=1.2 * dx, m=dx * dx, rho=1.0,
                       V=nx * nx * np.ones(nw))
    return [fluid, solid]


SCHEME_PROPS = {'fluid': ('V', 'rho', 'p', 'au', 'av', 'auhat', 'avhat'),
                'solid': ('ug', 'vg', 'uf', 'vf', 'p', 'rho', 'wij')}


@pytest.mark.parametrize('engine', ['kernel', 'torch'])
def test_tvf_scheme_with_a_solid_matches_jax(engine):
    """``TVFScheme``'s groups with a wall array (summation density over
    fluid and wall, the wall velocity and pressure, the no-slip wall, the
    damped gravity) for one evaluation on a channel periodic in x, at
    1e-10 of ``max|ref|``."""
    from pysph_tpu.base.kernels import QuinticSpline as JQ
    from pysph_tpu.base.utils import (
        get_particle_array_tvf_fluid as jf, get_particle_array_tvf_solid
        as js)
    from pysph_tpu_torch.base.utils import (
        get_particle_array_tvf_fluid, get_particle_array_tvf_solid)
    kw = dict(dim=2, rho0=1.0, c0=10.0, nu=0.01, p0=P0, pb=P0, h0=0.12,
              gy=-1.0, alpha=0.1, tdamp=0.5)
    dom = dict(xmin=0.0, xmax=1.0, periodic_in_x=True)
    jarrays = _channel(jf, js)
    js_ = jax_scheme.TVFScheme(['fluid'], ['solid'], **kw)
    js_.setup_properties(jarrays, clean=False)
    jev = JaxEvaluator(jarrays, js_.get_equations(), dim=2, kernel=JQ(dim=2),
                       domain_manager=JaxDomain(**dom))
    jev.evaluate(t=0.2, dt=1e-4)
    arrays = _channel(get_particle_array_tvf_fluid,
                      get_particle_array_tvf_solid)
    ps = scheme.TVFScheme(['fluid'], ['solid'], **kw)
    ps.setup_properties(arrays, clean=False)
    ev = SPHEvaluator(arrays, ps.get_equations(), dim=2,
                      kernel=QuinticSpline(dim=2),
                      domain_manager=DomainManager(**dom),
                      config=Config(engine=engine, **CPU))
    ev.evaluate(t=0.2, dt=1e-4)
    if engine == 'kernel':
        # the fluid's summation density and its momentum group, the
        # no-slip wall among its terms, take tvf_pair, linked; the wall's
        # velocity and pressure take gtvf_pair, which walks the periodic
        # grid
        plans = [p for p in ev.func_eval._plans.values() if p is not None]
        assert [(p.op, p.outputs) for p in plans] == [
            (tp.tvf_pair, ('V', 'rho')),
            (gp.gtvf_pair, ('uf', 'vf', 'wf', 'wij')),
            (gp.gtvf_pair, ('wij', 'p')),
            (tp.tvf_pair, ('au', 'av', 'aw', 'auhat', 'avhat', 'awhat'))]
        assert plans[0].link is not None and plans[0].link is plans[3].link
        assert [(s.name, s.terms) for s in plans[3].sources] == [
            ('fluid', tp.MPG | tp.AVIS | tp.VISC | tp.MAS),
            ('solid', tp.MPG | tp.AVIS | tp.NOSLIP)]
        assert set(ev.func_eval.engine_choices.values()) == {'kernel'}
    jmap = {pa.name: pa for pa in jarrays}
    for pa in arrays:
        for p in SCHEME_PROPS[pa.name]:
            want = np.asarray(getattr(jmap[pa.name], p))
            err = _scaled_err(getattr(pa, p), want)
            assert err <= TOL, '%s.%s: %.3g' % (pa.name, p, err)
