"""The port's CRKSPH (``sph/wc/crksph.py``, ``ops/crksph_pair.py``)
against pysph_tpu's, float64 on the CPU, inputs seeded with numpy.

- Both evaluators of ``CRKSPHScheme`` (its six pair phase sets, the
  ``post_loop`` solve, the EOS), run through the port's and the JAX
  ``SPHEvaluator`` on a jittered 16^2 box periodic in x and y (with
  ``LaminarViscosity``), an open 12^2 box with one particle far from the
  others (its system singular and its neighbours fewer than 2: ``A = 1``)
  and gravity, and a jittered open 6^3 box (with ``LaminarViscosity``),
  h varied per particle: every output at 1e-10 of ``max|ref|``, on the
  kernel engine (on the CPU ``crksph_pair``'s plain version) and on the
  periodic box also on the torch engine;
- the batched solve (``crk_solve``) against an all-numpy solve;
- the reproducing properties of the JAX package's
  ``tests/test_kernel_corrections.py::test_crksph_*``: the corrected
  kernel's zeroth moment 1 and first moment 0, the corrected gradient
  exact for a linear field, and momentum conserved under
  ``CRKSPHSymmetric``;
- the planner: the six ordered sets onto ``crksph_pair``, any other
  order or mixture refused, a 1D dest raising; a JAX state carried
  across by ``from_numpy`` (the stride-27 ``crk_gm2``, ``orig_idx``);
  and the card's tools on the CPU (``tools_dev/crksph_check.py``'s calls
  and check, ``roofline.crksph_work``, the pack's planes).

``tests/test_torch_crksph_runs.py`` holds the examples' runs to the JAX
apps; ``tests/test_torch_crksph_cuda.py`` the kernel to its plain
version on the card.
"""

import logging

import numpy as np
import pytest
import torch

from pysph_tpu.base.domain import DomainManager as JaxDomain
from pysph_tpu.base.kernels import QuinticSpline as JaxQuintic
from pysph_tpu.sph.wc import crksph as jax_crksph
from pysph_tpu.tools.sph_evaluator import SPHEvaluator as JaxEvaluator
from pysph_tpu_torch.base.domain import DomainManager
from pysph_tpu_torch.base.kernels import CubicSpline, QuinticSpline
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.base.utils import get_particle_array
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.ops import crksph_pair as cp
from pysph_tpu_torch.ops.pair_engine import PairIneligible, plan_pair_phases
from pysph_tpu_torch.sph.equation import Equation, Group
from pysph_tpu_torch.sph.wc import crksph
from pysph_tpu_torch.sph.wc.viscosity import LaminarViscosity
from pysph_tpu_torch.tools.sph_evaluator import SPHEvaluator
from pysph_tpu_torch.tools_dev import crksph_check, roofline
from pysph_tpu_torch.tools_dev.crksph_check import CASES, GAMMA, lattice
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = 1e-10
T, DT = 0.0, 1e-3
#: what the two evaluators write
OUT = ('V', 'crk_m0', 'crk_m1', 'crk_m2', 'crk_gm0', 'crk_gm1', 'crk_gm2',
       'crk_nnbr', 'ai', 'bi', 'gradai', 'gradbi', 'cwij', 'rho', 'rhofac',
       'p', 'cs', 'gradv', 'au', 'av', 'aw', 'ae')


def _scaled_err(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny)


def _stages(mod, case, dim):
    scheme = mod.CRKSPHScheme(['fluid'], dim=dim, rho0=0, c0=0, h0=0,
                              p0=0, gamma=GAMMA, cl=2, **CASES[case])
    return scheme.get_equations().groups


def _run(mod, case, engine='kernel'):
    """Both evaluators on the case's start: {prop: values} after each."""
    props, dim, periodic = lattice(case)
    if mod is jax_crksph:
        pa = jax_crksph.get_particle_array_crksph(name='fluid', **props)
        domain = JaxDomain(xmin=0, xmax=1, ymin=0, ymax=1, periodic_in_x=True,
                           periodic_in_y=True) if periodic else None
        make = lambda eqs: JaxEvaluator(  # noqa: E731
            [pa], eqs, dim=dim, kernel=JaxQuintic(dim=dim),
            domain_manager=domain)
    else:
        pa = crksph.get_particle_array_crksph(name='fluid', **props)
        domain = DomainManager(xmin=0, xmax=1, ymin=0, ymax=1,
                               periodic_in_x=True,
                               periodic_in_y=True) if periodic else None
        make = lambda eqs: SPHEvaluator(  # noqa: E731
            [pa], eqs, dim=dim, kernel=QuinticSpline(dim=dim),
            domain_manager=domain,
            config=Config(engine=engine, device='cpu', dtype=torch.float64))
    out = []
    for eqs in _stages(mod, case, dim):
        ev = make(eqs)
        ev.evaluate(t=T, dt=DT)
        if mod is crksph:
            choices = set(ev.func_eval.engine_choices.values())
            assert choices == {engine}, choices
        out.append({p: np.asarray(pa.properties[p], dtype=float).copy()
                    for p in OUT})
    return out


_JAX = {}


@pytest.mark.parametrize('case,engine', [
    ('periodic', 'kernel'), ('periodic', 'torch'), ('open', 'kernel'),
    ('3d', 'kernel')])
def test_both_evaluators_match_jax(case, engine):
    if case not in _JAX:
        _JAX[case] = _run(jax_crksph, case)
    got = _run(crksph, case, engine)
    checked = 0
    for stage, (g, w) in enumerate(zip(got, _JAX[case])):
        for p in OUT:
            if np.abs(w[p]).max() == 0.0:
                assert np.abs(g[p]).max() == 0.0, (stage, p)
                continue
            err = _scaled_err(g[p], w[p])
            assert err <= TOL, '%s stage %d %s: %.3g' % (case, stage, p, err)
            checked += 1
    assert checked >= 30
    if case == 'open':
        # the far particle: singular, one neighbour (itself)
        first = got[0]
        assert first['crk_nnbr'][-1] == 1.0 and first['ai'][-1] == 1.0
        assert not np.any(first['bi'][-3:]) and not np.any(
            first['gradbi'][-9:])


def _numpy_solve(m0, m1, m2, gm0, gm1, gm2, nnbr):
    """``crk_solve`` particle by particle with numpy's inverse."""
    n, d = m1.shape
    out = (np.ones(n), np.zeros((n, d)), np.zeros((n, d)),
           np.zeros((n, d, d)))
    for k in range(n):
        if abs(np.linalg.det(m2[k])) < 1e-14 or nnbr[k] < 2:
            continue
        inv = np.linalg.inv(m2[k])
        c = inv @ m1[k]
        ai = 1.0 / (m0[k] - c @ m1[k])
        t1 = gm0[k] - gm1[k] @ c - gm1[k] @ (inv.T @ m1[k]) + \
            np.einsum('gfs,f,s->g', gm2[k], c, c)
        out[0][k], out[2][k] = ai, -c
        out[1][k] = -ai * ai * t1
        out[3][k] = -np.einsum('ab,gb->ga', inv, gm1[k]) + \
            np.einsum('af,gfs,s->ga', inv, gm2[k], c)
    return out


@pytest.mark.parametrize('d', [1, 2, 3])
def test_the_batched_solve_is_the_inverse(d):
    rng = np.random.default_rng(d)
    n = 40
    a = rng.normal(size=(n, d, d))
    m2 = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(d)
    m2[3] = 0.0                    # singular
    args = (1.0 + rng.random(n), rng.normal(size=(n, d)), m2,
            rng.normal(size=(n, d)), rng.normal(size=(n, d, d)),
            rng.normal(size=(n, d, d, d)), np.full(n, 5.0))
    args[-1][7] = 1.0              # one neighbour
    got = crksph.crk_solve(*(torch.as_tensor(v) for v in args), d)
    want = _numpy_solve(*args)
    for g, w in zip(got, want):
        assert _scaled_err(g.numpy(), w) <= 1e-10
    assert got[0][3] == 1.0 and got[0][7] == 1.0


class GradPhi(Equation):
    """grad(u) with the (corrected) DWIJ."""

    def initialize(self, d_idx, d_gradu):
        d_gradu.assign(0.0)

    def loop(self, d_idx, d_gradu, d_u, s_idx, s_m, s_rho, s_u, DWIJ):
        fac = s_m[s_idx] / s_rho[s_idx] * (s_u[s_idx] - d_u[d_idx])
        for c in range(3):
            d_gradu[3 * d_idx + c] += fac * DWIJ[c]


class GradPhiSymm(Equation):
    """The symmetric-form gradient (sums to 0 over the particles)."""

    def initialize(self, d_idx, d_gradu):
        d_gradu.assign(0.0)

    def loop(self, d_idx, d_rho, d_gradu, d_u, s_idx, s_m, s_rho, s_u,
             DWIJ):
        fac = s_m[s_idx] / s_rho[s_idx] * \
            (s_u[s_idx] + d_u[d_idx]) / d_rho[d_idx]
        for c in range(3):
            d_gradu[3 * d_idx + c] += fac * DWIJ[c]


class VerifyCRKSPH(Equation):
    """The corrected kernel's zeroth and first moments."""

    def initialize(self, d_idx, d_zero_mom, d_first_mom):
        d_zero_mom[d_idx] = 0.0
        d_first_mom.assign(0.0)

    def loop(self, d_idx, d_zero_mom, d_first_mom, d_ai, d_bi, s_idx,
             s_m, s_rho, WIJ, XIJ):
        cw = d_ai[d_idx] * (1.0 + d_bi[3 * d_idx] * XIJ[0] +
                            d_bi[3 * d_idx + 1] * XIJ[1] +
                            d_bi[3 * d_idx + 2] * XIJ[2])
        vw = s_m[s_idx] / s_rho[s_idx] * WIJ * cw
        d_zero_mom[d_idx] += vw
        for c in range(3):
            d_first_mom[3 * d_idx + c] += vw * XIJ[c]


def _moments_array(dim, perturbed):
    """The JAX test's 2^dim particles, u = x + y (+ z)."""
    axes = np.mgrid[tuple(slice(0.5, 1, 2j) for _ in range(dim))]
    pos = [c.ravel() for c in axes]
    if perturbed:
        d = np.resize([0.1, 0.05, -0.1, -0.05], pos[0].size)
        pos = [c + d for c in pos]
    props = dict(zip('xyz', pos))
    pa = get_particle_array(name='fluid', h=0.5, m=1.0, u=sum(pos), V=1.0,
                            **props)
    for name, stride in (('gradu', 3), ('cwij', 1), ('ai', 1),
                         ('gradai', 3), ('bi', 3), ('gradbi', 9),
                         ('zero_mom', 1), ('first_mom', 3)) + \
            crksph._CRK_TEMPS:
        pa.add_property(name, stride=stride)
    return pa


@pytest.mark.parametrize('dim,perturbed,symmetric', [
    (2, False, False), (2, True, False), (3, True, False),
    (2, False, True), (2, True, True)])
def test_reproducing_properties(dim, perturbed, symmetric):
    from pysph_tpu_torch.sph.basic_equations import SummationDensity
    pa = _moments_array(dim, perturbed)
    d, s = 'fluid', ['fluid']
    corr = crksph.CRKSPHSymmetric if symmetric else crksph.CRKSPH
    grad = GradPhiSymm if symmetric else GradPhi
    eqs = [Group([crksph.NumberDensity(d, s)]),
           Group([SummationDensity(d, s)]),
           Group([crksph.CRKSPHPreStep(d, s, dim=dim)]),
           Group([corr(d, s, dim=dim, tol=1000.0), grad(d, s),
                  VerifyCRKSPH(d, s)])]
    SPHEvaluator([pa], eqs, dim=dim, kernel=CubicSpline(dim=dim),
                 config=Config(engine='torch', device='cpu',
                               dtype=torch.float64)).evaluate(0.0, 0.1)
    np.testing.assert_array_almost_equal(pa.zero_mom, 1.0, decimal=5)
    np.testing.assert_array_almost_equal(pa.first_mom, 0.0, decimal=5)
    gradu = np.asarray(pa.gradu).reshape(-1, 3)
    if symmetric:
        # momentum: the accelerations sum to 0
        assert abs(gradu[:, 0].sum()) < 1e-6 and abs(gradu[:, 1].sum()) < 1e-6
    else:
        expect = np.ones_like(gradu)
        expect[:, dim:] = 0.0
        np.testing.assert_array_almost_equal(gradu, expect, decimal=5)


def _sources(eqs):
    return {'fluid': eqs}


def test_the_planner_takes_the_six_sets_in_order():
    k2 = QuinticSpline(dim=2)
    d, s = 'fluid', ['fluid']
    sym = crksph.CRKSPHSymmetric(d, s, dim=2)
    sets = {cp.NDEN: [crksph.NumberDensity(d, s)],
            cp.MOMS: [crksph.CRKSPHPreStep(d, s, dim=2)],
            cp.RHO: [sym, crksph.SummationDensityCRKSPH(d, s)],
            cp.GRADV: [sym, crksph.VelocityGradient(d, s, dim=2)],
            cp.MOM: [sym, crksph.MomentumEquation(d, s, dim=2, cl=3.0)],
            cp.MOM | cp.VISC: [sym, crksph.MomentumEquation(d, s, dim=2),
                               LaminarViscosity(d, s, nu=0.1)],
            cp.ENERGY: [sym, crksph.EnergyEquation(d, s, dim=2, gamma=1.4)]}
    for terms, eqs in sets.items():
        plan = plan_pair_phases(d, _sources(eqs), k2)
        assert plan.op is cp.crksph_pair and \
            plan.sources[0].terms == terms
        assert plan.outputs == cp.TERM_OUTPUTS[terms]
    assert plan_pair_phases(d, _sources(sets[cp.MOM]), k2).sources[0].cl == 3
    visc = plan_pair_phases(d, _sources(sets[cp.MOM | cp.VISC]), k2)
    assert visc.sources[0].nu == 0.1 and visc.sources[0].eta == 0.01
    energy = plan_pair_phases(d, _sources(sets[cp.ENERGY]), k2).sources[0]
    assert (energy.gamma, energy.eta_crit) == (1.4, 0.5)


@pytest.mark.parametrize('which', ['reversed', 'alone', 'mixed', 'dims',
                                   'sources'])
def test_the_planner_refuses_other_orders(which):
    k2 = QuinticSpline(dim=2)
    d, s = 'fluid', ['fluid']
    sym = crksph.CRKSPHSymmetric(d, s, dim=2)
    mom = crksph.MomentumEquation(d, s, dim=2)
    sources = {
        'reversed': {'fluid': [mom, sym]},
        'alone': {'fluid': [sym]},
        'mixed': {'fluid': [sym, mom, crksph.VelocityGradient(d, s, 2)]},
        'dims': {'fluid': [crksph.CRKSPHSymmetric(d, s, dim=3), mom]},
        'sources': {'fluid': [sym, mom], 'other': [
            sym, crksph.EnergyEquation(d, s, dim=2, gamma=1.4)]},
    }[which]
    with pytest.raises(PairIneligible, match='crksph'):
        plan_pair_phases(d, sources, k2)


def test_a_refused_order_runs_on_the_torch_engine(caplog):
    k2 = QuinticSpline(dim=2)
    d, s = 'fluid', ['fluid']
    eqs = [crksph.MomentumEquation(d, s, dim=2),
           crksph.CRKSPHSymmetric(d, s, dim=2)]
    pa = crksph.get_particle_array_crksph(
        name='fluid', x=np.linspace(0, 1, 8), y=np.zeros(8), h=0.2, m=1.0,
        rho=1.0, V=5.0)
    with caplog.at_level(logging.INFO, logger='pysph_tpu_torch'):
        ev = SPHEvaluator([pa], [Group(eqs)], dim=2, kernel=k2,
                          config=Config(device='cpu', dtype=torch.float64))
    assert set(ev.func_eval.engine_choices.values()) == {'torch'}
    assert 'torch pair engine for fluid' in caplog.text


def test_a_1d_dest_raises():
    k1 = QuinticSpline(dim=1)
    d, s = 'fluid', ['fluid']
    with pytest.raises(NotImplementedError, match='item 27'):
        plan_pair_phases(d, _sources([crksph.NumberDensity(d, s)]), k1)


def test_a_jax_state_carries_across():
    props, dim, _ = lattice('3d')
    pa = jax_crksph.get_particle_array_crksph(name='fluid', **props)
    scheme = jax_crksph.CRKSPHScheme(['fluid'], dim=3, rho0=0, c0=0, nu=0,
                                     h0=0, p0=0)
    scheme.setup_properties([pa])
    rng = np.random.default_rng(1)
    pa.crk_gm2[:] = rng.normal(size=pa.crk_gm2.size)
    got = ParticleArray.from_numpy(
        'fluid', {k: np.asarray(v) for k, v in pa.properties.items()},
        stride=dict(pa.stride))
    mine = crksph.get_particle_array_crksph(name='fluid', **props)
    crksph.CRKSPHScheme(['fluid'], dim=3, rho0=0, c0=0, nu=0, h0=0,
                        p0=0).setup_properties([mine])
    assert set(got.properties) == set(mine.properties)
    assert got.stride == mine.stride and got.stride['crk_gm2'] == 27
    state = got.to_device(Config(device='cpu', dtype=torch.float64))
    n = len(props['x'])
    assert state['crk_gm2'].shape == (n, 27)
    assert np.array_equal(state['crk_gm2'].numpy().ravel(),
                          np.asarray(pa.crk_gm2))
    assert np.array_equal(np.asarray(got.orig_idx), np.arange(n))
    assert set(mine.output_property_arrays) == set(
        pa.output_property_arrays)


@pytest.mark.parametrize('case', ['open', '3d'])
def test_the_card_tools_run_on_the_cpu(case):
    """``crksph_check``'s calls of both evaluators (six sets) held to the
    plain version (on the CPU the plain version itself), and each call's
    roofline work: candidates, pairs and flops of the set."""
    calls = crksph_check.box_calls(case, torch.float64, device='cpu')
    assert [crksph_check.SET_NAMES[c[2].sources[0].terms] for c in calls] \
        == ['number density', 'moments', 'density', 'velocity gradient',
            'momentum', 'energy']
    found = crksph_check.check(calls, case, TOL)
    assert found['max_scaled_err'] == 0.0 and found['pairs'] > 0
    for c in calls:
        w = roofline.crksph_work(*c[3])
        assert w['candidates'] >= w['pairs'] > 0
        assert w['flops'] > w['pairs'] * roofline.CRKSPH_SET_FLOPS[
            c[2].kernel.dim][c[2].sources[0].terms & ~cp.VISC]
        assert w['bytes'] > 0


@pytest.mark.parametrize('dim', [2, 3])
def test_the_pack_planes_are_the_cuda_source(dim):
    """``PACK_RECORDS[dim]`` as ``csrc/crksph_pair.cu`` names its planes,
    within the pack's planes, and each set's layout."""
    import re
    from pysph_tpu_torch.ops import build, cell_pack
    text = (build.CSRC / 'crksph_pair.cu').read_text()
    block = text[text.index('in 2D') if dim == 2 else
                 text.index('and in 3D'):]
    rows = re.findall(r'^//\s+plane (\d): (.+)$', block, re.MULTILINE)
    names = [tuple((p.split(':')[0], int(p.split(':')[1])) if ':' in p
                   else p for p in r.split()) for _, r in rows[:7]]
    table = cp.PACK_RECORDS[dim]
    # the 3D block lists planes 3 on (planes 0-2 are the 2D block's)
    assert names == list(table if dim == 2 else table[3:])
    assert len(table) <= cell_pack.MAX_PLANES
    sets = cp.sets_of(dim)
    for terms, planes in ((cp.NDEN, 1), (cp.MOMS, 2), (cp.GRADV, 3),
                          (cp.ENERGY, len(table))):
        assert len(sets.pack_layout(terms)[0]) == planes
