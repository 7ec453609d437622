"""The host side of ``csrc/adke_pair.cu`` (``ADKEScheme``'s sets of
``ops/gasd_pair.py``) on the CPU, float64:

- ``adke_terms_reference``, the plain version of the per-source terms
  that the accelerations' launch packs into a source's plane 3
  (``p / rho^2`` and ``Hj``), bit for bit what ``ADKEAccelerations``'
  own ``loop`` computes;
- ``roofline.gasd_work``'s count of ADKE's sets on the accuracy test at
  24^2: the formula of its constants, each particle's own terms once;
- ``gasd_check.adke_calls``, the card tests' inputs: periodic grids of 1,
  2, 3, 5 and 8 cells an axis, and probe dests of which the far third
  has no pair.

``tests/test_torch_gsph_cuda.py`` holds the kernel to its plain version
on the card."""

import numpy as np
import pytest
import torch

from pysph_tpu_torch.ops import gasd_pair as gd
from pysph_tpu_torch.ops import pair_sets
from pysph_tpu_torch.sph.gas_dynamics.basic import ADKEAccelerations
from pysph_tpu_torch.tools_dev import gasd_check, roofline
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401


def test_adke_terms_are_the_equations_own():
    """ADKEAccelerations' loop on one pair per source particle, with the
    dest's terms zero and the pair's geometry such that ``d_au`` is
    ``pj / rhoj^2`` and ``d_ae`` is ``Hj`` exactly: the plain plane's
    first two columns equal them bit for bit."""
    rng = np.random.default_rng(5)
    n = 1000

    def t(v):
        return torch.as_tensor(v, dtype=torch.float64)

    src = dict(p=t(rng.uniform(0.1, 3.0, n)), rho=t(rng.uniform(0.5, 2, n)),
               h=t(rng.uniform(0.01, 0.1, n)), cs=t(rng.uniform(0.5, 2, n)),
               div=t(rng.normal(size=n)))
    eq = ADKEAccelerations('fluid', ['fluid'], alpha=1.0, beta=2.0, g1=0.3,
                           g2=0.7, k=1.0, eps=0.0)
    zero, one = torch.zeros(n, dtype=torch.float64), \
        torch.ones(n, dtype=torch.float64)
    out = {p: zero.clone() for p in ('au', 'av', 'aw', 'ae')}
    idx = torch.arange(n)
    # pibrhoi2 = 0, Hi = 0, eij = 1, piij = 0 (VIJ = 0), RHOIJ (R2IJ +
    # EPS) = 1, -mj = 1, DWIJ = (1, 0, 0), XIJ = (-1, 0, 0)
    eq.loop(d_idx=idx, s_idx=idx, d_au=out['au'], d_av=out['av'],
            d_aw=out['aw'], d_ae=out['ae'], d_p=zero, s_p=src['p'],
            d_rho=one, s_rho=src['rho'], d_m=one, s_m=-one, d_cs=zero,
            s_cs=src['cs'], s_e=zero, d_e=one, s_h=src['h'], d_h=one,
            s_div=src['div'], d_div=zero, DWIJ=(one, zero, zero), HIJ=one,
            XIJ=(-one, zero, zero), VIJ=(zero, zero, zero), R2IJ=one,
            EPS=zero, RHOIJ=one, RHOIJ1=one)
    source = gd.GasdSource('fluid', gd.ADKE, (eq,), beta=eq.beta,
                           alpha=eq.alpha, g1=eq.g1, g2=eq.g2)
    plane = gd.adke_terms_reference(src, source)
    assert plane.shape == (n, 4)
    assert torch.equal(plane[:, 0], out['au'])
    assert torch.equal(plane[:, 1], out['ae'])
    assert torch.equal(plane[:, 2], zero)
    assert torch.equal(plane[:, 3], src['div'])
    # g2 is g1 in the equation (as the reference's)
    assert eq.g2 == eq.g1 == 0.3


def test_adke_work_is_the_formula_of_its_constants():
    """One evaluation's two ADKE calls on the accuracy test at 24^2
    (periodic in x and y, the Gaussian): the flops are the support tests
    of the candidates on fitted cells (12 and 1 an image: the stencil
    range's wrap) and, per pair, 11 and 1 an image for pair_of, 25 and
    two shapes (density) or 70 and one shape (accelerations), and 6 more
    on an approaching pair; the accelerations' terms of one particle once
    each: 10 a source and 8 a dest with a pair."""
    calls, _, _ = gasd_check.calls('accuracy_test_2d', 24, torch.float64,
                                   device='cpu', extra=('--scheme', 'adke'))
    adke = [c for c in calls if c[2].op is gd.gasd_pair]
    assert [c[2].sources[0].terms for c in adke] == [gd.ADEN, gd.ADKE]
    for _, _, _, args in adke:
        dest, dest_cells, _, _, sources, grid, kernel = args
        assert grid.periodic[:2] == (True, True)
        work = roofline.gasd_work(*args)
        fit, fit_dest, fit_src = roofline.fitted_cells(grid, dest, dest_cells,
                                                       sources)
        n = dest['x'].shape[0]
        flops = 0
        for (src, cells, s), fcells in zip(sources, fit_src):
            cand = roofline.stencil(fit, fit_dest, fcells)[0]
            i, j = grid.neighbor_pairs(dest, dest_cells, src, cells, (0, n))
            flops += cand * (12 + 2) + i.numel() * (
                11 + 2 + (25 + 2 * 6 if s.terms == gd.ADEN else 70 + 6))
            if s.terms == gd.ADKE:
                flops += 10 * len(set(j.tolist())) + 8 * len(set(i.tolist()))
                dot = sum((dest[v][i] - src[v][j]) *
                          grid.image(d, dest[c][i] - src[c][j])
                          for d, (c, v) in enumerate(zip('xyz', 'uvw')))
                flops += 6 * int((dot < 0).sum())
        assert work['flops'] == flops > 0


@pytest.mark.parametrize('cells', [1, 2, 3, 5, 8, None])
def test_adke_calls_cover_few_cells_and_probes(cells):
    calls = gasd_check.adke_calls(cells, torch.float64, device='cpu')
    assert [(c[1], c[2].sources[0].terms) for c in calls] == (
        [('fluid', gd.ADEN), ('fluid', gd.ADKE)] if cells else
        [('fluid', gd.ADEN), ('probe', gd.ADEN), ('fluid', gd.ADKE),
         ('probe', gd.ADKE)])
    grid = calls[0][3][5]
    assert grid.is_periodic == (cells is not None)
    if cells:
        assert grid.dims[:2] == (cells, cells)
        return
    _, _, _, args = calls[1]
    nnbr = pair_sets.neighbour_counts(args[0], args[1], args[4], args[5])
    far = gasd_check.ADKE_PROBES // 3
    assert nnbr.numel() == gasd_check.ADKE_PROBES
    assert int((nnbr[-far:] == 0).sum()) == far
    assert bool((nnbr[:-far] > 0).all())
