"""``WCSPHScheme``'s remaining options on the card, each kernel against its
plain torch version: on the Taylor-Green vortex's periodic box
(``--scheme wcsph``, ``QuinticSpline``) ``wcsph_pair``'s tensile
correction (``TENS``) and summation-density launch (``SDEN``) on both
kernel engines, ``--delta-sph``'s ``delta_pair`` periodic branch (the
accept decisions' flips counted and 0, the linked pair bit for bit the
walk, its list ``neighbours_reference``'s) and ``wcsph_pair``'s delta
terms with ``LaminarViscosityDeltaSPH`` (``LVD``); and the later kinds
(``WendlandQuinticC4``, ``WendlandQuinticC6``, ``SuperGaussian`` in 2D
and 3D) in every pair kernel that takes kinds
(``tools_dev/kind_check.py``).

Skips without an NVIDIA card (a CUDA kernel has no CPU mode).  This file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda \\
        tests/test_torch_wcsph_options_cuda.py
"""

import pytest
import torch

from pysph_tpu_torch.ops import cell_pack
from pysph_tpu_torch.ops import delta_pair as dl
from pysph_tpu_torch.ops import dense_pair as dp
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.tools_dev import delta_check, kind_check, tvf_check
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
DTYPES = [torch.float64, torch.float32]
#: the option's flag and the term bit its calls must hold
TERMS = {'--tensile-correction': wp.TENS, '--summation-density': wp.SDEN}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (a CUDA kernel has no CPU mode)')


@pytest.mark.cuda
@pytest.mark.parametrize('edges', [False, True])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('engine,op', [('kernel', wp.wcsph_pair),
                                       ('dense', dp.dense_pair)])
@pytest.mark.parametrize('flag', list(TERMS))
def test_term_matches_plain_version_on_the_card(flag, engine, op, dtype,
                                                edges):
    """Every pair call of one eval at nx=20 on the periodic box (with
    ``edges`` a tenth of the particles on its edges and corners): the
    term in the calls, one pack a call, every output within ``TOL`` of
    max|ref|."""
    _need_card()
    calls, _, _ = tvf_check.calls(20, dtype, edges, 'wcsph', engine,
                                  (flag,))
    assert {c[2].op for c in calls} == {op}
    assert any(ps.terms & TERMS[flag] for c in calls
               for ps in c[2].sources)
    packs = cell_pack.pack.launches
    tvf_check.compare(calls, TOL[dtype])
    assert cell_pack.pack.launches - packs == len(calls)


@pytest.mark.cuda
@pytest.mark.parametrize('edges', [False, True])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('nx', [20, 50])
def test_periodic_delta_matches_plain_version_on_the_card(nx, dtype, edges):
    """``--delta-sph`` on the periodic box after one eval: ``delta_pair``
    and ``wcsph_pair``'s delta terms (with ``LVD``) within ``TOL`` of
    their plain versions with no flipped accept decision, and the linked
    pair bit for bit the walk with its list ``neighbours_reference``'s,
    also at capacity 1 (every warp walks)."""
    _need_card()
    calls, _, _ = tvf_check.calls(nx, dtype, edges, 'wcsph', 'kernel',
                                  ('--delta-sph',), evaluate=True)
    assert {c[2].op for c in calls} == {dl.delta_pair, wp.wcsph_pair}
    assert any(ps.terms & wp.LVD for c in calls for ps in c[2].sources)
    found = delta_check.check(calls, 'taylor_green --delta-sph')
    assert found['flips'] == 0
    for capacity in (None, 1):
        linked = delta_check.check_linked(calls, 'taylor_green --delta-sph',
                                          capacity=capacity)
        assert linked['linked'] == 1 and linked['flips'] == 0
        # the edge cases stack particles at the corners, past any capacity
        if capacity == 1 or not edges:
            assert bool(linked['overflowed']) == (capacity == 1)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('kernel', kind_check.NEW_KINDS)
def test_later_kinds_match_plain_version_on_the_card(kernel, dtype):
    """Each later kind in ``tvf_pair``, ``gtvf_pair``, ``wcsph_pair``,
    ``dense_pair`` and ``delta_pair`` on the Taylor-Green vortex at
    nx=20 and dam_break_3d at dx=0.12."""
    _need_card()
    found = kind_check.check(kernel, dtype, nx=20, dx=0.12)
    kinds = {k for f in found.values() for k in f['kinds']}
    assert kinds == ({6, 7} if kernel == 'SuperGaussian' else
                     {4 if kernel.endswith('C4') else 5})
    assert all(f['max_scaled_err'] <= TOL[dtype] for f in found.values())
