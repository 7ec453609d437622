"""Seeded edge cases of the pair kernels' walks.

Each case of ``CASES`` is the argument tuple of one ``wcsph_pair`` /
``dense_pair`` call (``ops/wcsph_pair.py``), built from numpy random
numbers, with particles pushed beyond the grid so that ``CellGrid``
clamps them into its edge cells:

- ``clamped-3d``: WendlandQuintic, a fluid and a wall source, and a fat
  corner cell of clamped particles longer than one ``dense_pair`` stage;
- ``grid-2d``: the Gaussian kernel on a 2D grid (``nz = 1``);
- ``four-sources``: CubicSpline, four sources with four term masks;
- ``empty-dest``: a dest array of no particles.

Every case but ``four-sources`` has a write mask.  ``gtvf_calls`` gives
the ``gtvf_pair`` calls of both evaluators of a small GTVF dam break and
the wall's EDAC set of the EDAC dam break (every phase set), optionally
with a crowded clamped edge cell, and ``fused_case`` a
``fused_continuity_momentum`` call with rows of ``h <= 0``, a clamped
edge cell and cells of a chosen width.  The cases run on any device:
the CPU tests hold the walks' rules to them and the card tests and
``chip_smoke.py`` hold the kernels to their plain version on them
(``check_kernel``).
"""

import numpy as np
import torch

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.kernels import CubicSpline, Gaussian, WendlandQuintic
from pysph_tpu_torch.examples.dam_break_2d import DamBreak2D
from pysph_tpu_torch.examples.elliptical_drop import EllipticalDrop
from pysph_tpu_torch.ops import cell_pack, cell_walk
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.ops.pair_engine import PairSource
from pysph_tpu_torch.tools_dev.time_walks import plan_calls

CASES = ('clamped-3d', 'grid-2d', 'four-sources', 'empty-dest')
ALL = wp.CONT | wp.MOM | wp.XSPH


def _state(rng, dim, lo, hi, dx, dtype, device, n=None):
    """Particles uniform in the box [lo, hi)^dim, one per dx^dim unless
    ``n`` is given, with seeded props."""
    if n is None:
        n = int(round(((hi - lo) / dx) ** dim))
    xyz = np.zeros((3, n))
    xyz[:dim] = rng.uniform(lo, hi, (dim, n))
    vel = rng.normal(0.0, 1.0, (3, n))
    vel[dim:] = 0.0
    rho = 1000.0 * (1.0 + 0.01 * rng.normal(size=n))
    cols = dict(x=xyz[0], y=xyz[1], z=xyz[2], u=vel[0], v=vel[1],
                w=vel[2], h=1.3 * dx * (1.0 + 0.05 * rng.uniform(size=n)),
                m=1000.0 * dx ** dim * np.ones(n), rho=rho,
                p=1e4 * rng.normal(size=n),
                cs=10.0 * (1.0 + 0.1 * rng.uniform(size=n)))
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in cols.items()}


def _cat(a, b):
    return {k: torch.cat([a[k], b[k]]) for k in a}


def make_case(name, device='cpu', dtype=torch.float64, seed=0):
    """The argument tuple (dest, dest cells, write mask, pre, sources,
    grid, kernel) of the case ``name`` on ``device``."""
    if name not in CASES:
        raise ValueError('no walk case %r; cases: %s' % (name, CASES))
    rng = np.random.default_rng(seed)
    dim = 2 if name == 'grid-2d' else 3
    # ~20 particles a cell, as on the paths; the grid covers [0, 1] and
    # particles up to 1.2 clamp into its last cells
    dx = 0.02 if dim == 2 else 0.06
    kernel = {'grid-2d': Gaussian(dim=2), 'four-sources': CubicSpline(dim=3)
              }.get(name, WendlandQuintic(dim=3))
    rs = 3.0 if name == 'grid-2d' else 2.0
    fluid = _state(rng, dim, 0.0, 1.2, dx, dtype, device)
    if name == 'clamped-3d':
        # a corner cell of more particles than one stage of dense_pair
        fluid = _cat(fluid, _state(rng, dim, 1.5, 1.6, dx, dtype, device,
                                   n=cell_walk.STAGE_RECORDS + 150))
    wall = _state(rng, dim - 1, 0.0, 1.2, dx, dtype, device)
    wall['z' if dim == 3 else 'y'][:] = 0.0
    states = {'fluid': fluid, 'wall': wall}
    sources = [('fluid', ALL), ('wall', wp.CONT | wp.MOM)]
    if name == 'four-sources':
        states['obstacle'] = _state(rng, dim, 0.4, 0.7, dx, dtype, device)
        states['tracer'] = _state(rng, dim, 0.0, 1.0, dx, dtype, device,
                                  n=500)
        sources += [('obstacle', wp.CONT), ('tracer', wp.XSPH)]
    dest_name = 'fluid'
    if name == 'empty-dest':
        states['probe'] = _state(rng, dim, 0.0, 1.0, dx, dtype, device, n=0)
        dest_name = 'probe'
    hmax = max(float(s['h'].max()) for s in states.values() if
               s['h'].numel())
    grid = CellGrid(dim, rs, (1, 1, 1))
    width = grid.cell_slack * rs * hmax
    grid._set_dims([int(1.0 // width) + 1 if d < dim else 1
                    for d in range(3)])
    cells = grid.bin_all(states)
    dest = states[dest_name]
    srcs = [(states[s], cells[s], PairSource(s, terms, c0=10.0, alpha=0.1,
                                              beta=0.05, eps=0.5))
            for s, terms in sources]
    terms = 0
    for s, t in sources:
        terms |= t
    nd = dest['x'].shape[0]
    pre = {p: torch.as_tensor(rng.normal(size=nd), dtype=dtype,
                              device=device)
           for p in wp.outputs_for(terms)}
    pre['dt_cfl'] = pre['dt_cfl'].abs()
    wmask = None
    if name != 'four-sources':
        wmask = torch.as_tensor(rng.uniform(size=nd) < 0.8, device=device)
    return (dest, cells[dest_name], wmask, pre, srcs, grid, kernel)


def check_kernel(op, args, tol):
    """Hold ``op`` (``wcsph_pair`` or ``dense_pair``) to the plain version
    on a case's arguments ``args`` (CUDA tensors): one kernel launch and
    one pack launch where the dest has particles, none where it has none;
    every output of the dest's length, within ``tol`` of max|ref|, and
    ``pre`` on rows outside the write mask.  Raises AssertionError;
    returns the largest scaled error."""
    dest, _, wm, pre = args[:4]
    n = dest['x'].shape[0]
    launches, packs = op.launches, cell_pack.pack.launches
    got = op(*args)
    ref = wp.wcsph_pair_reference(*args)
    name = op.__name__
    if op.launches - launches != int(n > 0) or \
            cell_pack.pack.launches - packs != int(n > 0):
        raise AssertionError('%s: %d launches and %d packs for %d dests' % (
            name, op.launches - launches, cell_pack.pack.launches - packs,
            n))
    if set(got) != set(ref):
        raise AssertionError('%s: outputs %s, plain version %s'
                             % (name, sorted(got), sorted(ref)))
    worst = 0.0
    for p in ref:
        if got[p].shape != (n,):
            raise AssertionError('%s: %s has shape %s'
                                 % (name, p, tuple(got[p].shape)))
        if n == 0:
            continue
        scale = float(ref[p].abs().max())
        err = float((got[p] - ref[p]).abs().max())
        worst = max(worst, err / scale)
        if not err <= tol * scale:
            raise AssertionError('%s %s: error %.3g > %.0e * %.3g'
                                 % (name, p, err, tol, scale))
        if wm is not None and not torch.equal(got[p][~wm], pre[p][~wm]):
            raise AssertionError('%s: %s changed outside the write mask'
                                 % (name, p))
    return worst


def _argv(device, dtype):
    return ['-q', '--disable-output', '--device', str(device)] + (
        ['--use-double'] if dtype == torch.float64 else [])


def gtvf_calls(device='cpu', dtype=torch.float64, seed=4, crowd=False,
               dx=0.05):
    """[(eval index, dest, plan, arguments)] of every ``gtvf_pair`` call
    of both evaluators of the GTVF dam break at ``dx``, after one pass of
    each, and then of the wall's EDAC set of the EDAC dam break
    (``--scheme edac``, eval index 2): seeded velocities and transport
    velocities, every fifth row outside the write mask, seeded ``pre``
    values.  With ``crowd``, 300 fluid particles sit far beyond the
    grid's corner, clamped into its corner cell."""
    rng = np.random.default_rng(seed)
    calls = []
    for first, scheme in ((0, 'gtvf'), (2, 'edac')):
        app = DamBreak2D()
        app.setup(['--scheme', scheme, '--dx', str(dx)] +
                  _argv(device, dtype))
        s = app.solver
        for st in s.states.values():
            n = st['x'].shape[0]
            for p in ('u', 'v', 'uhat', 'vhat'):
                st[p] = torch.as_tensor(rng.normal(0.0, 0.5, n),
                                        dtype=dtype, device=device)
            st['tag'][::5] = 1
        if crowd:
            fluid = s.states['fluid']
            for c in 'xy':
                fluid[c] = fluid[c].clone()
                fluid[c][:300] = fluid[c].max() + 10.0 + 0.05 * \
                    torch.as_tensor(rng.uniform(size=300), dtype=dtype,
                                    device=device)
        for a_eval in s.acceleration_evals:
            a_eval.update_and_compute(0.0, s.dt, s.states)
        for k, dest, plan, args in plan_calls(
                s, range(len(s.acceleration_evals))):
            if plan.op is not gp.gtvf_pair:
                continue
            n = args[0]['x'].shape[0]
            pre = {p: torch.as_tensor(rng.normal(size=n), dtype=dtype,
                                      device=device) for p in plan.outputs}
            calls.append((first + k, dest, plan, args[:3] + (pre,) +
                          args[4:]))
    return calls


def fused_case(device='cpu', dtype=torch.float64, seed=8, radius_scale=2.0,
               nx=20):
    """(state, cells, grid, keyword arguments) of one
    ``fused_continuity_momentum`` call on the drop at ``nx`` with seeded
    velocities, pressures and densities, rows of ``h`` 0 and negative,
    100 particles clamped into the grid's corner cell, on cells
    ``radius_scale`` hmax wide."""
    app = EllipticalDrop()
    app.setup(['--nx', str(nx)] + _argv(device, dtype))
    st = dict(app.solver.states['fluid'])
    n = st['x'].shape[0]
    rng = np.random.default_rng(seed)

    def normal(scale):
        return torch.as_tensor(rng.normal(0.0, scale, n), dtype=dtype,
                               device=device)
    st['u'], st['v'], st['p'] = (st['u'] + normal(10.0),
                                 st['v'] + normal(10.0),
                                 st['p'] + normal(100.0))
    st['rho'] = 1.0 + normal(1e-3)
    st['h'] = st['h'].clone()
    st['h'][::37] = 0.0
    st['h'][5::53] = -st['h'][5::53]
    grid = CellGrid.from_particles(app.particles, dim=2,
                                   radius_scale=radius_scale)
    for c in 'xy':
        st[c] = st[c].clone()
        st[c][:100] = st[c].max() + 10.0 + 0.01 * torch.as_tensor(
            rng.uniform(size=100), dtype=dtype, device=device)
    cells = grid.bin_all({'fluid': st})['fluid']
    return st, cells, grid, dict(dim=2, c0=1400.0, alpha=0.1, beta=0.02)
