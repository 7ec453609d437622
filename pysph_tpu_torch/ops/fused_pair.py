"""The fused continuity + momentum pair kernel: wrapper, launch counter
and plain version.

Port of ``pysph_tpu/ops/pallas_pair.py::fused_continuity_momentum``:
``ContinuityEquation`` and the Monaghan ``MomentumEquation`` hand-fused
for one array against itself, with the CubicSpline kernel at
``hij = (hi + hj)/2``, unit mass and a fixed ``c0``; pairs are kept where
``r2 < (2 max(hi, hj))^2`` and both ``h`` are positive.  The outputs are
fresh sums ``(arho, au, av, aw)`` per particle (scale by ``m`` outside).

Where the JAX function takes dense ``(n_cells * M,)`` slot arrays, this
one takes the per-particle state and its ``CellList`` on a ``CellGrid``
whose cells are at least ``2 hmax`` wide (``radius_scale >= 2``).

For CUDA tensors it calls ``csrc/fused_pair.cu`` (built on first use by
``ops/build.py``) once: its launch function packs the array in its cell
order into the ``PACK_RECORDS`` planes (``ops/cell_pack.py``, counted in
``cell_pack.pack.launches``) and then walks it against itself (counted
in ``fused_continuity_momentum.launches``).  For CPU tensors it calls
``fused_continuity_momentum_reference``.
"""

import ctypes
import math

import torch

from pysph_tpu_torch.ops import build, cell_pack
from pysph_tpu_torch.ops.build import data_ptr

PROPS = ('x', 'y', 'z', 'u', 'v', 'w', 'h', 'rho', 'p')
#: record planes of the packed copy (csrc/fused_pair.cu)
PACK_RECORDS = (('x', 'y', 'z', 'h'), ('u', 'v', 'w', None),
                ('rho', 'p', None, None))
#: dest rows per pair-list chunk of the plain version
CHUNK = 16384


def _check_grid(grid):
    if grid.radius_scale < 2.0:
        raise ValueError('fused_continuity_momentum needs cells at least '
                         '2 hmax wide; the grid has radius_scale %g'
                         % grid.radius_scale)


def fused_continuity_momentum_reference(state, cells, grid, dim=3, c0=10.0,
                                        alpha=0.1, beta=0.0, eps_fac=0.01):
    """Plain torch version of ``fused_continuity_momentum``: the same
    arithmetic as ``pallas_pair.py:102-147`` on the pair lists of the
    torch pair engine."""
    _check_grid(grid)
    x = state['x']
    n = x.shape[0]
    sums = [torch.zeros_like(x) for _ in range(4)]
    for a in range(0, n, CHUNK):
        i, j = grid.neighbor_pairs(state, cells, state, cells,
                                   (a, min(n, a + CHUNK)))
        hi, hj = state['h'][i], state['h'][j]
        xij, yij, zij = (state[c][i] - state[c][j] for c in 'xyz')
        r2 = xij * xij + yij * yij + zij * zij
        sup = 2.0 * torch.maximum(hi, hj)
        keep = (r2 < sup * sup) & (hi > 0.0) & (hj > 0.0)
        i, j, hi, hj = i[keep], j[keep], hi[keep], hj[keep]
        xij, yij, zij, r2 = xij[keep], yij[keep], zij[keep], r2[keep]

        rij = torch.sqrt(r2)
        hij = 0.5 * (hi + hj)
        q = rij / hij
        if dim == 3:
            fac = 1.0 / (math.pi * (hij * hij * hij))
        elif dim == 2:
            fac = 10.0 / (7.0 * math.pi * (hij * hij))
        else:
            fac = 2.0 / (3.0 * hij)
        dwdq = torch.where(q <= 1.0, -3.0 * q + 2.25 * q * q,
                           torch.where(q <= 2.0, -0.75 * (2.0 - q) ** 2,
                                       0.0))
        dwdr = fac * dwdq / hij
        near = rij > 1e-12
        rinv = torch.where(near, 1.0 / torch.where(near, rij, 1.0), 0.0)
        dwx, dwy, dwz = (dwdr * c * rinv for c in (xij, yij, zij))

        uij, vij, wij = (state[c][i] - state[c][j] for c in 'uvw')
        vdotx = uij * xij + vij * yij + wij * zij
        vdotdw = uij * dwx + vij * dwy + wij * dwz
        rhoi, rhoj = state['rho'][i], state['rho'][j]
        rhoij = 0.5 * (rhoi + rhoj)
        muij = hij * vdotx / (r2 + eps_fac * hij * hij)
        piij = torch.where(vdotx < 0.0,
                           (-alpha * c0 * muij + beta * muij * muij) / rhoij,
                           0.0)
        pfac = (state['p'][i] / torch.clamp(rhoi * rhoi, min=1e-30) +
                state['p'][j] / torch.clamp(rhoj * rhoj, min=1e-30) + piij)
        for acc, val in zip(sums, (vdotdw, pfac * dwx, pfac * dwy,
                                   pfac * dwz)):
            acc.index_add_(0, i, val)
    arho, au, av, aw = sums
    return arho, -au, -av, -aw


def pack_reference(state, cells):
    """Plain torch version of the kernel's packed copy of ``state``: the
    ``(3, n, 4)`` records of ``PACK_RECORDS`` in the cell order."""
    return cell_pack.pack_reference([(state, cells.order, PACK_RECORDS)])[0]


def pack(state, cells):
    """The packed copy the kernel walks, launched alone
    (``cell_pack.pack``); same result as ``pack_reference``."""
    return cell_pack.pack([(state, cells.order, PACK_RECORDS)])[0]


class _Args(ctypes.Structure):
    _fields_ = [('plane', ctypes.c_void_p * len(PACK_RECORDS)),
                ('cell', ctypes.c_void_p), ('order', ctypes.c_void_p),
                ('cell_start', ctypes.c_void_p),
                ('cell_end', ctypes.c_void_p),
                ('out', ctypes.c_void_p * 4),
                ('c0', ctypes.c_double), ('alpha', ctypes.c_double),
                ('beta', ctypes.c_double), ('eps_fac', ctypes.c_double)] + \
        [(k, ctypes.c_int32) for k in ('n', 'nx', 'ny', 'nz', 'dim',
                                       'dtype')] + \
        [('pack', cell_pack.PackArgs)]


def _launch(state, cells, grid, dim, c0, alpha, beta, eps_fac):
    _check_grid(grid)
    x = state['x']
    dev, fdt, n = x.device, x.dtype, x.shape[0]
    if fdt not in (torch.float32, torch.float64):
        raise ValueError('fused_continuity_momentum: dtype %s' % fdt)
    i32 = torch.int32
    args = _Args()
    out = [torch.empty_like(x) for _ in range(4)]
    if n == 0:
        return tuple(out)
    # the copy's buffer stays referenced until the launch is queued
    buf = cell_pack.fill(args.pack, [(state, cells.order, PACK_RECORDS)],
                         'fused_continuity_momentum')
    for q in range(len(PACK_RECORDS)):
        args.plane[q] = buf.data_ptr() + q * n * 4 * x.element_size()
    args.cell = data_ptr(cells.cell, n, i32, dev, 'cell')
    args.order = data_ptr(cells.order, n, i32, dev, 'order')
    args.cell_start = data_ptr(cells.start, grid.ncells, i32, dev,
                               'cell_start')
    args.cell_end = data_ptr(cells.end, grid.ncells, i32, dev, 'cell_end')
    for k, t in enumerate(out):
        args.out[k] = t.data_ptr()
    args.c0, args.alpha, args.beta, args.eps_fac = c0, alpha, beta, eps_fac
    args.n = n
    args.nx, args.ny, args.nz = grid.dims
    args.dim = dim
    args.dtype = 1 if fdt == torch.float64 else 0
    build.launch('fused_pair', args, dev)
    fused_continuity_momentum.launches += 1
    cell_pack.pack.launches += 1
    return tuple(out)


def fused_continuity_momentum(state, cells, grid, dim=3, c0=10.0, alpha=0.1,
                              beta=0.0, eps_fac=0.01):
    """``(arho, au, av, aw)`` per particle of ``state`` (a dict with the
    ``PROPS`` tensors) against itself, at unit mass.  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    dev = state['x'].device
    if dev.type == 'cpu':
        return fused_continuity_momentum_reference(
            state, cells, grid, dim, c0, alpha, beta, eps_fac)
    if dev.type != 'cuda':
        raise ValueError('fused_continuity_momentum: no kernel for device '
                         '%s' % dev)
    return _launch(state, cells, grid, dim, c0, alpha, beta, eps_fac)


#: kernel launches since the last reset (set to 0 to reset)
fused_continuity_momentum.launches = 0
