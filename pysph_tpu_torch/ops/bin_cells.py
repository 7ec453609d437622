"""The cell binning kept Verlet-style: the reuse test and the binning it
gates, as one call; wrapper, launch counter and plain version.

``bin_cells(grid, states, handle, force, active)`` tests whether the
binning in ``handle`` (a ``base/cell_grid.py::GridHandle`` of the arrays
``states``) still holds for the states' positions, as
``pysph_tpu/sph/acceleration_eval.py::prepare_reuse`` does: it is stale
when some particle has moved more than half the slack margin since it
was binned, ``disp2 > (0.5 (cell_slack - 1) radius_scale hmax)^2``, or
when ``cell_slack radius_scale hmax > width * 1.0001`` (h grew).  The
flag ``rebuild`` is ``force or stale``, and ``active`` where a 0-d bool
``active`` is given (the solver's chunk passes its step's flag, so an
inactive step bins nothing).  Where the flag is set the handle is binned
afresh in place (origin, width, overflow, each array's cell, order,
start and end, and the reference positions), where it is not the handle
stays as it was, bit for bit.  Nothing is read back: the flag is a 0-d
bool tensor on the states' device (``handle.rebuild``), returned.  A
position or h that is not finite is never binned: there (where active)
the flag is 0 and the grid's ``nonfinite`` flag (``CellGrid.
nonfinite_flag``) is set, which the solver reads with what it reads
anyway and turns into ``FloatingPointError`` (``CellGrid.check_finite``).
``order`` is the stable sort's by cell id (ascending indices within a
cell), whatever a cell holds.

CUDA tensors launch ``csrc/bin_cells.cu`` (six kernels, each gated by
the flag on the card, from one host call) and count the call in
``bin_cells.launches``; CPU tensors take ``bin_cells_reference``, which
computes everything and keeps the old values with ``torch.where``, so
that it too never reads the flag.  A failed build or launch raises.
"""

import ctypes

import torch

from pysph_tpu_torch.ops import build
from pysph_tpu_torch.ops.build import data_ptr

#: arrays of one binning at most (csrc/bin_cells.cu kMaxArrays)
MAX_ARRAYS = 8
#: rows of the kernel's partials (csrc/bin_cells.cu kReduceBlocks)
REDUCE_BLOCKS = 264
#: values of a partial row (csrc/bin_cells.cu kValues)
VALUES = 9


def bin_cells_reference(grid, states, handle, force=False, active=None):
    """Plain torch version of ``bin_cells`` (same arguments and result):
    the test, then a fresh binning (``CellGrid.bin``), then every tensor
    of the handle set to ``torch.where(rebuild, new, old)``."""
    live = [(name, s) for name, s in states.items() if s['x'].numel()]
    nonfinite = ~torch.stack([torch.isfinite(torch.stack([s[p] for p in
                                                          'xyzh'])).all()
                              for _, s in live]).all()
    bad = nonfinite
    lo, hi, hmax = grid._box(s for _, s in live)
    disp2 = torch.stack([_disp2(grid, s, handle.ref[name])
                         for name, s in live]).max()
    slack_rs = grid.cell_slack * grid.radius_scale
    width = slack_rs * hmax
    margin = grid.half_margin() * hmax
    stale = (disp2 > margin * margin) | \
        (width > grid.stale_width(handle.width) * 1.0001)
    rebuild = torch.ones_like(stale) if force else stale
    if active is not None:
        rebuild = rebuild & active
        bad = bad & active
    flag = grid.nonfinite_flag(bad.device)
    flag.copy_(flag | bad)
    rebuild = rebuild & ~bad
    origin = grid.origin(lo)
    overflow = grid.escaped(origin, hi, width)
    # what a state that is not finite would bin is dropped below (also
    # where ``active`` is false); its values are made finite first only
    # so that the ids index the cells
    width_ok = torch.where(nonfinite & ~(width > 0), torch.ones_like(width),
                           width)
    for name, s in states.items():
        new = grid.bin({c: torch.nan_to_num(s[c], 0.0, 0.0, 0.0)
                        for c in 'xyz'}, torch.nan_to_num(origin, 0.0, 0.0,
                                                          0.0), width_ok)
        for old, value in zip(handle.lists[name], new):
            old.copy_(torch.where(rebuild, value, old))
        ref = handle.ref[name]
        ref.copy_(torch.where(rebuild, torch.stack([s['x'], s['y'], s['z']]),
                              ref))
    for old, value in ((handle.origin, origin), (handle.width, width),
                       (handle.overflow, overflow)):
        old.copy_(torch.where(rebuild, value, old))
    handle.rebuild.copy_(rebuild)
    return handle.rebuild


def _disp2(grid, state, ref):
    dx = grid.image(0, state['x'] - ref[0])
    dy = grid.image(1, state['y'] - ref[1])
    dz = grid.image(2, state['z'] - ref[2])
    return (dx * dx + dy * dy + dz * dz).max()


class _Array(ctypes.Structure):
    _fields_ = [(k, ctypes.c_void_p) for k in (
        'x', 'y', 'z', 'h', 'ref', 'cell', 'order', 'start', 'end',
        'count', 'tmp', 'listed', 'nlisted')] + [('n', ctypes.c_int32),
                                                 ('pad', ctypes.c_int32)]


class BinArgs(ctypes.Structure):
    _fields_ = [('arr', _Array * MAX_ARRAYS)] + \
        [(k, ctypes.c_void_p) for k in ('origin', 'width', 'overflow',
                                        'rebuild', 'active', 'partial',
                                        'ticket', 'nonfinite')] + \
        [('slack_rs', ctypes.c_double), ('half_margin', ctypes.c_double),
         ('pmin', ctypes.c_double * 3), ('plen', ctypes.c_double * 3),
         ('pwidth', ctypes.c_double * 3), ('stale', ctypes.c_double)] + \
        [(k, ctypes.c_int32) for k in ('n_arr', 'dtype', 'force', 'nx', 'ny',
                                       'nz', 'ncells', 'open_axis')] + \
        [('per', ctypes.c_int32 * 3), ('pad', ctypes.c_int32)]


def _scratch(handle):
    """The kernel's scratch of ``handle``, made at its first launch: each
    array's per-cell counts, the list of the cells that ``bin_sort`` does
    not sort itself, its two counts and the long cells' sorting copy
    ({name: (count, listed, nlisted, tmp)}), the partials and the ticket
    (0 between launches)."""
    if handle.scratch is None:
        dev = handle.width.device
        i32 = torch.int32
        handle.scratch = (
            {name: (torch.zeros(handle.ncells, dtype=i32, device=dev),
                    torch.zeros(handle.ncells, dtype=i32, device=dev),
                    torch.zeros(2, dtype=i32, device=dev),
                    torch.zeros(n, dtype=i32, device=dev))
             for name, n in zip(handle.names, handle.sizes)},
            torch.zeros(REDUCE_BLOCKS * VALUES, dtype=torch.float64,
                        device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
    return handle.scratch


def _launch(grid, states, handle, force, active):
    x = next(iter(states.values()))['x']
    dev, fdt = x.device, x.dtype
    if fdt not in (torch.float32, torch.float64):
        raise ValueError('bin_cells: dtype %s' % fdt)
    if len(states) > MAX_ARRAYS:
        raise ValueError('bin_cells: %d arrays (at most %d)'
                         % (len(states), MAX_ARRAYS))
    if not handle.fits(grid, states):
        raise ValueError('bin_cells: the handle does not fit the grid and '
                         'the states')
    counts, partial, ticket = _scratch(handle)
    i32, ncells = torch.int32, grid.ncells
    args = BinArgs()
    for k, (name, s) in enumerate(states.items()):
        a, n = args.arr[k], s['x'].shape[0]
        for p in 'xyzh':
            setattr(a, p, data_ptr(s[p], n, fdt, dev, '%s.%s' % (name, p)))
        a.ref = data_ptr(handle.ref[name].view(-1), 3 * n, fdt, dev, 'ref')
        cl = handle.lists[name]
        a.cell = data_ptr(cl.cell, n, i32, dev, 'cell')
        a.order = data_ptr(cl.order, n, i32, dev, 'order')
        a.start = data_ptr(cl.start, ncells, i32, dev, 'start')
        a.end = data_ptr(cl.end, ncells, i32, dev, 'end')
        count, listed, nlisted, tmp = counts[name]
        a.count = data_ptr(count, ncells, i32, dev, 'count')
        a.listed = listed.data_ptr()
        a.nlisted = nlisted.data_ptr()
        a.tmp = tmp.data_ptr()
        a.n = n
    args.origin = data_ptr(handle.origin, 3, fdt, dev, 'origin')
    args.width = data_ptr(handle.width.view(1), 1, fdt, dev, 'width')
    args.overflow = data_ptr(handle.overflow.view(1), 1, torch.bool, dev,
                             'overflow')
    args.rebuild = data_ptr(handle.rebuild.view(1), 1, torch.bool, dev,
                            'rebuild')
    if active is not None:
        args.active = data_ptr(active.reshape(1), 1, torch.bool, dev,
                               'active')
    args.partial = partial.data_ptr()
    args.ticket = ticket.data_ptr()
    args.nonfinite = data_ptr(grid.nonfinite_flag(dev).view(1), 1,
                              torch.bool, dev, 'nonfinite')
    args.slack_rs = grid.cell_slack * grid.radius_scale
    args.half_margin = grid.half_margin()
    args.n_arr = len(states)
    args.dtype = 1 if fdt == torch.float64 else 0
    args.force = int(bool(force))
    args.nx, args.ny, args.nz = grid.dims
    args.ncells = ncells
    # the periodic geometry, each value the dtype's (box_consts)
    box = grid.box_host(fdt)
    for d, per in enumerate(grid.periodic):
        args.per[d] = per
        args.pmin[d] = box['mins'][d]
        args.plen[d] = box['lengths'][d]
        args.pwidth[d] = box['widths'][d]
    args.stale = box['stale']
    args.open_axis = not all(grid.periodic[:grid.dim])
    build.launch('bin_cells', args, dev)
    bin_cells.launches += 1
    return handle.rebuild


def bin_cells(grid, states, handle, force=False, active=None):
    """Test the binning of ``handle`` against ``states`` ({name: state}
    of the handle's arrays, in its order) on ``grid`` and rebuild it in
    place where the flag says so (module docstring).  Returns the flag,
    a 0-d bool tensor on the states' device.  CPU tensors take the plain
    version; CUDA tensors launch the kernels."""
    if not any(s['x'].numel() for s in states.values()):
        raise ValueError('bin_cells: no particles to bin')
    dev = next(iter(states.values()))['x'].device
    if dev.type == 'cpu':
        return bin_cells_reference(grid, states, handle, force, active)
    if dev.type != 'cuda':
        raise ValueError('bin_cells: no kernel for device %s' % dev)
    return _launch(grid, states, handle, force, active)


#: kernel launches since the last reset (set to 0 to reset): one a call
#: (its six gated kernels)
bin_cells.launches = 0
