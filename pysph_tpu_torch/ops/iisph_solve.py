"""IISPH's iterated pressure group in one launch: wrapper, launch counter
and plain version.

``IISPHScheme`` (``sph/iisph.py``) solves for the pressure with
``Group([ComputeDIJPJ], [PressureSolve(, PressureSolveBoundary)],
iterate=True, min_iterations, max_iterations)`` of one fluid dest: sweeps
of the two sub-groups until the mean compression is within ``tolerance``
of ``rho0`` (``PressureSolve.converged``) and ``min_iterations`` ran, at
most ``max_iterations``.  ``iisph_solve`` runs every sweep of it:

- for CUDA tensors, one launch of ``csrc/iisph_solve.cu`` (a library of
  its own, built on first use by ``ops/build.py``): its launch function
  packs what the sweeps read once (counted in
  ``cell_pack.pack.launches``), then runs the sweeps, the loop condition
  evaluated on the card, reading the pairs from the neighbour list of
  the dest's emitting ``iisph_pair`` launch (its ``Handoff``); counted in
  ``iisph_solve.launches``;
- for CPU tensors, ``iisph_solve_reference``: the same sweeps in torch
  over ``iisph_pair_reference``, ``converged`` read on the host.

Either returns ({output: tensor} for ``OUTPUTS``, the sweeps as a 0-d
int32 tensor on the dest's device).  ``active`` (a 0-d bool tensor, the
solver's chunk flag) runs no sweep where it is false, and ``log`` (a
``ops/sweeps.py::SweepLog``) gets the sweep count of every call that ran.
``iisph_solve_reference(..., pair=iisph_pair)`` on the card is the
per-launch chain the kernel replaces (``iisph_pair``'s ``dijpj`` and
pressure launches on the hand-off, the torch ``post_loop``), which
``chip_smoke.py`` holds the kernel to bit for bit.
"""

import ctypes
from typing import NamedTuple

import torch

from pysph_tpu_torch.base.kernels import kernel_kind
from pysph_tpu_torch.ops import build, cell_pack
from pysph_tpu_torch.ops import iisph_pair as ip
from pysph_tpu_torch.ops.build import data_ptr
from pysph_tpu_torch.ops.sweeps import keep_sweeping

#: the outputs, each the dest's prop (``tmp_comp``: its constant)
OUTPUTS = ('p', 'piter', 'compression', 'dijpj0', 'dijpj1', 'dijpj2',
           'tmp_comp')
_DIJPJ = ('dijpj0', 'dijpj1', 'dijpj2')
#: the kernel kinds the library holds (``kernel_kind``): Gaussian and
#: QuinticSpline, the IISPH runs' kernels
KINDS = (2, 3)
#: the planes the launch packs of the dest ({m rho 0 0}, P[0], D, O; the
#: first the fluid source's plane kMass of csrc/iisph_terms.cuh) and of a
#: wall (its plane kMass, {0 0 V 0})
DEST_PLANES = (('m', 'rho', None, None), ('dii0', 'dii1', 'dii2', 'piter'),
               _DIJPJ + (None,), ('aii', 'rho_adv', 'p', 'compression'))
WALL_PLANES = ((None, None, 'V', None),)


class SolveSpec(NamedTuple):
    """The iterated group's constants: its dest, ``PressureSolve``'s
    ``rho0``, ``omega`` and ``tolerance``, and the group's sweep
    bounds."""
    dest: str
    rho0: float
    omega: float
    tolerance: float
    min_iterations: int
    max_iterations: int


def _check(dest, dijpj, solve, spec):
    """Raise unless ``dijpj`` is ComputeDIJPJ of the dest alone and
    ``solve`` the dest's PressureSolve and at most walls'
    PressureSolveBoundary."""
    if [(ts.name, ts.terms) for _, _, ts in dijpj] != [(spec.dest,
                                                        ip.DIJPJ)]:
        raise ValueError('iisph_solve: ComputeDIJPJ over %s' % [
            (ts.name, ts.terms) for _, _, ts in dijpj])
    terms = {ts.name: ts.terms for _, _, ts in solve}
    if terms.get(spec.dest) != ip.PSOLVE or any(
            t != ip.PSOLVEB for name, t in terms.items()
            if name != spec.dest):
        raise ValueError('iisph_solve: PressureSolve terms %s' % terms)
    if dest['x'].dtype not in (torch.float32, torch.float64):
        raise ValueError('iisph_solve: dtype %s' % dest['x'].dtype)


def _outputs(store):
    return {p: store[p] for p in OUTPUTS}


def iisph_solve_reference(dest, dest_cells, write_mask, dijpj, solve, grid,
                          kernel, dt, spec, handoff=None, active=None,
                          log=None, pair=None):
    """Plain torch version of ``iisph_solve``, the sweeps of the
    evaluator's host loop: each sweep ComputeDIJPJ's ``initialize`` and
    pair sums, PressureSolve's ``initialize``, pair sums, ``post_loop``
    and ``reduce``, each written under the write mask; ``converged`` read
    on the host after a sweep that can stop the loop.  ``pair``: the pair
    call (default ``iisph_pair_reference``; ``iisph_pair`` on the card
    with the ``handoff`` gives the per-launch chain)."""
    _check(dest, dijpj, solve, spec)
    store = dict(dest)
    x = store['x']
    if active is not None and not bool(active):
        return _outputs(store), torch.zeros((), dtype=torch.int32,
                                            device=x.device)

    def put(name, value):
        # ArrayView's write: the value under the mask, the old elsewhere
        col = store[name]
        new = value.to(col.dtype).expand_as(col) if torch.is_tensor(value) \
            else torch.full_like(col, value)
        store[name] = new if write_mask is None else \
            torch.where(write_mask, new, col)

    def sums(sources, outputs):
        srcs = [(store if ts.name == spec.dest else st, cells, ts)
                for st, cells, ts in sources]
        args = (store, dest_cells, write_mask, {p: store[p] for p in outputs},
                srcs, grid, kernel, dt)
        if pair is None:
            return ip.iisph_pair_reference(*args)
        return pair(*args, handoff=handoff)

    rho0, omega = spec.rho0, spec.omega
    it, conv = 0, False
    while keep_sweeping(it, conv, spec.min_iterations, spec.max_iterations):
        for p in _DIJPJ:
            put(p, 0.0)
        store.update(sums(dijpj, _DIJPJ))
        put('p', 0.0)
        put('compression', 0.0)
        store.update(sums(solve, ('p',)))
        # PressureSolve.post_loop
        dt2 = dt * dt
        tmp = rho0 - store['rho_adv'] - store['p'] * dt2
        dnr = store['aii'] * dt2
        ok = torch.abs(dnr) > 1e-9
        safe_dnr = torch.where(ok, dnr, 1.0)
        p = torch.where(
            ok, torch.clamp((1.0 - omega) * store['piter'] +
                            omega / safe_dnr * tmp, min=0.0), 0.0)
        put('compression', torch.where(
            p != 0.0, torch.abs(p * dnr - tmp) + rho0, rho0))
        put('piter', p)
        put('p', p)
        # PressureSolve.reduce
        comp = store['compression']
        mask = write_mask if write_mask is not None else \
            torch.ones_like(comp, dtype=torch.bool)
        count = (mask & (comp > 0)).to(comp.dtype).sum()
        total = torch.where(mask, comp, 0.0).sum()
        tc = store['tmp_comp'].clone()
        tc[0] = count
        tc[1] = total
        store['tmp_comp'] = tc
        it += 1
        if spec.min_iterations <= it < spec.max_iterations:
            # PressureSolve.converged, read on the host
            avg = torch.where(count > 0, total / torch.clamp(count, min=1.0),
                              rho0)
            c = torch.abs(avg - rho0) / rho0
            conv = bool(torch.where(c > spec.tolerance, -1.0, 1.0) > 0)
    if log is not None:
        buf = log.buf
        n = int(buf[0])
        buf[1 + n % (buf.shape[0] - 1)] = it
        buf[0] = n + 1
    return _outputs(store), torch.tensor(it, dtype=torch.int32,
                                         device=x.device)


class _Args(ctypes.Structure):
    _fields_ = ([('cell', ctypes.c_void_p), ('dorder', ctypes.c_void_p),
                 ('wmask', ctypes.c_void_p), ('nbr', ctypes.c_void_p),
                 ('count', ctypes.c_void_p),
                 ('src', (ip._SrcArgs * ip.MAX_SOURCES) * 2),
                 ('pos', ctypes.c_void_p), ('M', ctypes.c_void_p),
                 ('P', ctypes.c_void_p * 2), ('D', ctypes.c_void_p),
                 ('O', ctypes.c_void_p), ('partial', ctypes.c_void_p)] +
                [(p, ctypes.c_void_p) for p in OUTPUTS] +
                [('tmp_comp_pre', ctypes.c_void_p),
                 ('sweeps', ctypes.c_void_p), ('log', ctypes.c_void_p),
                 ('active', ctypes.c_void_p), ('dt_at', ctypes.c_void_p)] +
                [(k, ctypes.c_double) for k in (
                    'dt', 'radius_scale', 'kfac', 'rho0', 'omega',
                    'tolerance')] +
                [('box', ctypes.c_double * 3)] +
                [(k, ctypes.c_int32) for k in (
                    'n_dest', 'n_src', 'nx', 'ny', 'nz', 'dim', 'dtype',
                    'kernel_kind', 'periodic', 'cap', 'min_it', 'max_it',
                    'log_cap', 'blocks', 'tiles')] +
                [('pack', cell_pack.PackArgs)])


def _launch(dest, dest_cells, write_mask, dijpj, solve, grid, kernel, dt,
            spec, handoff, active, log, blocks):
    x = dest['x']
    dev, fdt, n = x.device, x.dtype, x.shape[0]
    kind = kernel_kind(kernel)
    if kind not in KINDS:
        raise ValueError('iisph_solve: no kernel of kind %r (%r); the '
                         'library holds %s' % (kind, kernel, KINDS))
    if handoff is None or handoff.count is None:
        raise ValueError('iisph_solve: no hand-off of an emitting '
                         'iisph_pair launch on the card')
    names = [name for name, _ in handoff.sources]
    if spec.dest not in names:
        raise ValueError('iisph_solve: the hand-off of %s lacks the dest %s'
                         % (names, spec.dest))
    if handoff.buf.dtype != fdt or handoff.buf.device != dev or \
            handoff.nbr.shape[1] != n:
        raise ValueError('iisph_solve: a hand-off for %d dests on %s given '
                         'to a solve of %d dests on %s' % (
                             handoff.nbr.shape[1], handoff.buf.device, n,
                             dev))
    walls = {ts.name: (st, cells, ts) for st, cells, ts in solve
             if ts.name != spec.dest}
    i32 = torch.int32
    args = _Args()
    packs = [(dest, dest_cells.order, DEST_PLANES)] + [
        (st, cells.order, WALL_PLANES) for st, cells, _ in walls.values()]
    buf = cell_pack.fill(args.pack, packs, 'iisph_solve')
    copies = cell_pack.copies(buf, packs)
    own = copies[0]
    other = torch.empty_like(own[1])
    plane0, size = handoff.plane0()
    if handoff.buf.numel() != size:
        raise ValueError('iisph_solve: a hand-off of %d values for copies '
                         'of %d' % (handoff.buf.numel(), size))
    es = x.element_size()
    base = 0
    for k, (name, ns) in enumerate(handoff.sources):
        for q in range(2):
            sa = args.src[q][k]
            sa.plane[0] = handoff.buf.data_ptr() + plane0[k] * es
            sa.base = base
            if name == spec.dest:
                cells, terms = dest_cells, ip.DIJPJ | ip.PSOLVE
                sa.plane[1] = own[0].data_ptr()
                sa.plane[4] = (own[1] if q == 0 else other).data_ptr()
                sa.plane[5] = own[2].data_ptr()
            elif name in walls:
                st, cells, ts = walls[name]
                terms = ip.PSOLVEB
                sa.plane[1] = copies[1 + list(walls).index(name)][0] \
                    .data_ptr()
                sa.rho0 = ts.rho0
            else:
                continue
            if ns != (n if name == spec.dest else st['x'].shape[0]):
                raise ValueError('iisph_solve: the hand-off\'s copy of %s '
                                 'holds %d particles' % (name, ns))
            sa.terms = terms
            sa.cell_start = data_ptr(cells.start, grid.ncells, i32, dev,
                                     'cell_start')
            sa.cell_end = data_ptr(cells.end, grid.ncells, i32, dev,
                                   'cell_end')
        base += ns
    if set(walls) - set(names):
        raise ValueError('iisph_solve: walls %s are not in the hand-off of '
                         '%s' % (sorted(set(walls) - set(names)), names))
    args.pos = args.src[0][names.index(spec.dest)].plane[0]
    args.M = own[0].data_ptr()
    args.P[0], args.P[1] = own[1].data_ptr(), other.data_ptr()
    args.D, args.O = own[2].data_ptr(), own[3].data_ptr()
    partial = torch.empty(2 * max(1, blocks, -(-n // 128)), dtype=fdt,
                          device=dev)
    args.partial = partial.data_ptr()
    args.cell = data_ptr(dest_cells.cell, n, i32, dev, 'dest cell')
    args.dorder = data_ptr(dest_cells.order, n, i32, dev, 'dest order')
    if write_mask is not None:
        args.wmask = data_ptr(write_mask, n, torch.bool, dev, 'write mask')
    args.nbr = data_ptr(handoff.nbr, handoff.nbr.shape[0], i32, dev,
                        'neighbour list', width=n)
    args.count = data_ptr(handoff.count, n, i32, dev, 'counts')
    args.cap = handoff.nbr.shape[0]
    out = {p: torch.empty_like(dest[p]) for p in OUTPUTS}
    for p in OUTPUTS:
        setattr(args, p, out[p].data_ptr())
    pre = dest['tmp_comp']
    if pre.shape != (2,) or pre.dtype != fdt or pre.device != dev or \
            not pre.is_contiguous():
        raise ValueError('iisph_solve: tmp_comp must be 2 contiguous %s '
                         'values on %s' % (fdt, dev))
    args.tmp_comp_pre = pre.data_ptr()
    for p in OUTPUTS[:-1]:
        data_ptr(dest[p], n, fdt, dev, 'd_' + p)
    sweeps = torch.empty((), dtype=i32, device=dev)
    args.sweeps = sweeps.data_ptr()
    if log is not None:
        if log.buf.device != dev:
            raise ValueError('iisph_solve: a sweep log on %s' %
                             log.buf.device)
        args.log = log.buf.data_ptr()
        args.log_cap = log.buf.shape[0] - 1
    if active is not None:
        if active.dtype != torch.bool or active.device != dev or \
                active.numel() != 1:
            raise ValueError('iisph_solve: active must be a bool scalar '
                             'tensor on %s' % dev)
        args.active = active.data_ptr()
    if torch.is_tensor(dt):
        args.dt_at = ip.device_dt(dt, dev, 'iisph_solve')
    else:
        args.dt = float(dt)
    args.radius_scale = grid.radius_scale
    args.kfac = kernel.fac
    args.rho0, args.omega = spec.rho0, spec.omega
    args.tolerance = spec.tolerance
    args.min_it, args.max_it = spec.min_iterations, spec.max_iterations
    lengths = grid.box_host(fdt)['lengths']
    for d, per in enumerate(grid.periodic):
        args.box[d] = lengths[d] if per else 0.0
    args.periodic = grid.is_periodic
    args.n_dest, args.n_src = n, len(handoff.sources)
    args.nx, args.ny, args.nz = grid.dims
    args.dim = kernel.dim
    args.dtype = 1 if fdt == torch.float64 else 0
    args.kernel_kind = kind
    args.blocks = blocks
    if n:
        build.launch('iisph_solve', args, dev)
        iisph_solve.launches += 1
        cell_pack.pack.launches += 1
    return out, sweeps


def iisph_solve(dest, dest_cells, write_mask, dijpj, solve, grid, kernel,
                dt, spec, handoff, active=None, log=None, blocks=0):
    """The sweeps of the iterated group ``spec`` (a ``SolveSpec``) of the
    dest's state ``dest`` (its ``CellList`` ``dest_cells``; the group's
    ``write_mask``, bool rows or None): ``dijpj`` and ``solve`` are the
    (state, ``CellList``, ``IisphSource``) of ComputeDIJPJ's and of
    PressureSolve's calls (the dest's own source the dest), ``grid``
    their ``CellGrid``, ``dt`` the step's (a float or a float64 0-d
    tensor on the card), ``handoff`` the ``Handoff`` of the dest's
    emitting ``iisph_pair`` launch; ``active`` and ``log`` as the module
    says; ``blocks``: the grid of the launch (0: as many as fit, for
    tests).  Returns (outputs, sweeps).  CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise where it refuses
    (a kind it lacks, a grid over what fits on the card)."""
    dev = dest['x'].device
    if dev.type == 'cpu':
        return iisph_solve_reference(dest, dest_cells, write_mask, dijpj,
                                     solve, grid, kernel, dt, spec, handoff,
                                     active, log)
    if dev.type != 'cuda':
        raise ValueError('iisph_solve: no kernel for device %s' % dev)
    _check(dest, dijpj, solve, spec)
    return _launch(dest, dest_cells, write_mask, dijpj, solve, grid, kernel,
                   dt, spec, handoff, active, log, blocks)


#: kernel launches since the last reset (set to 0 to reset)
iisph_solve.launches = 0
