"""The gas-dynamics pair kernel: wrapper, launch counter and plain version.

``gasd_pair`` runs the pair terms of one dest array over all its sources
(at most ``MAX_SOURCES``) in one call, for one of the two phase sets of
``GasDScheme``'s MPM groups (``sph/gas_dynamics/basic.py``: the shock
tube and the Sedov blast of ``examples/gas_dynamics/``):

==========  ==============================================  =============
phase set   terms (equations)                               outputs
==========  ==============================================  =============
DENSITY     SDEN (``SummationDensity``): WI, DWI, GHI at    rho arho
            the dest's h                                    grhox-z dwdh
MOMENTUM    MPM (``MPMAccelerations``): DWI, DWJ, DWIJ at   au av aw ae
            the dest's, the source's and the mean h         del2e dt_cfl
==========  ==============================================  =============

Each output is ``pre + sum`` (``dt_cfl``: ``max(pre, max over pairs)``)
on rows under the write mask and ``pre`` elsewhere; every read sees the
value from before the phase.  h varies per particle: a pair is in support
where ``r < radius_scale max(hi, hj)``.  Every kernel with a
``kernel_kind`` (``csrc/shapes.cuh``; the scheme's default is the
Gaussian, kind 2; not the ``_1D`` kernels, ROADMAP Queue 1 item 28); the
grid may be periodic.  ``counts=True`` adds ``nnbr``, each dest's pairs
in support (int32), to the result.

For CUDA tensors it calls ``csrc/gasd_pair.cu`` (a library of its own,
built on first use by ``ops/build.py``) once: its launch function
launches the source pack (``ops/cell_pack.py``, counted in
``cell_pack.pack.launches``) and then the kernel (counted in
``gasd_pair.launches``; each later kind a library of its own, built at its
first launch); a kernel without a ``kernel_kind``, a dtype other than
float32 and float64, or a refused launch raises.  For CPU tensors it
calls ``gasd_pair_reference``, the torch pair engine running the same
``Equation`` objects on the exact lists of ``CellGrid.neighbor_pairs``.
No neighbour list is carried from one call to the next: the density
iteration changes h and re-bins every sweep.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from pysph_tpu_torch.base.kernels import kernel_kind
from pysph_tpu_torch.ops import build, cell_pack
from pysph_tpu_torch.ops.build import data_ptr

SDEN, MPM = 1, 2
#: phase sets, indexed by the phase id of the CUDA kernel
PHASE_SETS = (SDEN, MPM)
DENSITY, MOMENTUM = range(2)
MAX_SOURCES = 4
OUTPUTS = ('rho', 'arho', 'grhox', 'grhoy', 'grhoz', 'dwdh', 'au', 'av',
           'aw', 'ae', 'del2e', 'dt_cfl')
TERM_OUTPUTS = {SDEN: OUTPUTS[:6], MPM: OUTPUTS[6:]}

_VEL = ('u', 'v', 'w')
#: props each set reads beyond x, y, z, h: (dest, source)
_SET_READS = {
    SDEN: (_VEL, _VEL + ('m',)),
    MPM: (_VEL + ('rho', 'p', 'cs', 'e', 'omega', 'alpha1', 'alpha2'),
          _VEL + ('m', 'rho', 'p', 'cs', 'e', 'omega', 'alpha1',
                  'alpha2'))}
_DEST_PROPS = ('x', 'y', 'z', 'h') + _VEL + (
    'rho', 'p', 'cs', 'e', 'omega', 'alpha1', 'alpha2')
#: record planes of the packed copy (csrc/gasd_pair.cu): the density set
#: packs planes 0 and 1, the momentum set all four
PACK_RECORDS = (('x', 'y', 'z', 'h'), ('u', 'v', 'w', 'm'),
                ('rho', 'p', 'cs', 'e'), ('omega', 'alpha1', 'alpha2', None))


class GasdSource(NamedTuple):
    """One source of a dest's phase set: its term mask, the ``Equation``
    objects the terms stand for (the plain version runs them) and
    ``MPMAccelerations``' ``beta``."""
    name: str
    terms: int
    equations: tuple
    beta: float = 0.0


def phase_of(terms):
    """The phase id of the set ``terms`` is, or None."""
    return PHASE_SETS.index(terms) if terms in PHASE_SETS else None


@functools.lru_cache(maxsize=None)
def _reads(terms, side):
    return frozenset(('x', 'y', 'z', 'h') + _SET_READS[terms][side])


def pack_layout(terms):
    """(slots, planes): the ``PACK_RECORDS`` planes a source of the set
    ``terms`` packs, and their prop names (``cell_pack.layout``)."""
    return cell_pack.layout(PACK_RECORDS, _reads(terms, 1))


def _packs(sources):
    return [(src, cells.order, pack_layout(gs.terms)[1])
            for src, cells, gs in sources]


def pack_sources_reference(sources):
    """Plain torch version of ``pack_sources``: for each (state,
    ``CellList``, ``GasdSource``) of a call, the ``(planes, n, 4)``
    records of its planes gathered through the cell order."""
    return cell_pack.pack_reference(_packs(sources))


def pack_sources(sources):
    """The packed copy of every source of a ``gasd_pair`` call; same
    arguments and result as ``pack_sources_reference``.  CPU tensors
    take the plain version; CUDA tensors launch ``csrc/cell_pack.cu``."""
    return cell_pack.pack(_packs(sources))


def _phase(sources):
    terms = {gs.terms for _, _, gs in sources}
    phase = phase_of(terms.pop()) if len(terms) == 1 else None
    if phase is None or not sources:
        raise ValueError('gasd_pair: sources of terms %s are not one phase '
                         'set' % sorted(gs.terms for _, _, gs in sources))
    return phase


def neighbour_counts(dest, dest_cells, sources, grid):
    """Each dest's pairs in support over the call's sources (int32): the
    plain version of the kernel's ``count``."""
    n = dest['x'].shape[0]
    out = torch.zeros(n, dtype=torch.int64, device=dest['x'].device)
    for src, cells, _ in sources:
        i, _ = grid.neighbor_pairs(dest, dest_cells, src, cells, (0, n))
        out += torch.bincount(i, minlength=n)
    return out.to(torch.int32)


def gasd_pair_reference(dest, dest_cells, write_mask, pre, sources, grid,
                        kernel, counts=False):
    """Plain torch version of ``gasd_pair``: the torch pair engine
    running each source's equations on the exact lists (wrapped, with
    minimum images, on a periodic grid).

    ``dest``: state dict of the dest array; ``dest_cells``: its
    ``CellList``; ``write_mask``: bool rows or None; ``pre``: {output:
    value before the phase}; ``sources``: [(state, CellList,
    GasdSource)]; ``grid``: the ``CellGrid`` of the cell lists;
    ``counts``: add ``nnbr``.  Returns {output: tensor}."""
    from pysph_tpu_torch.sph.acceleration_eval import run_pair_phase
    _phase(sources)
    store = dict(dest)
    store.update(pre)
    for src, src_cells, gs in sources:
        run_pair_phase(list(gs.equations), store, src, dest_cells,
                       src_cells, grid, kernel, write_mask, 0.0, 0.0)
    out = {p: store[p] for p in pre}
    if counts:
        out['nnbr'] = neighbour_counts(dest, dest_cells, sources, grid)
    return out


class _SrcArgs(ctypes.Structure):
    _fields_ = [('plane', ctypes.c_void_p * len(PACK_RECORDS)),
                ('cell_start', ctypes.c_void_p),
                ('cell_end', ctypes.c_void_p),
                ('beta', ctypes.c_double),
                ('terms', ctypes.c_int32), ('pad', ctypes.c_int32)]


class _Args(ctypes.Structure):
    _fields_ = ([(p, ctypes.c_void_p) for p in _DEST_PROPS] +
                [('cell', ctypes.c_void_p), ('dorder', ctypes.c_void_p),
                 ('wmask', ctypes.c_void_p),
                 ('pre', ctypes.c_void_p * len(OUTPUTS)),
                 ('out', ctypes.c_void_p * len(OUTPUTS)),
                 ('count', ctypes.c_void_p),
                 ('src', _SrcArgs * MAX_SOURCES),
                 ('radius_scale', ctypes.c_double),
                 ('kfac', ctypes.c_double), ('box', ctypes.c_double * 3)] +
                [(k, ctypes.c_int32) for k in (
                    'n_dest', 'n_src', 'nx', 'ny', 'nz', 'dim', 'phase',
                    'dtype', 'kernel_kind', 'periodic')] +
                [('pack', cell_pack.PackArgs)])


def _launch(dest, dest_cells, write_mask, pre, sources, grid, kernel,
            counts):
    x = dest['x']
    dev, fdt, n = x.device, x.dtype, x.shape[0]
    if fdt not in (torch.float32, torch.float64):
        raise ValueError('gasd_pair: dtype %s' % fdt)
    if len(sources) > MAX_SOURCES:
        raise ValueError('gasd_pair: %d sources' % len(sources))
    kind = kernel_kind(kernel)
    if kind is None:
        raise ValueError('gasd_pair: no shape function for %r (1D kernels: '
                         'ROADMAP Queue 1 item 28)' % kernel)
    phase = _phase(sources)
    terms = PHASE_SETS[phase]
    if set(pre) != set(TERM_OUTPUTS[terms]):
        raise ValueError('gasd_pair: pre values for %s, the set gives %s'
                         % (sorted(pre), TERM_OUTPUTS[terms]))
    i32 = torch.int32
    args = _Args()
    packs = _packs(sources)
    # the copies' buffer stays referenced until the launch is queued
    buf = cell_pack.fill(args.pack, packs, 'gasd_pair')
    slots = pack_layout(terms)[0]
    for k, (src, cells, gs) in enumerate(sources):
        sa, c = args.src[k], args.pack.src[k]
        plane = c.n * 4 * x.element_size()
        for q, s in enumerate(slots):
            sa.plane[s] = c.out + q * plane
        sa.cell_start = data_ptr(cells.start, grid.ncells, i32, dev,
                                 'cell_start')
        sa.cell_end = data_ptr(cells.end, grid.ncells, i32, dev, 'cell_end')
        sa.beta = gs.beta
        sa.terms = gs.terms
    for p in _reads(terms, 0):
        setattr(args, p, data_ptr(dest[p], n, fdt, dev, 'd_' + p))
    args.cell = data_ptr(dest_cells.cell, n, i32, dev, 'dest cell')
    args.dorder = data_ptr(dest_cells.order, n, i32, dev, 'dest order')
    if write_mask is not None:
        args.wmask = data_ptr(write_mask, n, torch.bool, dev, 'write mask')
    out = {}
    for k, p in enumerate(OUTPUTS):
        if p in pre:
            args.pre[k] = data_ptr(pre[p], n, fdt, dev, 'pre ' + p)
            out[p] = torch.empty_like(pre[p])
            args.out[k] = out[p].data_ptr()
    if counts:
        out['nnbr'] = torch.empty(n, dtype=i32, device=dev)
        args.count = out['nnbr'].data_ptr()
    args.radius_scale = grid.radius_scale
    args.kfac = kernel.fac
    # the box lengths of the periodic axes, each the dtype's value
    lengths = grid.box_host(fdt)['lengths']
    for d, per in enumerate(grid.periodic):
        args.box[d] = lengths[d] if per else 0.0
    args.periodic = grid.is_periodic
    args.n_dest, args.n_src = n, len(sources)
    args.nx, args.ny, args.nz = grid.dims
    args.dim = kernel.dim
    args.phase = phase
    args.dtype = 1 if fdt == torch.float64 else 0
    args.kernel_kind = kind
    if n:
        build.launch('gasd_pair', args, dev)
        gasd_pair.launches += 1
        cell_pack.pack.launches += bool(args.pack.n_src)
    return out


def gasd_pair(dest, dest_cells, write_mask, pre, sources, grid, kernel,
              counts=False):
    """Pair terms of one dest over its sources; same arguments and
    result as ``gasd_pair_reference``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    dev = dest['x'].device
    if dev.type == 'cpu':
        return gasd_pair_reference(dest, dest_cells, write_mask, pre,
                                   sources, grid, kernel, counts)
    if dev.type != 'cuda':
        raise ValueError('gasd_pair: no kernel for device %s' % dev)
    return _launch(dest, dest_cells, write_mask, pre, sources, grid, kernel,
                   counts)


#: kernel launches since the last reset (set to 0 to reset)
gasd_pair.launches = 0
