"""The TVF pair kernel: wrapper, launch counter and plain version.

``tvf_pair`` runs the pair terms of one dest array over all its sources
(at most ``MAX_SOURCES``) in one call, for one of the two phase sets of
``TVFScheme``'s and ``EDACScheme``'s groups (the Taylor-Green vortex's
path, the wall examples', the EDAC dam break's).  A per-source term mask
says which equations a source takes:

==========  ============================================  ============
phase set   terms (equations)                             outputs
==========  ============================================  ============
DENSITY     SDEN (``SummationDensity``),                  V rho
            AVGP (EDAC's ``ComputeAveragePressure``)      pavg nnbr
MOMENTUM    MPG (``MomentumEquationPressureGradient``),   au av aw
            VISC (``MomentumEquationViscosity``),         auhat avhat
            MAS (``MomentumEquationArtificialStress``),   awhat
            AVIS (``MomentumEquationArtificialViscosity``),
            NOSLIP (``SolidWallNoSlipBC``),
            EMPG (EDAC's ``MomentumEquationPressureGradient``,
            ``p - pavg``), EMOM (EDAC's ``MomentumEquation``),
            EDACEQ (``EDACEquation``)                     ap
            XSPH (``XSPHCorrection``)                     ax ay az
==========  ============================================  ============

(the equations of ``sph/wc/transport_velocity.py`` and
``sph/wc/edac.py``; ``TVFScheme`` gives a wall source MPG and NOSLIP,
whose ghost velocity ``ug vg wg`` is a plane of its own).  Each output
is ``pre + sum`` on rows under the write mask and ``pre`` elsewhere;
every read sees the value from before the phase.  Any kernel of
``kernel_kind`` (``QuinticSpline`` on the path).  The EDAC terms
(``EDAC_TERMS``) are built into instantiations of their own, in a
library of their own built at their first launch (``EDAC_FLAGS``), so
that a path that runs none of them builds and runs the code it did
before them.

The grid may be periodic (``base/cell_grid.py``): the kernel then walks
the wrapped stencil and takes the minimum image of every displacement
(``csrc/cell_walk.cuh::walk_rows_periodic``, built as a template flag,
so the kernel on an open grid keeps the plain walk).

The linked pair.  Where the momentum group of a dest follows its
density group with the same sources and nothing between them moves ``x
y z h`` (``ops/pair_engine.py::link_pairs``), the two plans share a
``Link`` (``ops/pair_link.py``; with ``EDACScheme``'s walls the
mean-pressure plan between them, AVGP alone, consumes too): the density
call runs with
``emit=True`` and returns, beside its output, a ``Handoff``: its
sources' packed ``{x y z h}`` copies and the neighbour list, up to
``CAPACITY[dim]`` entries a dest.  The momentum call takes it
(``handoff=``): it packs only the planes 1-4 (fresh after the density,
EOS and wall groups: the wall's ``p``, ``rho`` and ``ug`` change
between the two calls) and reads the listed records instead of
walking, so its sums are the walk's bit for bit; a warp holding a dest
past the capacity walks.  The density launch counts such dests on the card
(``overflowed``).  A linked momentum plan run without its hand-off
raises.

For CUDA tensors it calls ``csrc/tvf_pair.cu`` (built on first use by
``ops/build.py``) once: its launch function launches the source pack
(``ops/cell_pack.py``, counted in ``cell_pack.pack.launches``; each
source packs the ``PACK_RECORDS`` planes its terms read, a consuming
call all but plane 0) and then the kernel (counted in
``tvf_pair.launches``).  For CPU tensors it calls
``tvf_pair_reference``, the torch pair engine running the same
``Equation`` objects on the exact lists of ``CellGrid.neighbor_pairs``,
which walks for the momentum call too: an emitting call returns an
empty hand-off.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from pysph_tpu_torch.base.kernels import kernel_kind
from pysph_tpu_torch.ops import build, cell_pack, pair_link
from pysph_tpu_torch.ops.build import data_ptr
from pysph_tpu_torch.ops.pair_link import CAPACITY, Handoff

SDEN, MPG, VISC, MAS, AVIS, NOSLIP, AVGP, EMPG, EMOM, EDACEQ, XSPH = (
    1 << k for k in range(11))
#: phase sets, indexed by the phase id of the CUDA kernel
PHASE_SETS = (SDEN | AVGP,
              MPG | VISC | MAS | AVIS | NOSLIP | EMPG | EMOM | EDACEQ | XSPH)
#: the terms of EDACScheme, built into instantiations of their own (the
#: library of the flags EDAC_FLAGS, csrc/tvf_pair.cu TVF_EDAC)
EDAC_TERMS = AVGP | EMPG | EMOM | EDACEQ | XSPH
EDAC_FLAGS = ('-DTVF_EDAC',)
DENSITY, MOMENTUM = 0, 1
#: the kernel's modes (csrc/tvf_pair.cu kWalk, kEmit, kConsume)
WALK, EMIT, CONSUME = 0, 1, 2
MAX_SOURCES = 4
OUTPUTS = ('V', 'rho', 'au', 'av', 'aw', 'auhat', 'avhat', 'awhat', 'pavg',
           'nnbr', 'ap', 'ax', 'ay', 'az')
_ACC = ('au', 'av', 'aw')
_ACCHAT = _ACC + ('auhat', 'avhat', 'awhat')
TERM_OUTPUTS = {SDEN: ('V', 'rho'), MPG: _ACCHAT, VISC: _ACC, MAS: _ACC,
                AVIS: _ACC, NOSLIP: _ACC, AVGP: ('pavg', 'nnbr'),
                EMPG: _ACCHAT, EMOM: _ACC, EDACEQ: ('ap',),
                XSPH: ('ax', 'ay', 'az')}

# props each term reads beyond x, y, z, h: (dest, source)
_VEL = ('u', 'v', 'w')
_HAT = ('uhat', 'vhat', 'what')
_TERM_READS = {
    SDEN: (('m',), ()),
    MPG: (('m', 'rho', 'p', 'V'), ('rho', 'p', 'V')),
    VISC: (('m', 'rho', 'V') + _VEL, ('rho', 'V') + _VEL),
    MAS: (('m', 'rho', 'V') + _VEL + _HAT, ('rho', 'V') + _VEL + _HAT),
    AVIS: (('rho',) + _VEL, ('m', 'rho') + _VEL),
    NOSLIP: (('m', 'rho', 'V') + _VEL, ('rho', 'V', 'ug', 'vg', 'wg')),
    AVGP: ((), ('p',)),
    EMPG: (('m', 'rho', 'p', 'V', 'pavg'), ('rho', 'p', 'V')),
    EMOM: (('m', 'rho', 'p', 'V'), ('rho', 'p', 'V')),
    EDACEQ: (('m', 'rho', 'p', 'V') + _VEL, ('m', 'rho', 'p', 'V') + _VEL),
    XSPH: (('rho',) + _VEL, ('m', 'rho') + _VEL)}
_DEST_PROPS = ('x', 'y', 'z', 'h', 'm', 'rho', 'p', 'V') + _VEL + _HAT + (
    'pavg',)
#: record planes of the packed copy (csrc/tvf_pair.cu): the density
#: launch packs plane 0 (and plane 1 for AVGP's p), the momentum launch
#: planes 0 to 4, each where the source's terms read one of its props
#: (plane 4, the wall's ghost velocity, for NOSLIP alone)
PACK_RECORDS = (('x', 'y', 'z', 'h'), ('m', 'rho', 'p', 'V'),
                ('u', 'v', 'w', None), ('uhat', 'vhat', 'what', None),
                ('ug', 'vg', 'wg', None))


class TvfSource(NamedTuple):
    """One source of a dest's phase set: its term mask, the ``Equation``
    objects the terms stand for (the plain version runs them) and their
    constants: MPG's (or EMPG's) background pressure ``pb``, VISC's
    ``nu``, AVIS's ``alpha`` and ``c0``, NOSLIP's ``noslip_nu``,
    EDACEQ's ``cs`` and ``edac_nu``, XSPH's ``eps``."""
    name: str
    terms: int
    equations: tuple
    pb: float = 0.0
    nu: float = 0.0
    alpha: float = 0.0
    c0: float = 0.0
    noslip_nu: float = 0.0
    cs: float = 0.0
    edac_nu: float = 0.0
    eps: float = 0.0


def phase_of(terms):
    """The phase id whose set holds ``terms``, or None."""
    for k, allowed in enumerate(PHASE_SETS):
        if terms and not terms & ~allowed:
            return k
    return None


@functools.lru_cache(maxsize=None)
def outputs_for(terms):
    return tuple(p for p in OUTPUTS
                 if any(terms & t and p in TERM_OUTPUTS[t]
                        for t in TERM_OUTPUTS))


@functools.lru_cache(maxsize=None)
def _reads(terms, side):
    props = {'x', 'y', 'z', 'h'}
    for t, reads in _TERM_READS.items():
        if terms & t:
            props.update(reads[side])
    return frozenset(props)


def pack_layout(terms):
    """(slots, planes): the ``PACK_RECORDS`` planes a source with the
    term mask packs, and their prop names (``cell_pack.layout``)."""
    return cell_pack.layout(PACK_RECORDS, _reads(terms, 1))


def _packs(sources):
    return [(src, cells.order, pack_layout(ts.terms)[1])
            for src, cells, ts in sources]


def pack_sources_reference(sources):
    """Plain torch version of ``pack_sources``: for each (state,
    ``CellList``, ``TvfSource``) of a call, the ``(planes, n, 4)``
    records of its planes gathered through the cell order."""
    return cell_pack.pack_reference(_packs(sources))


def pack_sources(sources):
    """The packed copy of every source of a ``tvf_pair`` call; same
    arguments and result as ``pack_sources_reference``.  CPU tensors
    take the plain version; CUDA tensors launch ``csrc/cell_pack.cu``."""
    return cell_pack.pack(_packs(sources))


def tvf_pair_reference(dest, dest_cells, write_mask, pre, sources, grid,
                       kernel):
    """Plain torch version of ``tvf_pair``: the torch pair engine
    running each source's equations on the exact lists (wrapped, with
    minimum images, on a periodic grid).

    ``dest``: state dict of the dest array; ``dest_cells``: its
    ``CellList``; ``write_mask``: bool rows or None; ``pre``: {output:
    value before the phase}; ``sources``: [(state, CellList,
    TvfSource)]; ``grid``: the ``CellGrid`` of the cell lists.
    Returns {output: tensor}."""
    from pysph_tpu_torch.sph.acceleration_eval import run_pair_phase
    store = dict(dest)
    store.update(pre)
    for src, src_cells, ts in sources:
        run_pair_phase(list(ts.equations), store, src, dest_cells,
                       src_cells, grid, kernel, write_mask, 0.0, 0.0)
    return {p: store[p] for p in pre}


def overflowed(device):
    """The dests past the capacity counted since the last
    ``reset_overflow`` (reads the counter)."""
    return pair_link.overflowed('tvf_pair', device)


def reset_overflow(device):
    pair_link.reset_overflow('tvf_pair', device)


class _SrcArgs(ctypes.Structure):
    _fields_ = [('plane', ctypes.c_void_p * len(PACK_RECORDS)),
                ('cell_start', ctypes.c_void_p),
                ('cell_end', ctypes.c_void_p),
                ('pb', ctypes.c_double), ('nu', ctypes.c_double),
                ('alpha', ctypes.c_double), ('c0', ctypes.c_double),
                ('noslip_nu', ctypes.c_double), ('cs', ctypes.c_double),
                ('edac_nu', ctypes.c_double), ('eps', ctypes.c_double),
                ('terms', ctypes.c_int32), ('base', ctypes.c_int32)]


class _Args(ctypes.Structure):
    _fields_ = ([(p, ctypes.c_void_p) for p in _DEST_PROPS] +
                [('cell', ctypes.c_void_p), ('dorder', ctypes.c_void_p),
                 ('wmask', ctypes.c_void_p),
                 ('pre', ctypes.c_void_p * len(OUTPUTS)),
                 ('out', ctypes.c_void_p * len(OUTPUTS)),
                 ('nbr', ctypes.c_void_p), ('count', ctypes.c_void_p),
                 ('overflow', ctypes.c_void_p),
                 ('src', _SrcArgs * MAX_SOURCES),
                 ('radius_scale', ctypes.c_double),
                 ('kfac', ctypes.c_double),
                 ('box', ctypes.c_double * 3)] +
                [(k, ctypes.c_int32) for k in (
                    'n_dest', 'n_src', 'nx', 'ny', 'nz', 'dim', 'phase',
                    'dtype', 'kernel_kind', 'periodic', 'mode', 'cap')] +
                [('pack', cell_pack.PackArgs)])


def _phase(sources):
    terms = 0
    for _, _, ts in sources:
        terms |= ts.terms
    phase = phase_of(terms)
    if phase is None:
        raise ValueError('tvf_pair: terms %#x are in no phase set' % terms)
    return terms, phase


def _check_mode(terms, phase, emit, handoff, dest, sources):
    """Raise unless only a density call emits and only a momentum call or
    a density call with AVGP (EDAC's mean pressure) takes a hand-off, one
    that ``sources`` on ``dest``'s device emitted for as many dests."""
    if emit and (handoff is not None or phase != DENSITY):
        raise ValueError('tvf_pair: only a density call emits a hand-off')
    if handoff is None:
        return
    if phase != MOMENTUM and not terms & AVGP:
        raise ValueError('tvf_pair: a density call without AVGP takes no '
                         'hand-off')
    pair_link.check_handoff('tvf_pair', handoff, dest, sources)


def _launch(dest, dest_cells, write_mask, pre, sources, grid, kernel,
            emit, handoff, capacity):
    x = dest['x']
    dev, fdt, n = x.device, x.dtype, x.shape[0]
    if fdt not in (torch.float32, torch.float64):
        raise ValueError('tvf_pair: dtype %s' % fdt)
    if len(sources) > MAX_SOURCES:
        raise ValueError('tvf_pair: %d sources' % len(sources))
    if kernel_kind(kernel) is None:
        raise ValueError('tvf_pair: no shape function for %r' % kernel)
    terms, phase = _phase(sources)
    _check_mode(terms, phase, emit, handoff, dest, sources)
    i32 = torch.int32
    args = _Args()
    # a consuming call packs all but plane 0, which it reads from the
    # density call's copies (plane 0 alone, one after another)
    first = 0 if handoff is None else 1
    packs = [(src, cells.order, pack_layout(ts.terms)[1][first:])
             for src, cells, ts in sources]
    # the copies' buffer stays referenced until the launch is queued
    buf = cell_pack.fill(args.pack, packs, 'tvf_pair') \
        if n and sources else None
    if handoff is not None:
        plane0, size = handoff.plane0()
        if n and handoff.buf.numel() != size:
            raise ValueError('tvf_pair: a hand-off of %d values for copies '
                             'of %d' % (handoff.buf.numel(), size))
    base = 0
    for k, (src, cells, ts) in enumerate(sources):
        sa = args.src[k]
        if buf is not None:
            copy = args.pack.src[k]
            plane = copy.n * 4 * x.element_size()
            for q, slot in enumerate(pack_layout(ts.terms)[0][first:]):
                sa.plane[slot] = copy.out + q * plane
            if handoff is not None:
                sa.plane[0] = handoff.buf.data_ptr() + \
                    plane0[k] * x.element_size()
        sa.cell_start = data_ptr(cells.start, grid.ncells, i32, dev,
                                 'cell_start')
        sa.cell_end = data_ptr(cells.end, grid.ncells, i32, dev, 'cell_end')
        sa.pb, sa.nu, sa.alpha, sa.c0 = ts.pb, ts.nu, ts.alpha, ts.c0
        sa.noslip_nu = ts.noslip_nu
        sa.cs, sa.edac_nu, sa.eps = ts.cs, ts.edac_nu, ts.eps
        sa.terms = ts.terms
        sa.base = base
        base += src['x'].shape[0]
    for p in _reads(terms, 0):
        setattr(args, p, data_ptr(dest[p], n, fdt, dev, 'd_' + p))
    args.cell = data_ptr(dest_cells.cell, n, i32, dev, 'dest cell')
    args.dorder = data_ptr(dest_cells.order, n, i32, dev, 'dest order')
    if write_mask is not None:
        args.wmask = data_ptr(write_mask, n, torch.bool, dev, 'write mask')
    if set(pre) != set(outputs_for(terms)):
        raise ValueError('tvf_pair: pre values for %s, terms give %s'
                         % (sorted(pre), outputs_for(terms)))
    out = {}
    for k, p in enumerate(OUTPUTS):
        if p in pre:
            args.pre[k] = data_ptr(pre[p], n, fdt, dev, 'pre ' + p)
            out[p] = torch.empty_like(pre[p])
            args.out[k] = out[p].data_ptr()
    if emit:
        if buf is None:
            handoff = pair_link.empty_handoff(dest, sources)
        else:
            cap = capacity or CAPACITY[kernel.dim]
            handoff = Handoff(buf, torch.empty((cap, n), dtype=i32,
                                               device=dev),
                              torch.empty(n, dtype=i32, device=dev),
                              pair_link.copies_of(sources),
                              tuple(len(planes) for _, _, planes in packs))
            args.overflow = pair_link.overflow_counter('tvf_pair',
                                                       dev).data_ptr()
        args.mode = EMIT
    elif handoff is not None:
        args.mode = CONSUME
    if handoff is not None and n:
        args.nbr = data_ptr(handoff.nbr, handoff.nbr.shape[0], i32, dev,
                            'neighbour list', width=n)
        args.count = data_ptr(handoff.count, n, i32, dev, 'counts')
        args.cap = handoff.nbr.shape[0]
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
    args.kernel_kind = kernel_kind(kernel)
    if n:
        build.launch('tvf_pair', args, dev,
                     EDAC_FLAGS if terms & EDAC_TERMS else ())
        tvf_pair.launches += 1
        cell_pack.pack.launches += bool(args.pack.n_src)
    return (out, handoff) if emit else out


def tvf_pair(dest, dest_cells, write_mask, pre, sources, grid, kernel,
             emit=False, handoff=None, capacity=None):
    """Pair terms of one dest over its sources; same arguments and
    result as ``tvf_pair_reference``.  ``emit`` (a density call): return
    (result, ``Handoff``); ``handoff`` (a momentum call): read that
    hand-off's copies and neighbour list instead of walking;
    ``capacity``: the neighbour list's entries a dest for ``emit``, for
    tests (default ``CAPACITY[kernel.dim]``).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    dev = dest['x'].device
    if dev.type == 'cpu':
        _check_mode(*_phase(sources), emit, handoff, dest, sources)
        out = tvf_pair_reference(dest, dest_cells, write_mask, pre,
                                 sources, grid, kernel)
        # the plain momentum call walks: the hand-off carries nothing
        return (out, pair_link.empty_handoff(dest, sources)) if emit \
            else out
    if dev.type != 'cuda':
        raise ValueError('tvf_pair: no kernel for device %s' % dev)
    return _launch(dest, dest_cells, write_mask, pre, sources, grid, kernel,
                   emit, handoff, capacity)


#: kernel launches since the last reset (set to 0 to reset)
tvf_pair.launches = 0
