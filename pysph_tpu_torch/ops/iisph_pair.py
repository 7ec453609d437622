"""The IISPH pair kernel: wrapper, launch counter and plain version.

``iisph_pair`` runs the pair terms of one dest array over all its
sources (at most ``MAX_SOURCES``) in one call, for one of the six phase
sets of ``IISPHScheme``'s groups (``sph/iisph.py``: the 2D dam break,
the elliptical drop and the Taylor-Green vortex with ``--scheme
iisph``).  A per-source term mask says which equations a source takes:

==========  ==============================================  ============
phase set   terms (equations)                               outputs
==========  ==============================================  ============
DENSITY     NDEN (``NumberDensity``), SDEN                  V rho
            (``SummationDensity``), SDENB
            (``SummationDensityBoundary``)
ADVECTION   DII, DIIB (``ComputeDII``, ``ComputeDIIBoundary``),  dii0-2
            VISC, VISCB (``ViscosityAcceleration``,         au av aw
            ``ViscosityAccelerationBoundary``)
RHOADV      RHOADV, RHOB (``ComputeRhoAdvection``,          rho_adv
            ``ComputeRhoBoundary``), AII, AIIB              aii
            (``ComputeAII``, ``ComputeAIIBoundary``)
DIJPJ       DIJPJ (``ComputeDIJPJ``)                        dijpj0-2
SOLVE       PSOLVE, PSOLVEB (``PressureSolve``,             p
            ``PressureSolveBoundary``)
FORCE       PFORCE, PFORCEB (``PressureForce``,             au av aw
            ``PressureForceBoundary``)
==========  ==============================================  ============

Each output is ``pre + sum`` on rows under the write mask and ``pre``
elsewhere; every read sees the value from before the phase.  The
advected density's terms take the step's ``dt``, the last argument of
every call: a float, or (in the solver's chunks) a float64 0-d tensor on
the card, which the kernel reads there.  Any kernel of ``kernel_kind``;
the grid may be periodic (the wrapped stencil and the minimum image, a
template flag of the kernel, as ``tvf_pair``'s).

The linked launches.  Nothing in an IISPH evaluation moves ``x y z h``
and the binning runs once an eval, so a dest's launches after the first
one that sees all its later sources walk the same pairs in the same
order (``ops/pair_engine.py::link_pairs``): that launch (the density
launch of a fluid-only run, the advection launch of the dam break's
fluid) runs with ``emit=True`` and returns, beside its output, a
``Handoff`` (``ops/pair_link.py``): its sources' packed copies and the
neighbour list, up to ``CAPACITY[dim]`` entries a dest.  Every later
launch of the dest (the advected density, each sweep's ``dijpj`` and
pressure, the force) takes it (``handoff=``): it packs its own planes
but plane 0 afresh (``piter`` and ``dijpj`` change every sweep) and
reads the listed records instead of walking, so its sums are the walk's
bit for bit.  A launch over fewer of the emitter's sources (the fluid's
``dijpj``, whose only source is the fluid, against the advection
launch's fluid and wall) reads the list with the term mask 0 for the
source it lacks.  A warp holding a dest past the capacity walks; the
emitting launch counts such dests on the card (``overflowed``).  A
linked consumer run without its hand-off raises.

For CUDA tensors it calls ``csrc/iisph_pair.cu`` (a library of its own,
built on first use by ``ops/build.py``) once: its launch function
launches the source pack (``ops/cell_pack.py``, counted in
``cell_pack.pack.launches``) and then the kernel (counted in
``iisph_pair.launches``).  For CPU tensors it calls
``iisph_pair_reference``, the torch pair engine running the same
``Equation`` objects on the exact lists of ``CellGrid.neighbor_pairs``,
which walks for every call: an emitting call returns an empty hand-off.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from pysph_tpu_torch.base.kernels import kernel_kind
from pysph_tpu_torch.ops import build, cell_pack, pair_link
from pysph_tpu_torch.ops.build import data_ptr
from pysph_tpu_torch.ops.pair_link import CAPACITY, Handoff

(NDEN, SDEN, SDENB, DII, DIIB, VISC, VISCB, RHOADV, RHOB, AII, AIIB, DIJPJ,
 PSOLVE, PSOLVEB, PFORCE, PFORCEB) = (1 << k for k in range(16))
#: phase sets, indexed by the phase id of the CUDA kernel
PHASE_SETS = (NDEN | SDEN | SDENB, DII | DIIB | VISC | VISCB,
              RHOADV | RHOB | AII | AIIB, DIJPJ, PSOLVE | PSOLVEB,
              PFORCE | PFORCEB)
DENSITY, ADVECTION, RHO_ADVECTION, DIJPJ_SET, SOLVE, FORCE = range(6)
#: the sets whose launch may emit the neighbour list, and those whose
#: launch may read it (csrc/iisph_pair.cu kEmits, kConsumes)
EMITTING = (DENSITY, ADVECTION)
CONSUMING = (ADVECTION, RHO_ADVECTION, DIJPJ_SET, SOLVE, FORCE)
#: the kernel's modes (csrc/iisph_pair.cu kWalk, kEmit, kConsume)
WALK, EMIT, CONSUME = 0, 1, 2
MAX_SOURCES = 4
OUTPUTS = ('V', 'rho', 'dii0', 'dii1', 'dii2', 'au', 'av', 'aw', 'rho_adv',
           'aii', 'dijpj0', 'dijpj1', 'dijpj2', 'p')
_DII = ('dii0', 'dii1', 'dii2')
_DIJPJ = ('dijpj0', 'dijpj1', 'dijpj2')
_ACC = ('au', 'av', 'aw')
TERM_OUTPUTS = {NDEN: ('V',), SDEN: ('rho',), SDENB: ('rho',), DII: _DII,
                DIIB: _DII, VISC: _ACC, VISCB: _ACC, RHOADV: ('rho_adv',),
                RHOB: ('rho_adv',), AII: ('aii',), AIIB: ('aii',),
                DIJPJ: _DIJPJ, PSOLVE: ('p',), PSOLVEB: ('p',),
                PFORCE: _ACC, PFORCEB: _ACC}

# props each term reads beyond x, y, z, h: (dest, source)
_VEL = ('u', 'v', 'w')
_ADV = ('uadv', 'vadv', 'wadv')
_TERM_READS = {
    NDEN: ((), ()), SDEN: ((), ('m',)), SDENB: ((), ('V',)),
    DII: (('rho',), ('m',)), DIIB: (('rho',), ('V',)),
    VISC: (('rho',) + _VEL, ('m', 'rho') + _VEL),
    VISCB: (('rho',) + _VEL, ('V',) + _VEL),
    RHOADV: (_ADV, ('m',) + _ADV), RHOB: (_ADV, ('V',) + _VEL),
    AII: (('m', 'rho') + _DII, ('m',)), AIIB: (('m', 'rho') + _DII, ('V',)),
    DIJPJ: ((), ('m', 'rho', 'piter')),
    PSOLVE: (('m', 'rho', 'piter') + _DIJPJ,
             ('m',) + _DII + ('piter',) + _DIJPJ),
    PSOLVEB: (_DIJPJ, ('V',)),
    PFORCE: (('rho', 'p'), ('m', 'rho', 'p')), PFORCEB: (('rho', 'p'),
                                                       ('V',))}
_DEST_PROPS = ('x', 'y', 'z', 'h', 'm', 'rho') + _VEL + _ADV + _DII + (
    'piter',) + _DIJPJ + ('p',)
#: record planes of the packed copy (csrc/iisph_pair.cu): a source packs
#: plane 0 and each plane holding a prop its terms read; a consuming
#: launch all but plane 0, which it reads from the emitting launch's copy
PACK_RECORDS = (('x', 'y', 'z', 'h'), ('m', 'rho', 'V', 'p'),
                ('u', 'v', 'w', None), ('uadv', 'vadv', 'wadv', None),
                ('dii0', 'dii1', 'dii2', 'piter'),
                ('dijpj0', 'dijpj1', 'dijpj2', None))


class IisphSource(NamedTuple):
    """One source of a dest's phase set: its term mask, the ``Equation``
    objects the terms stand for (the plain version runs them) and their
    constants: the walls' ``rho0`` and the viscosities' ``nu``."""
    name: str
    terms: int
    equations: tuple
    rho0: float = 0.0
    nu: float = 0.0


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
    ``CellList``, ``IisphSource``) of a call, the ``(planes, n, 4)``
    records of its planes gathered through the cell order."""
    return cell_pack.pack_reference(_packs(sources))


def pack_sources(sources):
    """The packed copy of every source of an ``iisph_pair`` call; same
    arguments and result as ``pack_sources_reference``.  CPU tensors
    take the plain version; CUDA tensors launch ``csrc/cell_pack.cu``."""
    return cell_pack.pack(_packs(sources))


def iisph_pair_reference(dest, dest_cells, write_mask, pre, sources, grid,
                         kernel, dt=0.0):
    """Plain torch version of ``iisph_pair``: the torch pair engine
    running each source's equations on the exact lists (wrapped, with
    minimum images, on a periodic grid).

    ``dest``: state dict of the dest array; ``dest_cells``: its
    ``CellList``; ``write_mask``: bool rows or None; ``pre``: {output:
    value before the phase}; ``sources``: [(state, CellList,
    IisphSource)]; ``grid``: the ``CellGrid`` of the cell lists; ``dt``:
    the step's.  Returns {output: tensor}."""
    from pysph_tpu_torch.sph.acceleration_eval import run_pair_phase
    store = dict(dest)
    store.update(pre)
    for src, src_cells, ts in sources:
        run_pair_phase(list(ts.equations), store, src, dest_cells,
                       src_cells, grid, kernel, write_mask, 0.0, dt)
    return {p: store[p] for p in pre}


def device_dt(dt, device, name):
    """The address of a step's dt held on the card (the solver's chunk
    carries it as a float64 0-d tensor), checked."""
    if dt.dtype != torch.float64 or dt.device != device or dt.numel() != 1:
        raise ValueError('%s: dt must be a float64 scalar tensor on %s, got '
                         '%s %s on %s' % (name, device, tuple(dt.shape),
                                          dt.dtype, dt.device))
    return dt.data_ptr()


def overflowed(device):
    """The dests past the capacity counted since the last
    ``reset_overflow`` (reads the counter)."""
    return pair_link.overflowed('iisph_pair', device)


def reset_overflow(device):
    pair_link.reset_overflow('iisph_pair', device)


class _SrcArgs(ctypes.Structure):
    _fields_ = [('plane', ctypes.c_void_p * len(PACK_RECORDS)),
                ('cell_start', ctypes.c_void_p),
                ('cell_end', ctypes.c_void_p),
                ('rho0', ctypes.c_double), ('nu', ctypes.c_double),
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
                 ('kfac', ctypes.c_double), ('dt', ctypes.c_double),
                 ('dt_at', ctypes.c_void_p), ('box', ctypes.c_double * 3)] +
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
        raise ValueError('iisph_pair: terms %#x are in no phase set'
                         % terms)
    return terms, phase


def aligned(sources, handoff):
    """The call's sources in the order of the hand-off's copies, None
    for a copy that no source of the call is: raises unless the call's
    sources are among the copies, in their order, with their particle
    counts (a consumer over fewer sources than its emitter)."""
    by_name = {ts.name: (src, cells, ts) for src, cells, ts in sources}
    names = [name for name, _ in handoff.sources]
    mine = [ts.name for _, _, ts in sources]
    if [name for name in names if name in by_name] != mine or \
            any(name in by_name and by_name[name][0]['x'].shape[0] != n
                for name, n in handoff.sources):
        raise ValueError('iisph_pair: a hand-off of %s given to a call '
                         'over %s' % (handoff.sources, pair_link.copies_of(
                             sources)))
    return [by_name.get(name) for name in names]


def _check_mode(phase, emit, handoff, dest, sources):
    """Raise unless only a call of an emitting set emits and only one of
    a consuming set takes a hand-off, one that was emitted on ``dest``'s
    device for as many dests over sources that include ``sources``."""
    if emit and (handoff is not None or phase not in EMITTING):
        raise ValueError('iisph_pair: a call of phase set %d emits no '
                         'hand-off' % phase)
    if handoff is None:
        return
    if phase not in CONSUMING:
        raise ValueError('iisph_pair: a call of phase set %d takes no '
                         'hand-off' % phase)
    x = dest['x']
    if handoff.buf.dtype != x.dtype or handoff.buf.device != x.device or \
            handoff.nbr.shape[1] != x.shape[0]:
        raise ValueError('iisph_pair: a hand-off for %d dests on %s given '
                         'to a call for %d dests on %s' % (
                             handoff.nbr.shape[1], handoff.buf.device,
                             x.shape[0], x.device))
    aligned(sources, handoff)


def _launch(dest, dest_cells, write_mask, pre, sources, grid, kernel, dt,
            emit, handoff, capacity):
    x = dest['x']
    dev, fdt, n = x.device, x.dtype, x.shape[0]
    if fdt not in (torch.float32, torch.float64):
        raise ValueError('iisph_pair: dtype %s' % fdt)
    if len(sources) > MAX_SOURCES:
        raise ValueError('iisph_pair: %d sources' % len(sources))
    if kernel_kind(kernel) is None:
        raise ValueError('iisph_pair: no shape function for %r' % kernel)
    terms, phase = _phase(sources)
    _check_mode(phase, emit, handoff, dest, sources)
    i32 = torch.int32
    args = _Args()
    # a consuming call packs all but plane 0, which it reads from the
    # emitting call's copies; it runs over the emitter's sources, those
    # it lacks with the term mask 0
    first = 0 if handoff is None else 1
    slots = sources if handoff is None else aligned(sources, handoff)
    packs = [(src, cells.order, pack_layout(ts.terms)[1][first:])
             for src, cells, ts in sources]
    # a copy of planes 1.. only where the source reads one of them
    packed = [bool(planes) for _, _, planes in packs]
    packs = [p for p, keep in zip(packs, packed) if keep]
    # the copies' buffer stays referenced until the launch is queued
    buf = cell_pack.fill(args.pack, packs, 'iisph_pair') \
        if n and packs else None
    if handoff is not None:
        plane0, size = handoff.plane0()
        if n and handoff.buf.numel() != size:
            raise ValueError('iisph_pair: a hand-off of %d values for '
                             'copies of %d' % (handoff.buf.numel(), size))
    base, copy = 0, 0
    for k, slot in enumerate(slots):
        sa = args.src[k]
        if handoff is not None:
            sa.plane[0] = handoff.buf.data_ptr() + \
                plane0[k] * x.element_size()
        if slot is None:
            # a copy the call does not read: its entries are skipped
            sa.base = base
            base += handoff.sources[k][1]
            continue
        src, cells, ts = slot
        layout = pack_layout(ts.terms)[0][first:]
        if buf is not None and layout:
            c = args.pack.src[copy]
            plane = c.n * 4 * x.element_size()
            for q, s in enumerate(layout):
                sa.plane[s] = c.out + q * plane
            copy += 1
        sa.cell_start = data_ptr(cells.start, grid.ncells, i32, dev,
                                 'cell_start')
        sa.cell_end = data_ptr(cells.end, grid.ncells, i32, dev, 'cell_end')
        sa.rho0, sa.nu = ts.rho0, ts.nu
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
        raise ValueError('iisph_pair: pre values for %s, terms give %s'
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
            args.overflow = pair_link.overflow_counter('iisph_pair',
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
    if torch.is_tensor(dt):
        # the solver's chunk: the step's dt stays on the card
        args.dt_at = device_dt(dt, dev, 'iisph_pair')
    else:
        args.dt = float(dt)
    # the box lengths of the periodic axes, each the dtype's value
    lengths = grid.box_host(fdt)['lengths']
    for d, per in enumerate(grid.periodic):
        args.box[d] = lengths[d] if per else 0.0
    args.periodic = grid.is_periodic
    args.n_dest, args.n_src = n, len(slots)
    args.nx, args.ny, args.nz = grid.dims
    args.dim = kernel.dim
    args.phase = phase
    args.dtype = 1 if fdt == torch.float64 else 0
    args.kernel_kind = kernel_kind(kernel)
    if n:
        build.launch('iisph_pair', args, dev)
        iisph_pair.launches += 1
        cell_pack.pack.launches += bool(args.pack.n_src)
    return (out, handoff) if emit else out


def iisph_pair(dest, dest_cells, write_mask, pre, sources, grid, kernel,
               dt=0.0, emit=False, handoff=None, capacity=None):
    """Pair terms of one dest over its sources; same arguments and
    result as ``iisph_pair_reference``.  ``emit`` (a call of an emitting
    set): return (result, ``Handoff``); ``handoff`` (a later call of the
    dest): read that hand-off's copies and neighbour list instead of
    walking; ``capacity``: the neighbour list's entries a dest for
    ``emit``, for tests (default ``CAPACITY[kernel.dim]``).  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    dev = dest['x'].device
    if dev.type == 'cpu':
        _check_mode(_phase(sources)[1], emit, handoff, dest, sources)
        out = iisph_pair_reference(dest, dest_cells, write_mask, pre,
                                   sources, grid, kernel, dt)
        # the plain consumers walk: the hand-off carries nothing
        return (out, pair_link.empty_handoff(dest, sources)) if emit \
            else out
    if dev.type != 'cuda':
        raise ValueError('iisph_pair: no kernel for device %s' % dev)
    return _launch(dest, dest_cells, write_mask, pre, sources, grid, kernel,
                   dt, emit, handoff, capacity)


#: kernel launches since the last reset (set to 0 to reset)
iisph_pair.launches = 0
