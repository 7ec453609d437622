"""The CRKSPH pair kernel: wrapper, launch counter and plain version.

``crksph_pair`` runs the pair terms of one dest array over all its
sources (at most ``MAX_SOURCES``) in one call, for one of the six phase
sets of ``CRKSPHScheme``'s groups (``sph/wc/crksph.py``: the accuracy
test, the hydrostatic box and the Taylor-Green vortex's ``--scheme
crksph``):

============  ============================================  ============
terms         equations of each source, in order            outputs
============  ============================================  ============
NDEN          ``NumberDensity``: WI                         V
MOMS          ``CRKSPHPreStep``: the moments at HIJ         crk_m0 m1 m2
                                                            gm0 gm1 gm2
                                                            crk_nnbr
RHO           ``CRKSPHSymmetric``,                          rho rhofac
              ``SummationDensityCRKSPH``
GRADV         ``CRKSPHSymmetric``, ``VelocityGradient``     gradv
MOM           ``CRKSPHSymmetric``, ``MomentumEquation``,    au av aw
              and ``LaminarViscosity`` (``MOM | VISC``)
              on the corrected DWIJ
ENERGY        ``CRKSPHSymmetric``, ``EnergyEquation``       ae
============  ============================================  ============

``CRKSPHSymmetric`` rewrites the pair symbols ``DWIJ``, ``DWI`` and
``DWJ`` for the equation after it, which the planner's generic rule
cannot see, so ``ops/pair_engine.py::_plan_crksph`` accepts exactly these
ordered sets, the same for every source.  Each output is ``pre + sum`` on
rows under the write mask and ``pre`` elsewhere, a strided output (``(n,
k)``) written whole, its columns past the kernel's dimension as ``pre``;
every read sees the value from before the phase.  ``counts=True`` adds
``nnbr``, each dest's pairs in support (int32).

The kernel's dimension is 2 or 3 (a 1D dest raises
``NotImplementedError``: CRKSPH's 1D runs need mirror ghosts, ROADMAP
Queue 1 item 27).  The packed copy's record planes depend on it
(``PACK_RECORDS[dim]``): planes 3 on hold one flat record of a source's
coefficients, the first ``dim`` components of ``bi``, ``gradai``,
``gradbi`` and ``gradv`` (``(prop, c)``: column ``c``), then ``u0 v0
w0``.

For CUDA tensors it calls ``csrc/crksph_pair.cu`` once: its launch
function launches the source pack (``ops/cell_pack.py``, counted in
``cell_pack.pack.launches``) and then the kernel (counted in
``crksph_pair.launches``, and by set in ``crksph_pair.by_set``), a group
of lanes a dest (``lanes``); its default library holds ``QuinticSpline``
alone, every other kind is a library of its own (``-DPAIR_KIND``), built
at its first launch; a dtype other than float32 and float64 or a refused
launch raises.  For CPU tensors it calls ``crksph_pair_reference``, the
torch pair engine running the same ``Equation`` objects on the exact
lists of ``CellGrid.neighbor_pairs``.

One neighbour list an evaluation (``ops/pair_link.py``;
``ops/pair_engine.py::link_pairs`` links the plans): the number density
call runs with ``emit=True`` and returns, beside its output, a
``Handoff``, its sources' packed ``{x y z h}`` copies and each dest's
pairs in support in the walk's order, up to ``CAPACITY[dim]`` entries a
dest; the moments, density, velocity gradient and momentum calls of the
same evaluation take it (``handoff=``), pack only their further planes
and read the listed pairs instead of walking.  A warp holding a dest
past the capacity walks; the emitting launch counts such dests on the
card (``overflowed``).  On CPU tensors the plain version walks for every
call and the emitting call returns an empty hand-off.
"""

import ctypes
from typing import NamedTuple

import torch

from pysph_tpu_torch.base.kernels import kernel_kind
from pysph_tpu_torch.ops import build, cell_pack, pair_link
from pysph_tpu_torch.ops.build import data_ptr
from pysph_tpu_torch.ops.pair_link import Handoff
from pysph_tpu_torch.ops.pair_sets import PhaseSets

NDEN, MOMS, RHO, GRADV, MOM, ENERGY, VISC = 1, 2, 4, 8, 16, 32, 64
#: phase sets, by phase id
PHASE_SETS = (NDEN, MOMS, RHO, GRADV, MOM, ENERGY, MOM | VISC)
#: the CUDA kernel's phase of each phase id (csrc/crksph_pair.cu CrkPhase;
#: the viscosity is its ``visc`` flag)
KERNEL_PHASE = (0, 1, 2, 3, 4, 5, 4)
#: the kernel's modes (csrc/crksph_pair.cu CrkMode)
WALK, EMIT, READ = range(3)
#: the sets that emit the list and those that read it
EMITTING = (NDEN,)
READING = (MOMS, RHO, GRADV, MOM, MOM | VISC)
#: entries of the neighbour list a dest, by the kernel's dim: the most
#: pairs a dest held on the card on the paths of chip_smoke.py was 117
#: (the accuracy test at 256^2 after a jittered step, QuinticSpline at
#: h = 2 dx; 113 after its 200 steps, 69 the hydrostatic box at nx=50,
#: 33 Taylor-Green at nx=100), with headroom (PERF.md).  3D (h = 2 dx:
#: ~900 pairs a dest) has none: its sets walk, unlinked
CAPACITY = {2: 160}
MAX_SOURCES = 4
OUTPUTS = ('V', 'crk_m0', 'crk_m1', 'crk_m2', 'crk_gm0', 'crk_gm1',
           'crk_gm2', 'crk_nnbr', 'rho', 'rhofac', 'gradv', 'au', 'av',
           'aw', 'ae')
#: the width of each strided prop that a set reads of the dest or writes
WIDTH = {'crk_m1': 3, 'crk_m2': 9, 'crk_gm0': 3, 'crk_gm1': 9,
         'crk_gm2': 27, 'gradv': 9, 'bi': 3, 'gradai': 3, 'gradbi': 9}
TERM_OUTPUTS = {NDEN: OUTPUTS[:1], MOMS: OUTPUTS[1:8],
                RHO: ('rho', 'rhofac'), GRADV: ('gradv',),
                MOM: ('au', 'av', 'aw'), MOM | VISC: ('au', 'av', 'aw'),
                ENERGY: ('ae',)}
#: the dest's strided props each set reads
DEST_STRIDED = {RHO: ('bi',), GRADV: ('bi', 'gradai', 'gradbi'),
                MOM: ('bi', 'gradai', 'gradbi', 'gradv'),
                ENERGY: ('bi', 'gradai', 'gradbi', 'gradv')}
DEST_STRIDED[MOM | VISC] = DEST_STRIDED[MOM]

_VEL = ('u', 'v', 'w')
_VEL0 = ('u0', 'v0', 'w0')
_THERMO = ('rho', 'p', 'cs', 'V')


def coefficients(dim):
    """The flat record of a source's coefficients (planes 3 on), in the
    kernel's order: ``ai``, the first ``dim`` components of ``bi`` and
    ``gradai``, ``gradbi[g, a]`` (column ``3 g + a``) and ``gradv``
    (column ``dim a + b``), then ``u0 v0 w0``."""
    return (('ai',) + tuple(('bi', a) for a in range(dim)) +
            tuple(('gradai', a) for a in range(dim)) +
            tuple(('gradbi', 3 * g + a) for g in range(dim)
                  for a in range(dim)) +
            tuple(('gradv', k) for k in range(dim * dim)) + _VEL0)


def pack_records(dim):
    """The record planes of the packed copy in ``dim`` dimensions
    (csrc/crksph_pair.cu's ``plane q:`` comments)."""
    flat = coefficients(dim)
    flat += (None,) * (-len(flat) % 4)
    return ((('x', 'y', 'z', 'h'), _VEL + ('m',), _THERMO) +
            tuple(flat[q:q + 4] for q in range(0, len(flat), 4)))


PACK_RECORDS = {dim: pack_records(dim) for dim in (2, 3)}


def _set_reads(dim):
    """{terms: (dest props of stride 1, source props and columns)} read
    beyond x, y, z, h in ``dim`` dimensions."""
    coef = coefficients(dim)[:-3]
    both = _VEL + _THERMO + ('ai',)
    return {NDEN: ((), ()), MOMS: ((), ('V',)),
            RHO: (('m', 'ai'), ('V',)),
            GRADV: (_VEL + ('ai',), _VEL + ('V',)),
            MOM: (both + ('m',), both + coef),
            MOM | VISC: (both + ('m',), both + coef + ('m',)),
            ENERGY: (both + _VEL0 + ('m',), both + coef + _VEL0)}


_SETS = {dim: PhaseSets('crksph_pair', PHASE_SETS, _set_reads(dim),
                        PACK_RECORDS[dim], MAX_SOURCES) for dim in (2, 3)}


class CrkSource(NamedTuple):
    """One source of a dest's phase set: its term mask, the ``Equation``
    objects of the set (the plain version runs them) and the constants of
    its ``MomentumEquation`` or ``EnergyEquation`` (``cl``, ``cq``,
    ``eta_crit``, ``eta_fold``, ``gamma``) and its ``LaminarViscosity``
    (``nu``, ``eta``)."""
    name: str
    terms: int
    equations: tuple
    cl: float = 0.0
    cq: float = 0.0
    eta_crit: float = 0.0
    eta_fold: float = 0.0
    gamma: float = 0.0
    nu: float = 0.0
    eta: float = 0.0


def sets_of(dim):
    """The ``PhaseSets`` of ``dim`` dimensions; ``NotImplementedError``
    for 1D."""
    if dim not in _SETS:
        raise NotImplementedError(
            'crksph_pair: a %dD dest: CRKSPH in 1D needs mirror ghosts '
            '(ROADMAP Queue 1 item 27); run it with --engine torch' % dim)
    return _SETS[dim]


def crksph_pair_reference(dest, dest_cells, write_mask, pre, sources, grid,
                          kernel, counts=False):
    """Plain torch version of ``crksph_pair``: the torch pair engine
    running each source's equations on the exact lists (wrapped, with
    minimum images, on a periodic grid).

    ``dest``: state dict of the dest array; ``dest_cells``: its
    ``CellList``; ``write_mask``: bool rows or None; ``pre``: {output:
    value before the phase}; ``sources``: [(state, CellList,
    CrkSource)]; ``grid``: the ``CellGrid`` of the cell lists;
    ``counts``: add ``nnbr``.  Returns {output: tensor}."""
    return _SETS[2].reference(dest, dest_cells, write_mask, pre, sources,
                              grid, kernel, counts=counts)


class _SrcArgs(ctypes.Structure):
    _fields_ = [('plane', ctypes.c_void_p * cell_pack.MAX_PLANES),
                ('cell_start', ctypes.c_void_p),
                ('cell_end', ctypes.c_void_p),
                ('terms', ctypes.c_int32), ('base', ctypes.c_int32)]


_DEST_PROPS = ('x', 'y', 'z', 'h') + _VEL + _VEL0 + (
    'm', 'rho', 'p', 'cs', 'V', 'ai', 'bi', 'gradai', 'gradbi', 'gradv')


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
                [(k, ctypes.c_double) for k in (
                    'cl', 'cq', 'eta_crit', 'eta_fold', 'gamma', 'nu',
                    'eta')] +
                [(k, ctypes.c_int32) for k in (
                    'n_dest', 'n_src', 'nx', 'ny', 'nz', 'dim', 'phase',
                    'dtype', 'kernel_kind', 'periodic', 'visc', 'mode',
                    'cap')] +
                [(k, ctypes.c_void_p) for k in ('nbr', 'lcount',
                                                 'overflow')] +
                [('pack', cell_pack.PackArgs)])


def kind_flags(kernel):
    """The flags of the library that holds ``kernel``'s shape beside
    ``build.launch``'s own: the default library holds ``QuinticSpline``
    (kind 3) alone, so kinds 0-2 take a library each too."""
    kind = kernel_kind(kernel)
    return ('-DPAIR_KIND=%d' % kind,) if kind is not None and \
        kind < build.BASE_KINDS and kind != 3 else ()


def overflowed(device):
    """The dests past the list's capacity that emitting launches counted
    since ``reset_overflow`` (reads the counter)."""
    return pair_link.overflowed('crksph_pair', device)


def reset_overflow(device):
    pair_link.reset_overflow('crksph_pair', device)


def lanes(phase, dtype):
    """The lanes a dest of the kernel's phase ``phase`` (``KERNEL_PHASE``)
    in ``dtype``, as the default library was built (loads it)."""
    lib = build.load_library('crksph_pair', _Args)
    return lib.crksph_pair_lanes(phase, int(dtype == torch.float64))


def _check_mode(terms, emit, handoff, dest, sources):
    """Raise unless only a set of ``EMITTING`` emits and only a set of
    ``READING`` takes a hand-off, one that ``sources`` on ``dest``'s
    device emitted for as many dests."""
    if emit and (handoff is not None or terms not in EMITTING):
        raise ValueError('crksph_pair: only a number density call emits a '
                         'hand-off')
    if handoff is None:
        return
    if terms not in READING:
        raise ValueError('crksph_pair: a call of terms %#x takes no hand-off'
                         % terms)
    pair_link.check_handoff('crksph_pair', handoff, dest, sources)


def _launch(dest, dest_cells, write_mask, pre, sources, grid, kernel,
            counts, emit, handoff, capacity):
    x = dest['x']
    dev, fdt, n = x.device, x.dtype, x.shape[0]
    sets = sets_of(kernel.dim)
    phase = sets.phase(sources)
    terms = PHASE_SETS[phase]
    _check_mode(terms, emit, handoff, dest, sources)
    if set(pre) != set(TERM_OUTPUTS[terms]):
        raise ValueError('crksph_pair: pre values for %s, the set gives %s'
                         % (sorted(pre), TERM_OUTPUTS[terms]))
    args = _Args()
    i32 = torch.int32
    # a reading call packs its planes but plane 0, which it reads from the
    # emitting call's copies
    slots, planes = sets.pack_layout(terms)
    layout = (slots[1:], planes[1:]) if handoff is not None else None
    buf = sets.fill(args, dest, dest_cells, write_mask, sources, grid,
                    kernel, phase, layout=layout)
    if handoff is not None:
        plane0, size = handoff.plane0()
        if n and handoff.buf.numel() != size:
            raise ValueError('crksph_pair: a hand-off of %d values for '
                             'copies of %d' % (handoff.buf.numel(), size))
        for k in range(len(sources)):
            args.src[k].plane[0] = handoff.buf.data_ptr() + \
                plane0[k] * x.element_size()
        args.mode = READ
    elif emit:
        cap = capacity or CAPACITY.get(kernel.dim)
        if cap is None:
            raise ValueError('crksph_pair: no list capacity in %dD'
                             % kernel.dim)
        handoff = Handoff(buf, torch.empty((cap, n), dtype=i32, device=dev),
                          torch.empty(n, dtype=i32, device=dev),
                          pair_link.copies_of(sources))
        args.overflow = pair_link.overflow_counter('crksph_pair',
                                                   dev).data_ptr()
        args.mode = EMIT
    if handoff is not None and n:
        args.nbr = data_ptr(handoff.nbr, handoff.nbr.shape[0], i32, dev,
                            'neighbour list', width=n)
        args.lcount = data_ptr(handoff.count, n, i32, dev, 'counts')
        args.cap = handoff.nbr.shape[0]
    args.phase = KERNEL_PHASE[phase]
    args.visc = bool(terms & VISC)
    cs = sources[0][2]
    for k in ('cl', 'cq', 'eta_crit', 'eta_fold', 'gamma', 'nu', 'eta'):
        setattr(args, k, getattr(cs, k))
    for p in DEST_STRIDED.get(terms, ()):
        setattr(args, p, data_ptr(dest[p], n, fdt, dev, 'd_' + p,
                                  width=WIDTH[p]))
    out = {}
    for k, p in enumerate(OUTPUTS):
        if p in pre:
            args.pre[k] = data_ptr(pre[p], n, fdt, dev, 'pre ' + p,
                                   width=WIDTH.get(p))
            out[p] = torch.empty_like(pre[p])
            args.out[k] = out[p].data_ptr()
    if counts:
        out['nnbr'] = torch.empty(n, dtype=torch.int32, device=dev)
        args.count = out['nnbr'].data_ptr()
    if n:
        build.launch('crksph_pair', args, dev, kind_flags(kernel))
        crksph_pair.launches += 1
        crksph_pair.by_set[KERNEL_PHASE[phase]] += 1
        cell_pack.pack.launches += bool(args.pack.n_src)
    if emit:
        return out, handoff
    del buf  # held until the launch is queued
    return out


def crksph_pair(dest, dest_cells, write_mask, pre, sources, grid, kernel,
                counts=False, emit=False, handoff=None, capacity=None):
    """Pair terms of one dest over its sources; same arguments and
    result as ``crksph_pair_reference``.  ``emit`` (a number density
    call): return (result, ``Handoff``); ``handoff`` (a moments, density,
    velocity gradient or momentum call): read that hand-off's copies and
    neighbour list instead of walking; ``capacity``: the list's entries
    a dest for ``emit``, for tests (default ``CAPACITY[kernel.dim]``).
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise (a 1D dest: ``NotImplementedError``)."""
    dev = dest['x'].device
    if dev.type == 'cpu':
        _check_mode(PHASE_SETS[sets_of(kernel.dim).phase(sources)], emit,
                    handoff, dest, sources)
        out = crksph_pair_reference(dest, dest_cells, write_mask, pre,
                                    sources, grid, kernel, counts)
        # the plain reading calls walk: the hand-off carries nothing
        return (out, pair_link.empty_handoff(dest, sources)) if emit \
            else out
    if dev.type != 'cuda':
        raise ValueError('crksph_pair: no kernel for device %s' % dev)
    return _launch(dest, dest_cells, write_mask, pre, sources, grid, kernel,
                   counts, emit, handoff, capacity)


def reset_launches():
    """Set ``crksph_pair.launches`` and each set's count to 0."""
    crksph_pair.launches = 0
    crksph_pair.by_set = [0] * 6


#: kernel launches since the last reset (``reset_launches``), and by the
#: kernel's phase (``KERNEL_PHASE``: number, moments, density, gradient,
#: momentum, energy)
reset_launches()
