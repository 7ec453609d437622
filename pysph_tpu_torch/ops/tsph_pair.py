"""TSPH's pair kernel: wrapper, launch counters and plain versions.

``tsph_pair`` runs the pair terms of one dest array over all its sources
(at most ``MAX_SOURCES``) in one call, for one of the three phase sets of
``TSPHScheme``'s groups (``sph/gas_dynamics/tsph.py``: the accuracy test,
the hydrostatic box, Sedov's blast and Cheng-Shu's wave of
``examples/gas_dynamics/`` under ``--scheme tsph``):

==========  ==============================================  =============
phase set   terms (equations)                               outputs
==========  ==============================================  =============
DENSITY     SDEN (``SummationDensity``): WI, DWI, GHI at    rho arho
            the dest's h; ``VIJ . DWI`` times fij from the  drhosumdh n
            dest's ``prevn prevdndh prevdrhosumdh``         an dndh
GRADIENT    GRADV (``VelocityGradDivC1``): ``-m_j XIJ x     invtt gradv
            DWI`` and ``-m_j VIJ x DWI`` (dim x dim of the  (stride 9)
            row-major 3 x 3), DWI at the dest's h
MOMENTUM    MOM (``MomentumAndEnergy``): Monaghan's         au av aw ae
            viscosity on approaching pairs (HIJ, R2IJ,
            RHOIJ1, DWI at the dest's h, DWJ at the
            source's), the grad-h pressure terms fij, fji
==========  ==============================================  =============

Each output is ``pre + sum`` on rows under the write mask and ``pre``
elsewhere (``invtt`` and ``gradv``: the dim x dim columns; the others
keep ``pre``); every read sees the value from before the phase.  h varies
per particle: a pair is in support where ``r < radius_scale max(hi,
hj)``.  Every kernel with a ``kernel_kind`` (``csrc/shapes.cuh``; the
scheme's is the Gaussian, kind 2), in 1, 2 or 3 dimensions; the grid may
be periodic.  ``counts=True`` adds ``nnbr``, each dest's pairs in support
(int32), to the result.

For CUDA tensors it calls ``csrc/tsph_pair.cu`` once: its launch function
launches the source pack (``ops/cell_pack.py``, counted in
``cell_pack.pack.launches``), for the momentum set the per-source terms
(each source's packed plane 3 rewritten as ``mom_terms_reference``
gives), and then the kernel (counted in ``tsph_pair.launches`` and
``tsph_pair.by_set``).  The default library holds the Gaussian in 1D and
2D; each other kind (``kind_flags``) and 3D (``DIM_FLAGS``) is a library
of its own, built at its first launch.  A dtype other than float32 and
float64, a kernel without a ``kernel_kind`` or a refused launch raises.
For CPU tensors it calls ``tsph_pair_reference``, the torch pair engine
running the same ``Equation`` objects on the exact lists of
``CellGrid.neighbor_pairs``.

``tsph_sweep`` runs one sweep of ``TSPHScheme``'s iterated density group
(``Group([SummationDensity(..., density_iterations=True)], iterate=True,
update_nnps=True)``): ``initialize`` (the ``prev*`` copies, the sums at
0), the pair sums, ``post_loop`` (the Newton step of each unconverged
particle's h on the number density, ``ah`` and ``converged``) and the
count of the particles not converged after it, in one launch (the pack,
then the kernel, mode ``SWEEP``), gated by a 0-d device flag ``run`` and
writing in place where it is given; each sweep on the card emits its
neighbour list into a ``SweepBuffers`` (``ops/gasd_pair.py``), as
``gasd_sweep`` does.  ``tsph_sweep_reference`` is its plain version.
Nothing between the iteration and the momentum set writes ``x y z h``
(TSPH's EOS, velocity gradient and switch), so where the iteration ended
converged the velocity gradient's and the momentum's launches
(``handoff=``, mode ``CONSUME``, linked by ``ops/pair_engine.py::
link_sweep``) read the last sweep's list and ``{x y z h}`` copy, bit for
bit the walk; elsewhere (the hand-off's ``use`` flag false, decided on the
card) they pack and walk.  On CPU tensors the plain versions walk.
"""

import ctypes
from typing import NamedTuple

import torch

from pysph_tpu_torch.base.kernels import kernel_kind
from pysph_tpu_torch.ops import build, cell_pack
from pysph_tpu_torch.ops import pair_link as pl
from pysph_tpu_torch.ops.build import data_ptr
from pysph_tpu_torch.ops.gasd_pair import SweepBuffers
from pysph_tpu_torch.ops.pair_sets import PhaseSets, fill_outputs

SDEN, GRADV, MOM = 1, 2, 4
#: phase sets, indexed by the phase id of the CUDA kernel
PHASE_SETS = (SDEN, GRADV, MOM)
DENSITY, GRADIENT, MOMENTUM = range(3)
MAX_SOURCES = 4
OUTPUTS = ('rho', 'arho', 'drhosumdh', 'n', 'an', 'dndh', 'invtt', 'gradv',
           'au', 'av', 'aw', 'ae')
#: the strided outputs' widths
WIDTH = {'invtt': 9, 'gradv': 9}
TERM_OUTPUTS = {SDEN: OUTPUTS[:6], GRADV: OUTPUTS[6:8], MOM: OUTPUTS[8:]}

_VEL = ('u', 'v', 'w')
_GRADH = ('n', 'dndh', 'drhosumdh')
#: props each set reads beyond x, y, z, h: (dest, source)
_SET_READS = {
    SDEN: (_VEL + ('prevn', 'prevdndh', 'prevdrhosumdh'), _VEL + ('m',)),
    GRADV: (_VEL, _VEL + ('m',)),
    MOM: (_VEL + ('m', 'rho', 'p', 'cs', 'alpha') + _GRADH,
          _VEL + ('m', 'rho', 'p', 'cs', 'alpha') + _GRADH)}
_DEST_PROPS = ('x', 'y', 'z', 'h') + _VEL + (
    'm', 'rho', 'p', 'cs', 'alpha') + _GRADH + (
        'prevn', 'prevdndh', 'prevdrhosumdh')
#: the kernel's modes (csrc/tsph_pair.cu TsphMode)
WALK, SWEEP, CONSUME = range(3)
#: what a sweep writes, in the kernel's order (csrc/tsph_pair.cu
#: TsphSweep): the sums, initialize's copies, then post_loop's
SWEEP_OUTPUTS = ('rho', 'arho', 'drhosumdh', 'n', 'an', 'dndh', 'prevn',
                 'prevdndh', 'prevdrhosumdh', 'h', 'ah', 'converged')
#: record planes of the packed copy (csrc/tsph_pair.cu): the density and
#: gradient sets pack planes 0 and 1, the momentum set all four, plane 3
#: then rewritten as ``mom_terms_reference`` gives
PACK_RECORDS = (('x', 'y', 'z', 'h'), ('u', 'v', 'w', 'm'),
                ('rho', 'p', 'cs', 'alpha'), ('n', 'dndh', 'drhosumdh', None))
_SETS = PhaseSets('tsph_pair', PHASE_SETS, _SET_READS, PACK_RECORDS,
                  MAX_SOURCES)
phase_of = _SETS.phase_of
_reads = _SETS.reads
pack_layout = _SETS.pack_layout
pack_sources = _SETS.pack_sources
pack_sources_reference = _SETS.pack_sources_reference
_phase = _SETS.phase
#: entries of a sweep's neighbour list a dest, by dim (``SweepBuffers``'
#: capacity): the accuracy test's hfact of 1.5 gives ~64 pairs a dest in
#: 2D, past ``pair_link.CAPACITY``; a dest past it makes its warp walk
CAPACITY = {1: 16, 2: 96, 3: 256}
#: the flags of the library that holds the kernels of each dimension
#: (none: the default library's 1D and 2D)
DIM_FLAGS = {1: (), 2: (), 3: ('-DTSPH_DIM3',)}


class TsphSource(NamedTuple):
    """One source of a dest's phase set: its term mask, the ``Equation``
    objects the terms stand for (the plain version runs them), and
    ``MomentumAndEnergy``'s ``beta`` and ``fkern``."""
    name: str
    terms: int
    equations: tuple
    beta: float = 0.0
    fkern: float = 1.0


class SweepSpec(NamedTuple):
    """The iterated density group's constants: its ``SummationDensity``
    (the plain version runs it) and that equation's ``hfact``, ``htol``,
    ``iterate_only_once`` and ``density_iterations``."""
    equation: object
    hfact: float
    htol: float
    iterate_once: bool
    density_iterations: bool


def sweep_spec(eq):
    """The ``SweepSpec`` of TSPH's ``SummationDensity``."""
    return SweepSpec(eq, eq.hfact, eq.htol, bool(eq.iterate_only_once),
                     bool(eq.density_iterations))


def kind_flags(kernel):
    """The flags of the library that holds ``kernel``'s shape beside
    ``build.launch``'s own: the default library holds the Gaussian (kind
    2) alone, so kinds 0, 1 and 3 take a library each too."""
    kind = kernel_kind(kernel)
    return ('-DPAIR_KIND=%d' % kind,) if kind is not None and \
        kind < build.BASE_KINDS and kind != 2 else ()


def library_flags(kernel):
    """The flags of the library that launches for ``kernel`` (its kind
    and its dimensions) beside ``build.launch``'s own."""
    return kind_flags(kernel) + DIM_FLAGS[kernel.dim]


def tsph_pair_reference(dest, dest_cells, write_mask, pre, sources, grid,
                        kernel, counts=False):
    """Plain torch version of ``tsph_pair``: the torch pair engine
    running each source's equations on the exact lists (wrapped, with
    minimum images, on a periodic grid).

    ``dest``: state dict of the dest array; ``dest_cells``: its
    ``CellList``; ``write_mask``: bool rows or None; ``pre``: {output:
    value before the phase}; ``sources``: [(state, CellList,
    TsphSource)]; ``grid``: the ``CellGrid`` of the cell lists;
    ``counts``: add ``nnbr``.  Returns {output: tensor}."""
    return _SETS.reference(dest, dest_cells, write_mask, pre, sources, grid,
                           kernel, counts=counts)


def mom_terms_reference(state, dim):
    """Plain version of a source's packed plane 3 in a momentum launch
    (``csrc/tsph_pair.cu`` ``tsph_terms_kernel``), in the state's order:
    (n, 4) of ``p / rho^2``, ``drhosumdh hj / (n dim)`` (inprthsj), ``1 +
    dndh hj / (n dim)`` (inbrktj) and 0, in ``MomentumAndEnergy``'s
    expressions."""
    rho = state['rho']
    hbyndim = state['h'] / (state['n'] * dim)
    return torch.stack([state['p'] / (rho * rho),
                        state['drhosumdh'] * hbyndim,
                        1 + state['dndh'] * hbyndim,
                        torch.zeros_like(rho)], dim=1)


class _SrcArgs(ctypes.Structure):
    _fields_ = [('plane', ctypes.c_void_p * len(PACK_RECORDS)),
                ('cell_start', ctypes.c_void_p),
                ('cell_end', ctypes.c_void_p),
                ('terms', ctypes.c_int32), ('base', ctypes.c_int32)]


class _Args(ctypes.Structure):
    _fields_ = ([(p, ctypes.c_void_p) for p in _DEST_PROPS] +
                [('cell', ctypes.c_void_p), ('dorder', ctypes.c_void_p),
                 ('wmask', ctypes.c_void_p),
                 ('pre', ctypes.c_void_p * len(OUTPUTS)),
                 ('out', ctypes.c_void_p * len(OUTPUTS)),
                 ('count', ctypes.c_void_p),
                 ('src', _SrcArgs * MAX_SOURCES)] +
                [(k, ctypes.c_double) for k in (
                    'radius_scale', 'kfac')] +
                [('box', ctypes.c_double * 3)] +
                [(k, ctypes.c_double) for k in (
                    'beta', 'fkern', 'hfact', 'htol')] +
                [(k, ctypes.c_int32) for k in (
                    'n_dest', 'n_src', 'nx', 'ny', 'nz', 'dim', 'phase',
                    'dtype', 'kernel_kind', 'periodic', 'mode', 'cap',
                    'iterate_once', 'density_iterations')] +
                [(k, ctypes.c_void_p) for k in ('run', 'use', 'h0')] +
                [('swpre', ctypes.c_void_p * len(SWEEP_OUTPUTS)),
                 ('sw', ctypes.c_void_p * len(SWEEP_OUTPUTS))] +
                [(k, ctypes.c_void_p) for k in ('unconv', 'nbr', 'lcount',
                                                'overflow')] +
                [('hplane', ctypes.c_void_p * MAX_SOURCES),
                 ('pack', cell_pack.PackArgs)])


def _common(args, dest, dest_cells, write_mask, sources, grid, kernel,
            phase, buf=None):
    """``PhaseSets.fill`` and the momentum set's constants; returns the
    packs' buffer."""
    buf = _SETS.fill(args, dest, dest_cells, write_mask, sources, grid,
                     kernel, phase, buf)
    ts = sources[0][2]
    if any(s.beta != ts.beta or s.fkern != ts.fkern for _, _, s in sources):
        raise ValueError('tsph_pair: sources of different constants')
    args.beta, args.fkern = ts.beta, ts.fkern
    return buf


def _launch(dest, dest_cells, write_mask, pre, sources, grid, kernel,
            counts, handoff=None):
    x = dest['x']
    dev, n = x.device, x.shape[0]
    phase = _phase(sources)
    terms = PHASE_SETS[phase]
    if set(pre) != set(TERM_OUTPUTS[terms]):
        raise ValueError('tsph_pair: pre values for %s, the set gives %s'
                         % (sorted(pre), TERM_OUTPUTS[terms]))
    args = _Args()
    buf = _common(args, dest, dest_cells, write_mask, sources, grid, kernel,
                  phase)
    out = fill_outputs(args, OUTPUTS, pre, x, counts, WIDTH)
    if handoff is not None:
        if phase == DENSITY:
            raise ValueError('tsph_pair: a hand-off given to a density call')
        pl.check_handoff('tsph_pair', handoff, dest, sources)
        if handoff.count is None or handoff.use is None:
            raise ValueError('tsph_pair: an empty hand-off on the card')
        plane0, _ = handoff.plane0()
        for k in range(len(sources)):
            args.hplane[k] = handoff.buf.data_ptr() + \
                plane0[k] * handoff.buf.element_size()
        args.mode = CONSUME
        args.use = data_ptr(handoff.use.view(1), 1, torch.bool, dev, 'use')
        args.nbr = data_ptr(handoff.nbr, handoff.nbr.shape[0],
                            torch.int32, dev, 'neighbour list', width=n)
        args.lcount = data_ptr(handoff.count, n, torch.int32, dev, 'counts')
        args.cap = handoff.nbr.shape[0]
    if n:
        build.launch('tsph_pair', args, dev, library_flags(kernel))
        tsph_pair.launches += 1
        tsph_pair.by_set[phase] += 1
        cell_pack.pack.launches += bool(args.pack.n_src)
    del buf  # held until the launch is queued
    return out


def tsph_pair(dest, dest_cells, write_mask, pre, sources, grid, kernel,
              counts=False, handoff=None):
    """Pair terms of one dest over its sources; same arguments and
    result as ``tsph_pair_reference``.  ``handoff``: a velocity gradient
    or momentum call's ``Handoff`` of the last density sweep
    (``tsph_sweep``), read where its ``use`` flag is set.  CPU tensors
    take the plain version (which walks); CUDA tensors launch the kernel
    or raise."""
    dev = dest['x'].device
    if dev.type == 'cpu':
        return tsph_pair_reference(dest, dest_cells, write_mask, pre,
                                   sources, grid, kernel, counts)
    if dev.type != 'cuda':
        raise ValueError('tsph_pair: no kernel for device %s' % dev)
    return _launch(dest, dest_cells, write_mask, pre, sources, grid, kernel,
                   counts, handoff)


def tsph_sweep_reference(dest, dest_cells, write_mask, sources, grid,
                         kernel, spec, run=None, buffers=None):
    """Plain torch version of ``tsph_sweep`` (same arguments and result):
    the ``SummationDensity`` of ``spec`` run as the evaluator runs it
    (``initialize``, the pair sums on the exact lists, ``post_loop``),
    the particles not converged after it counted; where ``run`` is false
    the props as they were and a count of 0.  Writes nothing in place
    and emits no list."""
    from pysph_tpu_torch.sph.acceleration_eval import _bind_particle_phase
    _phase(sources)
    eq = spec.equation
    store = dict(dest)
    _bind_particle_phase(eq.initialize, store, write_mask, 0.0, 0.0,
                         kernel=kernel)
    pre = {p: store[p] for p in TERM_OUTPUTS[SDEN]}
    store.update(tsph_pair_reference(store, dest_cells, write_mask, pre,
                                     sources, grid, kernel))
    _bind_particle_phase(eq.post_loop, store, write_mask, 0.0, 0.0,
                         kernel=kernel)
    out = {p: store[p] for p in SWEEP_OUTPUTS}
    unconv = (out['converged'] != 1.0).sum().to(torch.int32)
    if run is not None:
        out = {p: torch.where(run, v, dest[p]) for p, v in out.items()}
        unconv = torch.where(run, unconv, torch.zeros_like(unconv))
    return out, unconv


def _sweep_launch(dest, dest_cells, write_mask, sources, grid, kernel, spec,
                  run, buffers):
    x = dest['x']
    dev, fdt, n = x.device, x.dtype, x.shape[0]
    if _phase(sources) != DENSITY:
        raise ValueError('tsph_sweep: sources of another set')
    if buffers is None or not buffers.fits(dest, sources) or \
            buffers.nbr.shape[1] != n:
        raise ValueError('tsph_sweep: no SweepBuffers of these sources on '
                         'the card')
    args = _Args()
    _common(args, dest, dest_cells, write_mask, sources, grid, kernel,
            DENSITY, buffers.buf)
    # in place where gated (nothing written where run is false), else
    # into new tensors
    out = {}
    for k, p in enumerate(SWEEP_OUTPUTS):
        args.swpre[k] = data_ptr(dest[p], n, fdt, dev, 'd_' + p)
        out[p] = dest[p] if run is not None else torch.empty_like(dest[p])
        args.sw[k] = out[p].data_ptr()
    args.h0 = data_ptr(dest['h0'], n, fdt, dev, 'd_h0')
    if run is not None:
        if run.dtype != torch.bool or run.device != dev or run.numel() != 1:
            raise ValueError('tsph_sweep: run must be a bool scalar tensor '
                             'on %s' % dev)
        args.run = run.data_ptr()
    unconv = torch.zeros((), dtype=torch.int32, device=dev)
    args.unconv = unconv.data_ptr()
    args.nbr = buffers.nbr.data_ptr()
    args.lcount = buffers.count.data_ptr()
    args.overflow = pl.overflow_counter('tsph_pair', dev).data_ptr()
    args.cap = buffers.nbr.shape[0]
    args.mode = SWEEP
    args.hfact, args.htol = spec.hfact, spec.htol
    args.iterate_once = spec.iterate_once
    args.density_iterations = spec.density_iterations
    if n:
        build.launch('tsph_pair', args, dev, library_flags(kernel))
        tsph_sweep.launches += 1
        cell_pack.pack.launches += bool(args.pack.n_src)
    return out, unconv


def tsph_sweep(dest, dest_cells, write_mask, sources, grid, kernel, spec,
               run=None, buffers=None):
    """One sweep of the iterated density group of ``spec`` (a
    ``SweepSpec``) on the dest's state ``dest`` (its ``CellList``
    ``dest_cells``, the group's ``write_mask``) over the density set's
    ``sources`` ((state, ``CellList``, ``TsphSource``)); ``run``: a 0-d
    device bool that gates it (None: it runs); ``buffers``: the
    ``SweepBuffers`` it packs into and emits its list into (on the
    card).  Returns ({prop: tensor} of ``SWEEP_OUTPUTS``, the particles
    not converged after it as a 0-d int32 tensor).  CUDA tensors launch
    the kernel (in place where ``run`` is given) or raise; CPU tensors
    take the plain version."""
    dev = dest['x'].device
    if dev.type == 'cpu':
        return tsph_sweep_reference(dest, dest_cells, write_mask, sources,
                                    grid, kernel, spec, run, buffers)
    if dev.type != 'cuda':
        raise ValueError('tsph_sweep: no kernel for device %s' % dev)
    return _sweep_launch(dest, dest_cells, write_mask, sources, grid,
                         kernel, spec, run, buffers)


def overflowed(device):
    """The dests past the list's capacity that the sweeps counted since
    ``reset_overflow`` (reads the counter)."""
    return pl.overflowed('tsph_pair', device)


def reset_overflow(device):
    pl.reset_overflow('tsph_pair', device)


def reset_launches():
    """Set the launch counts of ``tsph_pair`` (and by set) and
    ``tsph_sweep`` to 0."""
    tsph_pair.launches = 0
    tsph_pair.by_set = [0] * len(PHASE_SETS)
    tsph_sweep.launches = 0


#: kernel launches since the last reset (``reset_launches``): of
#: ``tsph_pair``, by phase id (density, gradient, momentum), and of
#: ``tsph_sweep``
reset_launches()
