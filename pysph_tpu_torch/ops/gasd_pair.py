"""The gas-dynamics pair kernel: wrapper, launch counter and plain version.

``gasd_pair`` runs the pair terms of one dest array over all its sources
(at most ``MAX_SOURCES``) in one call, for one of the two phase sets of
``GasDScheme``'s MPM groups (``sph/gas_dynamics/basic.py``: the shock
tube and the Sedov blast of ``examples/gas_dynamics/``) or of
``ADKEScheme``'s (the shock tube, the accuracy test and the hydrostatic
box's ``--scheme adke``):

==========  ==============================================  =============
phase set   terms (equations)                               outputs
==========  ==============================================  =============
DENSITY     SDEN (``SummationDensity``): WI, DWI, GHI at    rho arho
            the dest's h                                    grhox-z dwdh
MOMENTUM    MPM (``MPMAccelerations``): DWI, DWJ, DWIJ at   au av aw ae
            the dest's, the source's and the mean h         del2e dt_cfl
ADKE        ADEN (``SummationDensityADKE``): WIJ at the     rho arho
DENSITY     mean h, DWI at the dest's
ADKE        ADKE (``ADKEAccelerations``): DWIJ at the mean  au av aw ae
ACCEL       h, Monaghan's viscosity, the ADKE conduction
==========  ==============================================  =============

Each output is ``pre + sum`` (``dt_cfl``: ``max(pre, max over pairs)``)
on rows under the write mask and ``pre`` elsewhere; every read sees the
value from before the phase.  h varies per particle: a pair is in support
where ``r < radius_scale max(hi, hj)``.  Every kernel with a
``kernel_kind`` (``csrc/shapes.cuh``; the scheme's default is the
Gaussian, kind 2; not the ``_1D`` kernels, ROADMAP Queue 1 item 28); the
grid may be periodic.  ``counts=True`` adds ``nnbr``, each dest's pairs
in support (int32), to the result.

For CUDA tensors it calls ``csrc/gasd_pair.cu`` (the MPM sets) or
``csrc/adke_pair.cu`` (the ADKE sets; each a library of its own, built on
first use by ``ops/build.py``) once: its launch function launches the
source pack (``ops/cell_pack.py``, counted in ``cell_pack.pack.launches``)
and then the kernel (counted in ``gasd_pair.launches``, and the ADKE
library's also in ``gasd_pair.adke_launches``; each later kind a library
of its own, built at its first launch); a kernel without a
``kernel_kind``, a dtype other than float32 and float64, or a refused
launch raises.  The ADKE accelerations' launch rewrites each source's
packed plane 3 with the terms of the source alone (``adke_terms_reference``
is its plain version) before its kernel.  For CPU tensors it calls
``gasd_pair_reference``, the torch pair engine running the same
``Equation`` objects on the exact lists of ``CellGrid.neighbor_pairs``.

``gasd_sweep`` runs one sweep of ``GasDScheme``'s iterated density group
(``Group([SummationDensity(..., density_iterations=True)], iterate=True,
update_nnps=True)``): ``initialize``, the pair sums, ``post_loop`` (the
Newton step of each unconverged particle's h) and the count of the
particles not converged after it, in one launch (the pack, then the
kernel, in mode ``SWEEP``), gated by a 0-d device flag ``run`` (none of
it runs where it is false, and then the dest's props stay as they were,
bit for bit) and writing in place where it is given;
``gasd_sweep_reference`` is its plain version (the torch phases of the
``Equation``).  Each sweep on the card emits its neighbour list into a
``SweepBuffers`` (its pack, the list, each dest's count), so the list
left is the last sweep's.  Positions do not move during the iteration,
and a sweep that leaves every particle converged leaves every h as it
was, so where the iteration ended so, the last sweep saw exactly the
momentum launch's pairs: ``gasd_pair(..., handoff=)`` (mode ``CONSUME``,
the ``MPMAccelerations`` launch that ``ops/pair_engine.py::link_sweep``
links to the sweep) then packs only planes 1-3 and reads the list and
the sweep's ``{x y z h}`` copy, bit for bit the walk, and otherwise (the
hand-off's ``use`` flag false, decided on the card) packs and walks.
On CPU tensors the plain versions walk and the hand-off is empty.
"""

import ctypes
from typing import NamedTuple

import torch

from pysph_tpu_torch.ops import build, cell_pack
from pysph_tpu_torch.ops import pair_link as pl
from pysph_tpu_torch.ops.build import data_ptr
from pysph_tpu_torch.ops.pair_sets import PhaseSets, fill_outputs

SDEN, MPM, ADEN, ADKE = 1, 2, 4, 8
#: phase sets, indexed by the phase id of the CUDA kernel
PHASE_SETS = (SDEN, MPM, ADEN, ADKE)
DENSITY, MOMENTUM, ADKE_DENSITY, ADKE_ACCEL = range(4)
MAX_SOURCES = 4
OUTPUTS = ('rho', 'arho', 'grhox', 'grhoy', 'grhoz', 'dwdh', 'au', 'av',
           'aw', 'ae', 'del2e', 'dt_cfl')
TERM_OUTPUTS = {SDEN: OUTPUTS[:6], MPM: OUTPUTS[6:], ADEN: OUTPUTS[:2],
                ADKE: OUTPUTS[6:10]}

_VEL = ('u', 'v', 'w')
#: props each set reads beyond x, y, z, h: (dest, source)
_SET_READS = {
    SDEN: (_VEL, _VEL + ('m',)),
    MPM: (_VEL + ('rho', 'p', 'cs', 'e', 'omega', 'alpha1', 'alpha2'),
          _VEL + ('m', 'rho', 'p', 'cs', 'e', 'omega', 'alpha1',
                  'alpha2')),
    ADEN: (_VEL, _VEL + ('m',)),
    ADKE: (_VEL + ('rho', 'p', 'cs', 'e', 'div'),
           _VEL + ('m', 'rho', 'p', 'cs', 'e', 'div'))}
_DEST_PROPS = ('x', 'y', 'z', 'h') + _VEL + (
    'rho', 'p', 'cs', 'e', 'omega', 'alpha1', 'alpha2', 'div')
#: the kernel's modes (csrc/gasd_pair.cu GasdMode)
WALK, SWEEP, CONSUME = range(3)
#: what a sweep writes, in the kernel's order (csrc/gasd_pair.cu
#: GasdSweep): the density sums, then initialize's and post_loop's
SWEEP_OUTPUTS = ('rho', 'arho', 'grhox', 'grhoy', 'grhoz', 'dwdh', 'div',
                 'omega', 'h', 'ah', 'converged')
#: record planes of the packed copy (csrc/gasd_pair.cu, csrc/adke_pair.cu):
#: the density sets pack planes 0 and 1, the momentum sets all four (the
#: ADKE accelerations' plane 3, packed as 0 0 0 div, then rewritten as
#: ``adke_terms_reference`` gives)
PACK_RECORDS = (('x', 'y', 'z', 'h'), ('u', 'v', 'w', 'm'),
                ('rho', 'p', 'cs', 'e'), ('omega', 'alpha1', 'alpha2', 'div'))
_SETS = PhaseSets('gasd_pair', PHASE_SETS, _SET_READS, PACK_RECORDS,
                  MAX_SOURCES)
phase_of = _SETS.phase_of
_reads = _SETS.reads
pack_layout = _SETS.pack_layout
pack_sources = _SETS.pack_sources
pack_sources_reference = _SETS.pack_sources_reference
_phase = _SETS.phase


class GasdSource(NamedTuple):
    """One source of a dest's phase set: its term mask, the ``Equation``
    objects the terms stand for (the plain version runs them),
    ``MPMAccelerations``' or ``ADKEAccelerations``' ``beta`` and the
    latter's ``alpha``, ``g1`` and ``g2``."""
    name: str
    terms: int
    equations: tuple
    beta: float = 0.0
    alpha: float = 0.0
    g1: float = 0.0
    g2: float = 0.0


class SweepSpec(NamedTuple):
    """The iterated density group's constants: its ``SummationDensity``
    (the plain version runs it) and that equation's ``k``, ``htol``,
    ``iterate_only_once`` and ``density_iterations``."""
    equation: object
    k: float
    htol: float
    iterate_once: bool
    density_iterations: bool


def sweep_spec(eq):
    """The ``SweepSpec`` of a gas-dynamics ``SummationDensity``."""
    return SweepSpec(eq, eq.k, eq.htol, bool(eq.iterate_only_once),
                     bool(eq.density_iterations))


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
    return _SETS.reference(dest, dest_cells, write_mask, pre, sources, grid,
                           kernel, counts=counts)


def adke_terms_reference(state, source):
    """Plain version of the ADKE accelerations' plane 3 of a source (its
    state dict and ``GasdSource``), as ``csrc/adke_pair.cu`` writes it
    into the packed copy before its kernel, in the state's order: (n, 4)
    of ``p / rho^2``, ``g1 h cs + g2 h^2 (|div| - div)`` (``Hj``), 0 and
    ``div``, in ``ADKEAccelerations``' expressions."""
    rho, h, div = state['rho'], state['h'], state['div']
    pjbrhoj2 = state['p'] / (rho * rho)
    big_hj = source.g1 * h * state['cs'] + \
        source.g2 * h * h * (torch.abs(div) - div)
    return torch.stack([pjbrhoj2, big_hj, torch.zeros_like(div), div],
                       dim=1)


class _SrcArgs(ctypes.Structure):
    _fields_ = [('plane', ctypes.c_void_p * len(PACK_RECORDS)),
                ('cell_start', ctypes.c_void_p),
                ('cell_end', ctypes.c_void_p),
                ('beta', ctypes.c_double), ('alpha', ctypes.c_double),
                ('g1', ctypes.c_double), ('g2', ctypes.c_double),
                ('terms', ctypes.c_int32), ('base', ctypes.c_int32)]


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
                    'dtype', 'kernel_kind', 'periodic', 'mode', 'cap')] +
                [(k, ctypes.c_void_p) for k in ('run', 'use', 'm', 'h0')] +
                [('swpre', ctypes.c_void_p * len(SWEEP_OUTPUTS)),
                 ('sw', ctypes.c_void_p * len(SWEEP_OUTPUTS))] +
                [(k, ctypes.c_void_p) for k in ('unconv', 'nbr', 'lcount',
                                                'overflow')] +
                [('hplane', ctypes.c_void_p * MAX_SOURCES),
                 ('k', ctypes.c_double), ('htol', ctypes.c_double),
                 ('iterate_once', ctypes.c_int32),
                 ('density_iterations', ctypes.c_int32),
                 ('pack', cell_pack.PackArgs)])


def _common(args, dest, dest_cells, write_mask, sources, grid, kernel,
            phase, buf=None):
    """``PhaseSets.fill``, and each source's viscosity and conduction
    constants; returns the packs' buffer."""
    buf = _SETS.fill(args, dest, dest_cells, write_mask, sources, grid,
                     kernel, phase, buf)
    for k, (_, _, gs) in enumerate(sources):
        sa = args.src[k]
        sa.beta, sa.alpha = gs.beta, gs.alpha
        sa.g1, sa.g2 = gs.g1, gs.g2
    return buf


def _launch(dest, dest_cells, write_mask, pre, sources, grid, kernel,
            counts, handoff=None):
    x = dest['x']
    dev, n = x.device, x.shape[0]
    phase = _phase(sources)
    terms = PHASE_SETS[phase]
    if set(pre) != set(TERM_OUTPUTS[terms]):
        raise ValueError('gasd_pair: pre values for %s, the set gives %s'
                         % (sorted(pre), TERM_OUTPUTS[terms]))
    args = _Args()
    buf = _common(args, dest, dest_cells, write_mask, sources, grid, kernel,
                  phase)
    out = fill_outputs(args, OUTPUTS, pre, x, counts)
    if handoff is not None:
        if phase != MOMENTUM:
            raise ValueError('gasd_pair: a hand-off given to a density call')
        pl.check_handoff('gasd_pair', handoff, dest, sources)
        if handoff.count is None or handoff.use is None:
            raise ValueError('gasd_pair: an empty hand-off on the card')
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
        adke = phase in (ADKE_DENSITY, ADKE_ACCEL)
        build.launch('adke_pair' if adke else 'gasd_pair', args, dev)
        gasd_pair.launches += 1
        gasd_pair.adke_launches += adke
        cell_pack.pack.launches += bool(args.pack.n_src)
    return out


def gasd_pair(dest, dest_cells, write_mask, pre, sources, grid, kernel,
              counts=False, handoff=None):
    """Pair terms of one dest over its sources; same arguments and
    result as ``gasd_pair_reference``.  ``handoff``: a momentum call's
    ``Handoff`` of the last density sweep (``gasd_sweep``), read where
    its ``use`` flag is set.  CPU tensors take the plain version (which
    walks); CUDA tensors launch the kernel or raise."""
    dev = dest['x'].device
    if dev.type == 'cpu':
        return gasd_pair_reference(dest, dest_cells, write_mask, pre,
                                   sources, grid, kernel, counts)
    if dev.type != 'cuda':
        raise ValueError('gasd_pair: no kernel for device %s' % dev)
    return _launch(dest, dest_cells, write_mask, pre, sources, grid, kernel,
                   counts, handoff)


class SweepBuffers(object):
    """What the sweeps of one iterated group write besides the dest's
    props, kept across its sweeps (and a CUDA graph's replays): ``buf``,
    the sources' packed planes 0 and 1 (``cell_pack.fill``'s layout);
    ``nbr`` (``capacity``, default ``pair_link.CAPACITY[dim]``, n) and
    ``count`` (n,), the neighbour list; ``sources``: ((name, particles),
    ...)."""

    def __init__(self, dest, sources, dim, capacity=None):
        x = dest['x']
        n, dev = x.shape[0], x.device
        self.sources = pl.copies_of(sources)
        self.buf = torch.empty(sum(2 * 4 * ns for _, ns in self.sources),
                               dtype=x.dtype, device=dev)
        self.nbr = torch.empty((capacity or pl.CAPACITY[dim], n),
                               dtype=torch.int32, device=dev)
        self.count = torch.zeros(n, dtype=torch.int32, device=dev)

    def fits(self, dest, sources):
        x = dest['x']
        return self.sources == pl.copies_of(sources) and \
            self.buf.dtype == x.dtype and self.buf.device == x.device

    def handoff(self, use):
        """The ``Handoff`` of the last sweep, read where ``use`` (a 0-d
        device bool) is set."""
        return pl.Handoff(self.buf, self.nbr, self.count, self.sources,
                          (2,) * len(self.sources), use)


def gasd_sweep_reference(dest, dest_cells, write_mask, sources, grid,
                         kernel, spec, run=None, buffers=None):
    """Plain torch version of ``gasd_sweep`` (same arguments and result):
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
    store.update(gasd_pair_reference(store, dest_cells, write_mask, pre,
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
        raise ValueError('gasd_sweep: sources of the momentum set')
    if buffers is None or not buffers.fits(dest, sources) or \
            buffers.nbr.shape[1] != n:
        raise ValueError('gasd_sweep: no SweepBuffers of these sources on '
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
    args.m = data_ptr(dest['m'], n, fdt, dev, 'd_m')
    args.h0 = data_ptr(dest['h0'], n, fdt, dev, 'd_h0')
    if run is not None:
        if run.dtype != torch.bool or run.device != dev or run.numel() != 1:
            raise ValueError('gasd_sweep: run must be a bool scalar tensor '
                             'on %s' % dev)
        args.run = run.data_ptr()
    unconv = torch.zeros((), dtype=torch.int32, device=dev)
    args.unconv = unconv.data_ptr()
    args.nbr = buffers.nbr.data_ptr()
    args.lcount = buffers.count.data_ptr()
    args.overflow = pl.overflow_counter('gasd_pair', dev).data_ptr()
    args.cap = buffers.nbr.shape[0]
    args.mode = SWEEP
    args.k, args.htol = spec.k, spec.htol
    args.iterate_once = spec.iterate_once
    args.density_iterations = spec.density_iterations
    if n:
        build.launch('gasd_pair', args, dev)
        gasd_sweep.launches += 1
        cell_pack.pack.launches += bool(args.pack.n_src)
    return out, unconv


def gasd_sweep(dest, dest_cells, write_mask, sources, grid, kernel, spec,
               run=None, buffers=None):
    """One sweep of the iterated density group of ``spec`` (a
    ``SweepSpec``) on the dest's state ``dest`` (its ``CellList``
    ``dest_cells``, the group's ``write_mask``) over the density set's
    ``sources`` ((state, ``CellList``, ``GasdSource``)); ``run``: a 0-d
    device bool that gates it (None: it runs); ``buffers``: the
    ``SweepBuffers`` it packs into and emits its list into (on the
    card).  Returns ({prop: tensor} of ``SWEEP_OUTPUTS``, the particles
    not converged after it as a 0-d int32 tensor).  CUDA tensors launch
    the kernel (in place where ``run`` is given) or raise; CPU tensors
    take the plain version."""
    dev = dest['x'].device
    if dev.type == 'cpu':
        return gasd_sweep_reference(dest, dest_cells, write_mask, sources,
                                    grid, kernel, spec, run, buffers)
    if dev.type != 'cuda':
        raise ValueError('gasd_sweep: no kernel for device %s' % dev)
    return _sweep_launch(dest, dest_cells, write_mask, sources, grid,
                         kernel, spec, run, buffers)


#: kernel launches since the last reset (set to 0 to reset): of either
#: library, and of ``csrc/adke_pair.cu``'s alone
gasd_pair.launches = 0
gasd_pair.adke_launches = 0


#: kernel launches since the last reset (set to 0 to reset)
gasd_sweep.launches = 0
