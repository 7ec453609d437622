"""The delta-SPH pre-phase kernel: wrapper, launch counter and plain
version.

``delta_pair`` runs one of the two pair phases that delta-SPH adds
before the main group, for one dest array over all its sources (at most
``MAX_SOURCES``), in one call.  Each source's term mask is one of

- ``MMAT``: the moment matrix, ``m_mat[3a+b] += -V_j DWIJ[a] XIJ[b]``
  for ``a, b < dim`` (``GradientCorrectionPreStep(dim)``);
- ``CORR | GRAD``: ``GradientCorrection(dim, tol)`` rewrites ``DWIJ``
  with the dest's ``m_mat``, pair by pair, then
  ``ContinuityEquationDeltaSPHPreStep`` sums ``gradrho += (rho_j -
  rho_i) V_j DWIJ`` with it;
- ``GRAD``: the same sum on the uncorrected ``DWIJ``;

and every source of a call takes the same one (``DeltaSource``: its
``dim`` is the moment's or the correction's, as the equation was built;
``WCSPHScheme`` builds the correction without ``dim``, so in 3D it
corrects two components, as the reference does).  The output, ``m_mat``
(n, 9) or ``gradrho`` (n, 3), is ``pre + sum`` on rows under the write
mask and ``pre`` elsewhere.  The two phases are two groups of the
evaluator (the moment group writes every row, the gradient group only
real ones), so a step's eval launches ``delta_pair`` twice for each
fluid.  The grid may be periodic (the Taylor-Green vortex's
``--delta-sph``): the kernel then walks the wrapped stencil and takes the
minimum image of every displacement, rounded as the plain version's
(``csrc/cell_walk.cuh::walk_rows_periodic``, a template flag, so the
kernel on an open grid keeps the plain walk).

The linked pair.  Where the gradient group follows the moment group
with the same dest and sources and nothing between them moves ``x y z h
m rho`` (``ops/pair_engine.py::link_pairs``), the two plans share a
``Link`` (``ops/pair_link.py``): the moment call runs with ``emit=True``
and returns, beside its output, a ``Handoff``: the sources' packed
copies and the neighbour list, up to ``CAPACITY[dim]`` a dest.  The
gradient call takes it (``handoff=``): it packs nothing and reads the
listed records instead of walking, so its sums are the walk's bit for
bit; a warp holding a dest past the capacity walks as an unlinked call.
The moment launch counts such dests on the card (``overflowed``).  A
linked gradient plan run without its hand-off raises.

For CUDA tensors it calls ``csrc/delta_pair.cu`` (built on first use by
``ops/build.py``, without FMA contraction) once: its launch function
launches the source pack (``ops/cell_pack.py``, counted in
``cell_pack.pack.launches``; none for a call given a hand-off) and then
the kernel (counted in ``delta_pair.launches``).  For CPU tensors it
calls ``delta_pair_reference``, the torch pair engine on the same
equations, which walks for the gradient too: an emitting call returns
an empty hand-off.  The kernel evaluates ``DWIJ``, the solve and
the accept test in the plain version's operations and order, so that
both take the same decision on the same inputs; ``accepted`` counts
them per dest.
"""

import ctypes
from typing import NamedTuple

import torch

from pysph_tpu_torch.base.kernels import kernel_kind
from pysph_tpu_torch.ops import build, cell_pack, pair_link
from pysph_tpu_torch.ops.build import data_ptr
from pysph_tpu_torch.ops.pair_link import CAPACITY, Handoff
from pysph_tpu_torch.sph.wc.basic import ContinuityEquationDeltaSPHPreStep
from pysph_tpu_torch.sph.wc.kernel_correction import (
    GradientCorrection, GradientCorrectionPreStep, accept)

MMAT, CORR, GRAD = 1, 2, 4
MAX_SOURCES = 4
#: the term masks a call may hold
TERM_SETS = (MMAT, CORR | GRAD, GRAD)
#: the kernel's modes (csrc/delta_pair.cu kWalk, kEmit, kConsume)
WALK, EMIT, CONSUME = 0, 1, 2
#: record planes of the packed copy (csrc/delta_pair.cu)
PACK_RECORDS = (('x', 'y', 'z', 'h'), ('m', 'rho', None, None))
_READS = frozenset(('x', 'y', 'z', 'h', 'm', 'rho'))


class DeltaSource(NamedTuple):
    """One source of a ``delta_pair`` call: its term mask, the ``dim`` of
    its moment matrix (``MMAT``) or correction (``CORR``) and the
    correction's ``tol``."""
    name: str
    terms: int
    dim: int = 0
    tol: float = 0.1


def outputs_for(terms):
    return ('m_mat',) if terms & MMAT else ('gradrho',)


def _equations(ds):
    """The Equation objects a ``DeltaSource`` stands for."""
    if ds.terms == MMAT:
        return [GradientCorrectionPreStep('dest', [ds.name], dim=ds.dim)]
    eqs = [ContinuityEquationDeltaSPHPreStep('dest', [ds.name])]
    if ds.terms & CORR:
        eqs.insert(0, GradientCorrection('dest', [ds.name], dim=ds.dim,
                                         tol=ds.tol))
    return eqs


def _check_sources(sources):
    if not sources or len(sources) > MAX_SOURCES:
        raise ValueError('delta_pair: %d sources' % len(sources))
    first = sources[0][2]
    for _, _, ds in sources:
        if ds.terms not in TERM_SETS or \
                (ds.terms, ds.dim, ds.tol) != (first.terms, first.dim,
                                               first.tol):
            raise ValueError('delta_pair: sources %s' % [
                s[2] for s in sources])
        if ds.terms & (MMAT | CORR) and not 1 <= ds.dim <= 3:
            raise ValueError('delta_pair: dim %d' % ds.dim)
    return first


def delta_pair_reference(dest, dest_cells, write_mask, pre, sources, grid,
                         kernel):
    """Plain torch version of ``delta_pair``: the torch pair engine
    running the equations the term masks stand for.

    ``dest``: state dict of the dest array (its ``m_mat`` is the
    correction's matrix); ``dest_cells``: its ``CellList``;
    ``write_mask``: bool rows or None; ``pre``: {output: value before the
    phase}; ``sources``: [(state, CellList, DeltaSource)]; ``grid``: the
    ``CellGrid`` of the cell lists.  Returns {output: tensor}."""
    from pysph_tpu_torch.sph.acceleration_eval import run_pair_phase
    _check_sources(sources)
    store = dict(dest)
    store.update(pre)
    for src, src_cells, ds in sources:
        run_pair_phase(_equations(ds), store, src, dest_cells, src_cells,
                       grid, kernel, write_mask, 0.0, 0.0)
    return {p: store[p] for p in pre}


def accepted_reference(dest, dest_cells, sources, grid, kernel):
    """Per dest, the pairs whose correction the plain version accepts
    (``CORR`` sources; int32, 0 without a correction)."""
    from pysph_tpu_torch.sph.acceleration_eval import (
        PAIR_CHUNK, PairContext)
    from pysph_tpu_torch.sph.equation import IndexSym
    n = dest['x'].shape[0]
    count = torch.zeros(n, dtype=torch.int64, device=dest['x'].device)
    d_idx = IndexSym('dest')
    for src, src_cells, ds in sources:
        if not ds.terms & CORR:
            continue
        for a in range(0, n, PAIR_CHUNK):
            i, j = grid.neighbor_pairs(dest, dest_cells, src, src_cells,
                                       (a, min(n, a + PAIR_CHUNK)))
            ctx = PairContext(dest, src, i, j, kernel, None, grid=grid)
            m = [[ctx.dget('m_mat', 9 * d_idx + 3 * r + c)
                  for c in range(ds.dim)] for r in range(ds.dim)]
            _, ok = accept(m, ctx.sym('DWIJ'), ctx.sym('HIJ'), ds.dim,
                           ds.tol)
            count.index_add_(0, i, ok.long())
    return count.to(torch.int32)


def overflowed(device):
    """The dests past the capacity counted since the last
    ``reset_overflow`` (reads the counter)."""
    return pair_link.overflowed('delta_pair', device)


def reset_overflow(device):
    pair_link.reset_overflow('delta_pair', device)


class Link(pair_link.Link):
    """A moment plan (the emitter) and the gradient plan of the group
    after it (the consumer)."""

    @property
    def moment(self):
        return self.emitter

    @property
    def gradient(self):
        return self.consumer


def pack_layout():
    """Prop names of the record planes of a source's packed copy."""
    return cell_pack.layout(PACK_RECORDS, _READS)[1]


def _packs(sources):
    planes = pack_layout()
    return [(src, cells.order, planes) for src, cells, _ in sources]


def pack_sources_reference(sources):
    """Plain torch version of ``pack_sources``."""
    return cell_pack.pack_reference(_packs(sources))


def pack_sources(sources):
    """The packed copy of every source of a call (``cell_pack.pack``)."""
    return cell_pack.pack(_packs(sources))


class _SrcArgs(ctypes.Structure):
    _fields_ = [('pos', ctypes.c_void_p), ('mass', ctypes.c_void_p),
                ('cell_start', ctypes.c_void_p),
                ('cell_end', ctypes.c_void_p), ('base', ctypes.c_int32),
                ('pad', ctypes.c_int32)]


class DeltaArgs(ctypes.Structure):
    _fields_ = ([(p, ctypes.c_void_p) for p in (
                    'x', 'y', 'z', 'h', 'rho', 'm_mat')] +
                [('cell', ctypes.c_void_p), ('dorder', ctypes.c_void_p),
                 ('dcell_start', ctypes.c_void_p),
                 ('dcell_end', ctypes.c_void_p), ('wmask', ctypes.c_void_p),
                 ('pre', ctypes.c_void_p), ('out', ctypes.c_void_p),
                 ('accepted', ctypes.c_void_p), ('nbr', ctypes.c_void_p),
                 ('count', ctypes.c_void_p), ('overflow', ctypes.c_void_p),
                 ('src', _SrcArgs * MAX_SOURCES),
                 ('radius_scale', ctypes.c_double),
                 ('kfac', ctypes.c_double), ('tol', ctypes.c_double),
                 ('box', ctypes.c_double * 3)] +
                [(k, ctypes.c_int32) for k in (
                    'n_dest', 'n_src', 'nx', 'ny', 'nz', 'dim',
                    'kernel_kind', 'dtype', 'terms', 'mdim', 'mode',
                    'cap', 'periodic')] +
                [('pack', cell_pack.PackArgs)])


#: the outputs' strides
_WIDTH = {'m_mat': 9, 'gradrho': 3}


def _check_mode(first, emit, handoff, dest, sources):
    """Raise unless a moment call emits or not and a gradient call takes
    a hand-off or not, one that ``sources`` on ``dest``'s device
    emitted for as many dests."""
    if emit and (handoff is not None or first.terms != MMAT):
        raise ValueError('delta_pair: only a moment call emits a hand-off')
    if handoff is None:
        return
    if first.terms == MMAT:
        raise ValueError('delta_pair: a moment call takes no hand-off')
    pair_link.check_handoff('delta_pair', handoff, dest, sources)


def delta_args(dest, dest_cells, write_mask, pre, sources, grid, kernel,
               accepted=None, emit=False, handoff=None, capacity=None):
    """Check the arguments of a ``delta_pair`` call and fill them in, with
    the pack that its launch function runs before the walk (none where
    ``handoff`` gives the copies).  Returns (args, {output: empty
    tensor}, the hand-off emitted or given, else the buffer of the
    packed copies), the last of which must stay referenced until the
    launch is queued."""
    x = dest['x']
    dev, fdt, n = x.device, x.dtype, x.shape[0]
    if fdt not in (torch.float32, torch.float64):
        raise ValueError('delta_pair: dtype %s' % fdt)
    kind = kernel_kind(kernel)
    if kind is None:
        raise ValueError('delta_pair: no shape function for %r' % kernel)
    first = _check_sources(sources)
    (output,) = outputs_for(first.terms)
    if pre.keys() != {output}:
        raise ValueError('delta_pair: pre values for %s, terms give %s'
                         % (sorted(pre), output))
    _check_mode(first, emit, handoff, dest, sources)
    i32 = torch.int32
    args = DeltaArgs()
    packs = _packs(sources)
    buf = cell_pack.fill(args.pack, packs, 'delta_pair') \
        if handoff is None else handoff.buf
    base = 0
    for k, (copy, (src, cells, _)) in enumerate(
            zip(cell_pack.copies(buf, packs), sources)):
        sa = args.src[k]
        sa.pos, sa.mass = copy[0].data_ptr(), copy[1].data_ptr()
        sa.cell_start = data_ptr(cells.start, grid.ncells, i32, dev,
                                 'cell_start')
        sa.cell_end = data_ptr(cells.end, grid.ncells, i32, dev, 'cell_end')
        sa.base = base
        base += src['x'].shape[0]
    for p in ('x', 'y', 'z', 'h') + (('rho',) if first.terms & GRAD
                                     else ()):
        setattr(args, p, data_ptr(dest[p], n, fdt, dev, 'd_' + p))
    if first.terms & CORR:
        args.m_mat = data_ptr(dest['m_mat'], n, fdt, dev, 'd_m_mat',
                              width=9)
    args.cell = data_ptr(dest_cells.cell, n, i32, dev, 'dest cell')
    args.dorder = data_ptr(dest_cells.order, n, i32, dev, 'dest order')
    args.dcell_start = data_ptr(dest_cells.start, grid.ncells, i32, dev,
                                'dest cell_start')
    args.dcell_end = data_ptr(dest_cells.end, grid.ncells, i32, dev,
                              'dest cell_end')
    if write_mask is not None:
        args.wmask = data_ptr(write_mask, n, torch.bool, dev, 'write mask')
    args.pre = data_ptr(pre[output], n, fdt, dev, 'pre ' + output,
                        width=_WIDTH[output])
    out = {output: torch.empty_like(pre[output])}
    args.out = out[output].data_ptr()
    if accepted is not None:
        args.accepted = data_ptr(accepted, n, i32, dev, 'accepted')
    if emit:
        cap = capacity or CAPACITY[kernel.dim]
        handoff = Handoff(buf, torch.empty((cap, n), dtype=i32, device=dev),
                          torch.empty(n, dtype=i32, device=dev),
                          pair_link.copies_of(sources))
        args.overflow = pair_link.overflow_counter('delta_pair',
                                                   dev).data_ptr()
        args.mode = EMIT
    elif handoff is not None:
        args.mode = CONSUME
    if handoff is not None:
        args.nbr = data_ptr(handoff.nbr, handoff.nbr.shape[0], i32, dev,
                            'neighbour list', width=n)
        args.count = data_ptr(handoff.count, n, i32, dev, 'counts')
        args.cap = handoff.nbr.shape[0]
    args.radius_scale = grid.radius_scale
    args.kfac = kernel.fac
    args.tol = first.tol
    if grid.is_periodic:
        # the box lengths of the periodic axes, each the dtype's value
        lengths = grid.box_host(fdt)['lengths']
        for d, per in enumerate(grid.periodic):
            args.box[d] = lengths[d] if per else 0.0
        args.periodic = 1
    args.n_dest, args.n_src = n, len(sources)
    args.nx, args.ny, args.nz = grid.dims
    args.dim = kernel.dim
    args.kernel_kind = kind
    args.dtype = 1 if fdt == torch.float64 else 0
    args.terms = first.terms
    args.mdim = first.dim if first.terms & (MMAT | CORR) else 0
    return args, out, buf if handoff is None else handoff


def delta_pair(dest, dest_cells, write_mask, pre, sources, grid, kernel,
               accepted=None, emit=False, handoff=None, capacity=None):
    """One delta-SPH pre-phase of one dest over its sources; same
    arguments and result as ``delta_pair_reference``.  ``accepted``: an
    int32 tensor of a count per dest, to be filled with the pairs whose
    correction was accepted.  ``emit`` (a moment call): return (result,
    ``Handoff``); ``handoff`` (a gradient call): read that hand-off's
    copies and neighbour list instead of packing and walking;
    ``capacity``: the neighbour list's entries a dest for ``emit``, for
    tests (default ``CAPACITY[kernel.dim]``).  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    dev = dest['x'].device
    if dev.type == 'cpu':
        return _plain(dest, dest_cells, write_mask, pre, sources, grid,
                      kernel, accepted, emit, handoff, capacity)
    if dev.type != 'cuda':
        raise ValueError('delta_pair: no kernel for device %s' % dev)
    # the copies (and the list) stay referenced until the launch is queued
    args, out, kept = delta_args(dest, dest_cells, write_mask, pre, sources,
                                 grid, kernel, accepted, emit, handoff,
                                 capacity)
    if args.n_dest:
        build.launch('delta_pair', args, dev)
        delta_pair.launches += 1
        cell_pack.pack.launches += bool(args.pack.n_src)
    return (out, kept) if emit else out


def _plain(dest, dest_cells, write_mask, pre, sources, grid, kernel,
           accepted, emit, handoff, capacity):
    """``delta_pair`` on CPU tensors: the plain version, with an empty
    hand-off where it emits one."""
    _check_mode(_check_sources(sources), emit, handoff, dest, sources)
    out = delta_pair_reference(dest, dest_cells, write_mask, pre, sources,
                               grid, kernel)
    if accepted is not None:
        accepted.copy_(accepted_reference(dest, dest_cells, sources, grid,
                                          kernel))
    if not emit:
        return out
    # the plain gradient walks: its hand-off carries no copies and no list
    return out, pair_link.empty_handoff(dest, sources)


#: kernel launches since the last reset (set to 0 to reset)
delta_pair.launches = 0
