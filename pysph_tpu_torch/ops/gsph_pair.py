"""The Godunov SPH pair kernel: wrapper, launch counter and plain version.

``gsph_pair`` runs the pair terms of one dest array over all its sources
(at most ``MAX_SOURCES``) in one call, for one of the two phase sets of
``GSPHScheme`` (``sph/gas_dynamics/gsph.py``: the accuracy test, the
hydrostatic box and the shock tube's ``--scheme gsph`` of
``examples/gas_dynamics/``):

============  ==============================================  ===========
phase set     terms (equations)                               outputs
============  ==============================================  ===========
GRADIENTS     GRAD (``GSPHGradients``): DWI at the dest's h   px .. wz
ACCELERATION  ACC (``GSPHAcceleration``): a Riemann problem    au av aw ae
              a pair, DWI, DWJ and DWIJ at the dest's, the
              source's and the mean h
============  ==============================================  ===========

Each output is ``pre + sum`` on rows under the write mask and ``pre``
elsewhere; every read sees the value from before the phase.  h varies per
particle: a pair is in support where ``r < radius_scale max(hi, hj)``.
Every kernel with a ``kernel_kind`` (``csrc/shapes.cuh``; the scheme's
default is the Gaussian, kind 2); the grid may be periodic.
``counts=True`` adds ``nnbr``, each dest's pairs in support (int32), to
the result.  The acceleration set's constants (``GsphParams``: the
Riemann solver ``rsolver`` 0-10, ``monotonicity``, ``interpolation``,
``interface_zero``, ``hybrid`` with ``blend_alpha`` and ``tf``, the
conduction's ``g1``, ``g2``, ``gamma`` and the solver's ``niter``) are
one set a call.  The step's ``t`` and ``dt`` are Python floats or, in the
solver's chunks, 0-d float64 tensors on the card, which the kernel reads
there (a CUDA graph replays the step's own).

The linked pair.  Where a dest's acceleration group follows its
gradients group with the same sources and nothing between them writes a
prop of the gradients' planes (``ops/pair_engine.py::link_pairs``), the
two plans share a ``Link`` (``ops/pair_link.py``): the gradients call
runs with ``emit=True`` and returns, beside its output, a ``Handoff``:
its sources' packed copies of planes 0-2 (``{x y z h}``, ``{u v w m}``,
``{rho p cs e}``) and the neighbour list, up to ``CAPACITY[dim]``
entries a dest.  The acceleration call takes it (``handoff=``): it packs
only planes 3-6 and reads the listed records instead of walking, so its
sums are the walk's bit for bit; a warp holding a dest past the capacity
walks.  The gradients launch counts such dests on the card
(``overflowed``).  A linked acceleration plan run without its hand-off
raises.

For CUDA tensors it calls ``csrc/gsph_pair.cu`` (a library of its own,
built on first use by ``ops/build.py``) once: its launch function
launches the source pack (``ops/cell_pack.py``, counted in
``cell_pack.pack.launches``) and then the kernel (counted in
``gsph_pair.launches``; each later kind a library of its own, built at
its first launch); a kernel without a ``kernel_kind``, a dtype other than
float32 and float64, an unknown ``rsolver`` or a refused launch raises.
For CPU tensors it calls ``gsph_pair_reference``, the torch pair engine
running the same ``Equation`` objects on the exact lists of
``CellGrid.neighbor_pairs``, which walks for the acceleration call too:
an emitting call returns an empty hand-off.

``riemann`` runs one of the library's eleven device Riemann solvers
(``csrc/riemann.cuh``) elementwise on tensors on the card, for holding
them to ``sph/gas_dynamics/riemann_solver.py`` (counted in
``riemann.launches``; no path runs it).
"""

import ctypes
from typing import NamedTuple

import torch

from pysph_tpu_torch.ops import build, cell_pack, pair_link
from pysph_tpu_torch.ops.build import data_ptr
from pysph_tpu_torch.ops.pair_link import CAPACITY, Handoff
from pysph_tpu_torch.ops.pair_sets import PhaseSets, fill_outputs

GRAD, ACC = 1, 2
#: the kernel's modes (csrc/gsph_pair.cu GsphMode)
WALK, EMIT, CONSUME = range(3)
#: the planes that an emitting gradients call leaves in its hand-off
HANDED = 3
#: phase sets, indexed by the phase id of the CUDA kernel
PHASE_SETS = (GRAD, ACC)
GRADIENTS, ACCELERATION = range(2)
MAX_SOURCES = 4
#: the Riemann solvers of csrc/riemann.cuh, as riemann_solver.SOLVERS
RSOLVERS = 11
_GRADS = ('px', 'py', 'pz', 'ux', 'uy', 'uz', 'vx', 'vy', 'vz', 'wx',
          'wy', 'wz')
OUTPUTS = _GRADS + ('au', 'av', 'aw', 'ae')
TERM_OUTPUTS = {GRAD: OUTPUTS[:12], ACC: OUTPUTS[12:]}

_VEL = ('u', 'v', 'w')
_GRHO = ('grhox', 'grhoy', 'grhoz')
#: props each set reads beyond x, y, z, h: (dest, source)
_SET_READS = {
    GRAD: (('p',) + _VEL, ('p', 'rho', 'm') + _VEL),
    ACC: (('rho', 'p', 'cs', 'e', 'div') + _VEL + _GRHO + _GRADS,
          ('m', 'rho', 'p', 'cs', 'e', 'div') + _VEL + _GRHO + _GRADS)}
_DEST_PROPS = ('x', 'y', 'z', 'h', 'rho', 'p', 'cs', 'e', 'div') + _VEL + \
    _GRHO + _GRADS
#: record planes of the packed copy (csrc/gsph_pair.cu): the gradients
#: pack planes 0-2, the acceleration all seven
PACK_RECORDS = (('x', 'y', 'z', 'h'), ('u', 'v', 'w', 'm'),
                ('rho', 'p', 'cs', 'e'), ('div', 'grhox', 'grhoy', 'grhoz'),
                ('px', 'py', 'pz', 'ux'), ('uy', 'uz', 'vx', 'vy'),
                ('vz', 'wx', 'wy', 'wz'))
_SETS = PhaseSets('gsph_pair', PHASE_SETS, _SET_READS, PACK_RECORDS,
                  MAX_SOURCES)
phase_of = _SETS.phase_of
_reads = _SETS.reads
pack_layout = _SETS.pack_layout
pack_sources = _SETS.pack_sources
pack_sources_reference = _SETS.pack_sources_reference


class GsphParams(NamedTuple):
    """``GSPHAcceleration``'s constants (the gradients take none)."""
    rsolver: int = 2
    monotonicity: int = 0
    interpolation: int = 1
    interface_zero: bool = True
    hybrid: bool = False
    blend_alpha: float = 5.0
    tf: float = 1.0
    g1: float = 0.0
    g2: float = 0.0
    gamma: float = 1.4
    niter: int = 20


def params_of(eq):
    """The ``GsphParams`` of a ``GSPHAcceleration``."""
    return GsphParams(int(eq.rsolver), int(eq.monotonicity),
                      int(eq.interpolation), bool(eq.interface_zero),
                      bool(eq.hybrid), float(eq.blend_alpha), float(eq.tf),
                      float(eq.g1), float(eq.g2), float(eq.gamma),
                      int(eq.niter))


class GsphSource(NamedTuple):
    """One source of a dest's phase set: its term mask, the ``Equation``
    objects the terms stand for (the plain version runs them) and the
    acceleration's constants."""
    name: str
    terms: int
    equations: tuple
    params: GsphParams = GsphParams()


def _phase(sources):
    phase = _SETS.phase(sources)
    if len({gs.params for _, _, gs in sources}) != 1:
        raise ValueError('gsph_pair: sources of different constants')
    return phase


def gsph_pair_reference(dest, dest_cells, write_mask, pre, sources, grid,
                        kernel, t=0.0, dt=0.0, counts=False):
    """Plain torch version of ``gsph_pair``: the torch pair engine
    running each source's equations on the exact lists (wrapped, with
    minimum images, on a periodic grid).

    ``dest``: state dict of the dest array; ``dest_cells``: its
    ``CellList``; ``write_mask``: bool rows or None; ``pre``: {output:
    value before the phase}; ``sources``: [(state, CellList,
    GsphSource)]; ``grid``: the ``CellGrid`` of the cell lists; ``t``,
    ``dt``: the step's; ``counts``: add ``nnbr``.  Returns {output:
    tensor}."""
    _phase(sources)
    return _SETS.reference(dest, dest_cells, write_mask, pre, sources, grid,
                           kernel, t, dt, counts)


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
                 ('src', _SrcArgs * MAX_SOURCES),
                 ('dt_at', ctypes.c_void_p), ('t_at', ctypes.c_void_p)] +
                [(k, ctypes.c_double) for k in (
                    'radius_scale', 'kfac', 'g1', 'g2', 'gamma',
                    'blend_alpha', 'tf', 'dt', 't')] +
                [('box', ctypes.c_double * 3)] +
                [(k, ctypes.c_int32) for k in (
                    'n_dest', 'n_src', 'nx', 'ny', 'nz', 'dim', 'phase',
                    'dtype', 'kernel_kind', 'periodic', 'rsolver', 'niter',
                    'monotonicity', 'interpolation', 'interface_zero',
                    'hybrid', 'conduction', 'mode', 'cap')] +
                [(k, ctypes.c_void_p) for k in ('nbr', 'lcount',
                                                 'overflow')] +
                [('pack', cell_pack.PackArgs)])


def overflowed(device):
    """The dests past the list's capacity that emitting launches counted
    since ``reset_overflow`` (reads the counter)."""
    return pair_link.overflowed('gsph_pair', device)


def reset_overflow(device):
    pair_link.reset_overflow('gsph_pair', device)


def _time(args, name, value, dev):
    """Set ``args.<name>`` (a host float) or ``args.<name>_at`` (the
    address of a 0-d float64 tensor on the card, the solver's chunk)."""
    if torch.is_tensor(value):
        if value.dtype != torch.float64 or value.device != dev or \
                value.numel() != 1:
            raise ValueError('gsph_pair: %s must be a float64 scalar tensor '
                             'on %s, got %s %s on %s' % (
                                 name, dev, tuple(value.shape), value.dtype,
                                 value.device))
        setattr(args, name + '_at', value.data_ptr())
    else:
        setattr(args, name, float(value))


def _check_mode(phase, emit, handoff, dest, sources):
    """Raise unless only a gradients call emits and only an acceleration
    call takes a hand-off, one that ``sources`` on ``dest``'s device
    emitted for as many dests."""
    if emit and (handoff is not None or phase != GRADIENTS):
        raise ValueError('gsph_pair: only a gradients call emits a hand-off')
    if handoff is None:
        return
    if phase != ACCELERATION:
        raise ValueError('gsph_pair: only an acceleration call takes a '
                         'hand-off')
    pair_link.check_handoff('gsph_pair', handoff, dest, sources)


def _launch(dest, dest_cells, write_mask, pre, sources, grid, kernel, t,
            dt, counts, emit, handoff, capacity):
    x = dest['x']
    dev, n = x.device, x.shape[0]
    phase = _phase(sources)
    _check_mode(phase, emit, handoff, dest, sources)
    terms = PHASE_SETS[phase]
    if set(pre) != set(TERM_OUTPUTS[terms]):
        raise ValueError('gsph_pair: pre values for %s, the set gives %s'
                         % (sorted(pre), TERM_OUTPUTS[terms]))
    prm = sources[0][2].params
    if not 0 <= prm.rsolver < RSOLVERS:
        raise ValueError('gsph_pair: no Riemann solver %d' % prm.rsolver)
    if prm.monotonicity not in (0, 1, 2) or \
            prm.interpolation not in (0, 1, 2):
        raise ValueError('gsph_pair: monotonicity %d, interpolation %d'
                         % (prm.monotonicity, prm.interpolation))
    args = _Args()
    i32 = torch.int32
    # an emitting call packs planes 0-2 with every prop the acceleration
    # reads of them, and a consuming call packs planes 3-6 and reads 0-2
    # from the emitting call's copies (HANDED planes each, one after
    # another)
    slots, planes = pack_layout(ACC)
    layout = (slots[:HANDED], planes[:HANDED]) if emit else \
        (slots[HANDED:], planes[HANDED:]) if handoff is not None else None
    buf = _SETS.fill(args, dest, dest_cells, write_mask, sources, grid,
                     kernel, phase, layout=layout)
    if handoff is not None:
        plane0, size = handoff.plane0()
        if n and handoff.buf.numel() != size:
            raise ValueError('gsph_pair: a hand-off of %d values for copies '
                             'of %d' % (handoff.buf.numel(), size))
        es = x.element_size()
        for k, (src, _, _) in enumerate(sources):
            ns = src['x'].shape[0]
            for q in range(HANDED):
                args.src[k].plane[q] = handoff.buf.data_ptr() + \
                    (plane0[k] + q * 4 * ns) * es
        args.mode = CONSUME
    elif emit:
        cap = capacity or CAPACITY[kernel.dim]
        handoff = Handoff(buf, torch.empty((cap, n), dtype=i32, device=dev),
                          torch.empty(n, dtype=i32, device=dev),
                          pair_link.copies_of(sources),
                          (HANDED,) * len(sources))
        args.overflow = pair_link.overflow_counter('gsph_pair',
                                                   dev).data_ptr()
        args.mode = EMIT
    if handoff is not None and n:
        args.nbr = data_ptr(handoff.nbr, handoff.nbr.shape[0], i32, dev,
                            'neighbour list', width=n)
        args.lcount = data_ptr(handoff.count, n, i32, dev, 'counts')
        args.cap = handoff.nbr.shape[0]
    out = fill_outputs(args, OUTPUTS, pre, x, counts)
    _time(args, 'dt', dt, dev)
    _time(args, 't', t, dev)
    args.g1, args.g2, args.gamma = prm.g1, prm.g2, prm.gamma
    args.blend_alpha, args.tf = prm.blend_alpha, prm.tf
    args.rsolver, args.niter = prm.rsolver, prm.niter
    args.monotonicity, args.interpolation = (prm.monotonicity,
                                             prm.interpolation)
    args.interface_zero, args.hybrid = prm.interface_zero, prm.hybrid
    args.conduction = not (prm.g1 == 0 and prm.g2 == 0)
    if n:
        build.launch('gsph_pair', args, dev)
        gsph_pair.launches += 1
        cell_pack.pack.launches += bool(args.pack.n_src)
    if emit:
        return out, handoff
    del buf  # held until the launch is queued
    return out


def gsph_pair(dest, dest_cells, write_mask, pre, sources, grid, kernel,
              t=0.0, dt=0.0, counts=False, emit=False, handoff=None,
              capacity=None):
    """Pair terms of one dest over its sources; same arguments and
    result as ``gsph_pair_reference``.  ``emit`` (a gradients call):
    return (result, ``Handoff``); ``handoff`` (an acceleration call): read
    that hand-off's copies and neighbour list instead of walking;
    ``capacity``: the list's entries a dest for ``emit``, for tests
    (default ``CAPACITY[kernel.dim]``).  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    dev = dest['x'].device
    if dev.type == 'cpu':
        _check_mode(_phase(sources), emit, handoff, dest, sources)
        out = gsph_pair_reference(dest, dest_cells, write_mask, pre,
                                  sources, grid, kernel, t, dt, counts)
        # the plain acceleration call walks: the hand-off carries nothing
        return (out, pair_link.empty_handoff(dest, sources)) if emit \
            else out
    if dev.type != 'cuda':
        raise ValueError('gsph_pair: no kernel for device %s' % dev)
    return _launch(dest, dest_cells, write_mask, pre, sources, grid, kernel,
                   t, dt, counts, emit, handoff, capacity)


class _RiemannArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in (
        'rhol', 'rhor', 'pl', 'pr', 'ul', 'ur', 'pstar', 'ustar')] +
        [('gamma', ctypes.c_double)] +
        [(k, ctypes.c_int32) for k in ('n', 'method', 'niter', 'dtype')])


def riemann_reference(method, rhol, rhor, pl, pr, ul, ur, gamma=1.4,
                      niter=20):
    """Plain version of ``riemann``: ``riemann_solver.riemann_solve``."""
    from pysph_tpu_torch.sph.gas_dynamics.riemann_solver import (
        riemann_solve)
    return riemann_solve(method, rhol, rhor, pl, pr, ul, ur, gamma, niter)


def riemann(method, rhol, rhor, pl, pr, ul, ur, gamma=1.4, niter=20):
    """(pstar, ustar) of the device Riemann solver ``method`` (0-10) on
    the states, tensors of one shape and dtype; CPU tensors take the
    plain version."""
    states = (rhol, rhor, pl, pr, ul, ur)
    x = rhol
    if x.device.type == 'cpu':
        return riemann_reference(method, *states, gamma, niter)
    if not 0 <= int(method) < RSOLVERS:
        raise ValueError('riemann: no Riemann solver %r' % (method,))
    dev, fdt = x.device, x.dtype
    if fdt not in (torch.float32, torch.float64):
        raise ValueError('riemann: dtype %s' % fdt)
    n = x.numel()
    args = _RiemannArgs()
    # contiguous flat views, referenced until the launch is queued
    flat = [s.contiguous().view(-1) for s in states]
    for name, s, f in zip(('rhol', 'rhor', 'pl', 'pr', 'ul', 'ur'), states,
                          flat):
        if s.shape != x.shape:
            raise ValueError('riemann: %s of shape %s, rhol %s' % (
                name, tuple(s.shape), tuple(x.shape)))
        setattr(args, name, data_ptr(f, n, fdt, dev, name))
    pstar, ustar = torch.empty_like(x), torch.empty_like(x)
    args.pstar, args.ustar = pstar.data_ptr(), ustar.data_ptr()
    args.gamma = float(gamma)
    args.n, args.method, args.niter = n, int(method), int(niter)
    args.dtype = 1 if fdt == torch.float64 else 0
    if n:
        lib = build.load_library('gsph_pair', _Args)
        fn = lib.gsph_pair_riemann
        fn.argtypes = [ctypes.POINTER(_RiemannArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ctypes.byref(args), stream)
        if rc != 0:
            raise RuntimeError('gsph_pair riemann launch failed: %s' %
                               lib.gsph_pair_error_string(rc).decode())
        riemann.launches += 1
    return pstar, ustar


#: kernel launches since the last reset (set to 0 to reset)
gsph_pair.launches = 0


#: probe launches since the last reset (set to 0 to reset)
riemann.launches = 0
