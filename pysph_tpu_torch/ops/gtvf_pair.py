"""The GTVF pair kernel: wrapper, launch counter and plain version.

``gtvf_pair`` runs the pair terms of one dest array over all its sources
(at most ``MAX_SOURCES``) in one call, for one of the five phase sets of
``GTVFScheme``'s two evaluators (the GTVF dam break's, and the
Taylor-Green vortex's on its periodic box), the walls' two groups of
``TVFScheme`` (the last two sets' wall terms) and the walls' group of
``EDACScheme`` (the sixth).  A per-source term mask says which
equations a source takes (``ContinuitySolid`` only the walls,
``MomentumEquationArtificialStress`` only the fluid, ...):

==============  ==========================================  ===========
phase set       terms (equations)                           outputs
==============  ==========================================  ===========
WALL_VELOCITY   SWV (``SetWallVelocity``)                   uf vf wf wij
CONTINUITY      CGTVF (``ContinuityEquationGTVF``),         arho
                CSOLID (``ContinuitySolid``)
DENSITY         CDENS (``CorrectDensity``)                  rho rhodiv
WALL_PRESSURE   VSUM (``VolumeSummation``),                 V p wij
                WALLP (``SolidWallPressureBC``)
MOMENTUM        MPG (``MomentumEquationPressureGradient``,  au av aw
                with the kernel gradient at h/2),           auhat avhat
                MVISC (``MomentumEquationViscosity``),      awhat
                MAS (``MomentumEquationArtificialStress``)
EDAC_WALL       SND (``SourceNumberDensity``),              wij V p
                VSUM (``VolumeSummation``),                 uf vf wf
                EWALLP (EDAC's ``SolidWallPressureBC``),
                ESWV (EDAC's ``SetWallVelocity``)
==============  ==========================================  ===========

(TVF's ``SolidWallPressureBC`` and ``SetWallVelocity`` each sum ``wij``
too, EDAC's leave it to ``SourceNumberDensity``: their terms are
EDAC's own, which write only their equations' outputs.)

Each output is ``pre + sum`` on rows under the write mask and ``pre``
elsewhere; every read sees the value from before the phase.  Any kernel
with a ``kernel_kind`` (``WendlandQuintic`` on the dam break,
``QuinticSpline`` on the Taylor-Green vortex).  The grid may be periodic
(``base/cell_grid.py``): the kernel then walks the wrapped stencil and
takes the minimum image of every displacement
(``csrc/cell_walk.cuh::walk_rows_periodic``, built as a template flag, so
the kernel on an open grid keeps the plain walk).

For CUDA tensors it calls ``csrc/gtvf_pair.cu`` (built on first use by
``ops/build.py``) once: its launch function launches the source pack
(``ops/cell_pack.py``, counted in ``cell_pack.pack.launches``; each
source packs the ``PACK_RECORDS`` planes its terms read) and then the
walk (counted in ``gtvf_pair.launches``).  For CPU tensors it calls
``gtvf_pair_reference``, the torch pair engine running the same
``Equation`` objects.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from pysph_tpu_torch.base.kernels import kernel_kind
from pysph_tpu_torch.ops import build, cell_pack
from pysph_tpu_torch.ops.build import data_ptr

(SWV, CGTVF, CSOLID, CDENS, VSUM, WALLP, MPG, MAS, MVISC, SND, EWALLP,
 ESWV) = (1 << k for k in range(12))
#: phase sets, indexed by the phase id of the CUDA kernel
PHASE_SETS = (SWV, CGTVF | CSOLID, CDENS, VSUM | WALLP, MPG | MVISC | MAS,
              SND | VSUM | EWALLP | ESWV)
MAX_SOURCES = 4
OUTPUTS = ('uf', 'vf', 'wf', 'wij', 'arho', 'rho', 'rhodiv', 'V', 'p',
           'au', 'av', 'aw', 'auhat', 'avhat', 'awhat')
TERM_OUTPUTS = {SWV: ('uf', 'vf', 'wf', 'wij'), CGTVF: ('arho',),
                CSOLID: ('arho',), CDENS: ('rho', 'rhodiv'), VSUM: ('V',),
                WALLP: ('p', 'wij'),
                MPG: ('au', 'av', 'aw', 'auhat', 'avhat', 'awhat'),
                MAS: ('au', 'av', 'aw'), MVISC: ('au', 'av', 'aw'),
                SND: ('wij',), EWALLP: ('p',), ESWV: ('uf', 'vf', 'wf')}

# props each term reads beyond x, y, z, h: (dest, source)
_HAT = ('uhat', 'vhat', 'what')
_TERM_READS = {
    SWV: ((), ('u', 'v', 'w')),
    CGTVF: (('rho',) + _HAT, ('m', 'rho') + _HAT),
    CSOLID: (('rho', 'u', 'v', 'w'), ('m', 'rho', 'ug', 'vg', 'wg')),
    CDENS: ((), ('m', 'rho0')),
    VSUM: ((), ()),
    WALLP: (('au', 'av', 'aw'), ('p', 'rho')),
    MPG: (('rho', 'p', 'p0'), ('m', 'rho', 'p')),
    MAS: (('rho', 'u', 'v', 'w') + _HAT,
          ('m', 'rho', 'u', 'v', 'w') + _HAT),
    MVISC: (('rho', 'u', 'v', 'w'), ('m', 'rho', 'u', 'v', 'w')),
    SND: ((), ()),
    EWALLP: (('au', 'av', 'aw'), ('p', 'rho')),
    ESWV: ((), ('u', 'v', 'w'))}
_DEST_PROPS = ('x', 'y', 'z', 'h', 'rho', 'p', 'p0', 'u', 'v', 'w', 'uhat',
               'vhat', 'what', 'au', 'av', 'aw')
#: record planes of the packed copy (csrc/gtvf_pair.cu): mass and
#: density props share one plane, which every term but SWV and VSUM
#: reads, so a pair in support loads one to three records beyond {x y z
#: h}; a source packs the planes its terms read (``cell_pack.layout``)
PACK_RECORDS = (('x', 'y', 'z', 'h'), ('m', 'rho', 'p', 'rho0'),
                ('u', 'v', 'w', None), ('uhat', 'vhat', 'what', None),
                ('ug', 'vg', 'wg', None))


class GtvfSource(NamedTuple):
    """One source of a dest's phase set: its term mask, the ``Equation``
    objects the terms stand for (the plain version runs them), the
    gravity of its ``SolidWallPressureBC`` (TVF's or EDAC's) and the
    ``nu`` of its ``MomentumEquationViscosity``."""
    name: str
    terms: int
    equations: tuple
    gravity: tuple = (0.0, 0.0, 0.0)
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
    return [(src, cells.order, pack_layout(gs.terms)[1])
            for src, cells, gs in sources]


def pack_sources_reference(sources):
    """Plain torch version of ``pack_sources``: for each (state,
    ``CellList``, ``GtvfSource``) of a call, the ``(planes, n, 4)``
    records of its planes gathered through the cell order."""
    return cell_pack.pack_reference(_packs(sources))


def pack_sources(sources):
    """The packed copy of every source of a ``gtvf_pair`` call; same
    arguments and result as ``pack_sources_reference``.  CPU tensors
    take the plain version; CUDA tensors launch ``csrc/cell_pack.cu``."""
    return cell_pack.pack(_packs(sources))


def gtvf_pair_reference(dest, dest_cells, write_mask, pre, sources, grid,
                        kernel):
    """Plain torch version of ``gtvf_pair``: the torch pair engine
    running each source's equations.

    ``dest``: state dict of the dest array; ``dest_cells``: its
    ``CellList``; ``write_mask``: bool rows or None; ``pre``: {output:
    value before the phase}; ``sources``: [(state, CellList,
    GtvfSource)]; ``grid``: the ``CellGrid`` of the cell lists.
    Returns {output: tensor}."""
    from pysph_tpu_torch.sph.acceleration_eval import run_pair_phase
    store = dict(dest)
    store.update(pre)
    for src, src_cells, gs in sources:
        run_pair_phase(list(gs.equations), store, src, dest_cells,
                       src_cells, grid, kernel, write_mask, 0.0, 0.0)
    return {p: store[p] for p in pre}


class _SrcArgs(ctypes.Structure):
    _fields_ = [('plane', ctypes.c_void_p * len(PACK_RECORDS)),
                ('cell_start', ctypes.c_void_p),
                ('cell_end', ctypes.c_void_p),
                ('gx', ctypes.c_double), ('gy', ctypes.c_double),
                ('gz', ctypes.c_double), ('nu', ctypes.c_double),
                ('terms', ctypes.c_int32), ('pad', ctypes.c_int32)]


class _Args(ctypes.Structure):
    _fields_ = ([(p, ctypes.c_void_p) for p in _DEST_PROPS] +
                [('cell', ctypes.c_void_p), ('dorder', ctypes.c_void_p),
                 ('wmask', ctypes.c_void_p),
                 ('pre', ctypes.c_void_p * len(OUTPUTS)),
                 ('out', ctypes.c_void_p * len(OUTPUTS)),
                 ('src', _SrcArgs * MAX_SOURCES),
                 ('radius_scale', ctypes.c_double),
                 ('kfac', ctypes.c_double),
                 ('box', ctypes.c_double * 3)] +
                [(k, ctypes.c_int32) for k in (
                    'n_dest', 'n_src', 'nx', 'ny', 'nz', 'dim', 'phase',
                    'dtype', 'kernel_kind', 'periodic')] +
                [('pack', cell_pack.PackArgs)])


def _launch(dest, dest_cells, write_mask, pre, sources, grid, kernel):
    x = dest['x']
    dev, fdt, n = x.device, x.dtype, x.shape[0]
    if fdt not in (torch.float32, torch.float64):
        raise ValueError('gtvf_pair: dtype %s' % fdt)
    if kernel_kind(kernel) is None:
        raise ValueError('gtvf_pair: no shape function for %r' % kernel)
    if len(sources) > MAX_SOURCES:
        raise ValueError('gtvf_pair: %d sources' % len(sources))
    i32 = torch.int32
    args = _Args()
    # the copies' buffer stays referenced until the launch is queued
    buf = cell_pack.fill(args.pack, _packs(sources), 'gtvf_pair') \
        if n and sources else None
    terms = 0
    for k, (src, cells, gs) in enumerate(sources):
        terms |= gs.terms
        sa = args.src[k]
        if buf is not None:
            copy = args.pack.src[k]
            plane = copy.n * 4 * x.element_size()
            for q, slot in enumerate(pack_layout(gs.terms)[0]):
                sa.plane[slot] = copy.out + q * plane
        sa.cell_start = data_ptr(cells.start, grid.ncells, i32, dev,
                                 'cell_start')
        sa.cell_end = data_ptr(cells.end, grid.ncells, i32, dev, 'cell_end')
        sa.gx, sa.gy, sa.gz = gs.gravity
        sa.nu = gs.nu
        sa.terms = gs.terms
    phase = phase_of(terms)
    if phase is None:
        raise ValueError('gtvf_pair: terms %#x are in no phase set' % terms)
    for p in _reads(terms, 0):
        setattr(args, p, data_ptr(dest[p], n, fdt, dev, 'd_' + p))
    args.cell = data_ptr(dest_cells.cell, n, i32, dev, 'dest cell')
    args.dorder = data_ptr(dest_cells.order, n, i32, dev, 'dest order')
    if write_mask is not None:
        args.wmask = data_ptr(write_mask, n, torch.bool, dev, 'write mask')
    if set(pre) != set(outputs_for(terms)):
        raise ValueError('gtvf_pair: pre values for %s, terms give %s'
                         % (sorted(pre), outputs_for(terms)))
    out = {}
    for k, p in enumerate(OUTPUTS):
        if p in pre:
            args.pre[k] = data_ptr(pre[p], n, fdt, dev, 'pre ' + p)
            out[p] = torch.empty_like(pre[p])
            args.out[k] = out[p].data_ptr()
    args.radius_scale = grid.radius_scale
    args.kfac = kernel.fac
    if grid.is_periodic:
        # the box lengths of the periodic axes, each the dtype's value
        lengths = grid.box_host(fdt)['lengths']
        for d, per in enumerate(grid.periodic):
            args.box[d] = lengths[d] if per else 0.0
        args.periodic = 1
    args.n_dest, args.n_src = n, len(sources)
    args.nx, args.ny, args.nz = grid.dims
    args.dim = kernel.dim
    args.phase = phase
    args.dtype = 1 if fdt == torch.float64 else 0
    args.kernel_kind = kernel_kind(kernel)
    if n == 0:
        return out
    build.launch('gtvf_pair', args, dev)
    gtvf_pair.launches += 1
    cell_pack.pack.launches += bool(args.pack.n_src)
    return out


def gtvf_pair(dest, dest_cells, write_mask, pre, sources, grid, kernel):
    """Pair terms of one dest over its sources; same arguments and
    result as ``gtvf_pair_reference``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if dest['x'].device.type == 'cpu':
        return gtvf_pair_reference(dest, dest_cells, write_mask, pre,
                                   sources, grid, kernel)
    if dest['x'].device.type != 'cuda':
        raise ValueError('gtvf_pair: no kernel for device %s'
                         % dest['x'].device)
    return _launch(dest, dest_cells, write_mask, pre, sources, grid, kernel)


#: kernel launches since the last reset (set to 0 to reset)
gtvf_pair.launches = 0
