"""The WCSPH pair kernel: wrapper, launch counter and plain version.

``wcsph_pair`` runs the loop terms of the main path's pair group for one
dest array over all its sources (at most ``MAX_SOURCES``) in one call.
A per-source term mask selects

- ``CONT``: ``arho += m_j VIJ.DWIJ`` (``ContinuityEquation``);
- ``MOM``: ``au, av, aw`` and the ``dt_cfl`` max (non-tensile
  ``MomentumEquation``);
- ``XSPH``: ``ax, ay, az += -eps m_j WIJ RHOIJ1 VIJ``
  (``XSPHCorrection``);
- ``TENS`` (with ``MOM``): Monaghan's tensile correction, ``(R_i + R_j)
  (WIJ / WDP)^4`` added to the pressure terms (``MomentumEquation`` with
  ``tensile_correction``);
- ``VISC``: ``au, av, aw += 4 nu m_j (DWIJ.XIJ) VIJ / ((rho_i + rho_j)
  (R2IJ + eta HIJ^2))`` (``LaminarViscosity``, Morris);
- ``LVD``: ``au, av, aw += 2 (dim + 2) nu rho0 (VIJ.XIJ) / (R2IJ + EPS)
  V_j / rho_i DWIJ`` (``LaminarViscosityDeltaSPH``);
- ``SDEN``: ``rho += m_j WIJ`` (``SummationDensity``, a group of its
  own);
- ``DCONT``: the delta-SPH diffusion of ``arho``, which reads the
  dest's and the source's ``gradrho`` (``ContinuityEquationDeltaSPH``);
- ``DMOM``: the delta-SPH viscous term of ``au, av, aw``
  (``MomentumEquationDeltaSPH``).

Each output is ``pre + sum`` (``max(pre, m)`` for ``dt_cfl``) on rows
under the write mask and ``pre`` elsewhere; every read sees the value
from before the phase.  Any kernel with a ``kernel_kind``.  The grid may be
periodic (``base/cell_grid.py``): the kernel then walks the wrapped
stencil and takes the minimum image of every displacement
(``csrc/cell_walk.cuh::walk_rows_periodic``, built as a template flag,
so the kernel on an open grid keeps the plain walk).

For CUDA tensors it calls ``csrc/wcsph_pair.cu`` (built on first use by
``ops/build.py``) once: its launch function launches the source pack
(``ops/cell_pack.py``, counted in ``cell_pack.pack.launches``) and then
the walk (counted in ``wcsph_pair.launches``); for CPU tensors it calls
``wcsph_pair_reference``, the same computation on the torch pair engine.
``ops/dense_pair.py`` is the other walk of the same contract, with the
same arguments and ``launch_pair``.

The packed copy: for each source of a call, its props in its cell order
as records of four values of the working type, in the ``PACK_RECORDS``
planes that its terms read.  A copy is made for every call: a dest's
``initialize``/``post_loop`` between two calls of one group may write a
source prop in place.  ``pack_sources`` launches the pack alone
(``csrc/cell_pack.cu``), for the tests and the timings.
"""

import ctypes
import functools

import torch

from pysph_tpu_torch.base.kernels import kernel_kind
from pysph_tpu_torch.ops import build, cell_pack
from pysph_tpu_torch.ops.build import data_ptr
from pysph_tpu_torch.sph.basic_equations import (
    ContinuityEquation, SummationDensity, XSPHCorrection)
from pysph_tpu_torch.sph.wc.basic import (
    ContinuityEquationDeltaSPH, MomentumEquation, MomentumEquationDeltaSPH)
from pysph_tpu_torch.sph.wc.viscosity import (
    LaminarViscosity, LaminarViscosityDeltaSPH)

CONT, MOM, XSPH, DCONT, DMOM, VISC, TENS, SDEN, LVD = (
    1, 2, 4, 8, 16, 32, 64, 128, 256)
MAX_SOURCES = 4
OUTPUTS = ('arho', 'au', 'av', 'aw', 'ax', 'ay', 'az', 'dt_cfl', 'rho')
TERM_OUTPUTS = {CONT: ('arho',), MOM: ('au', 'av', 'aw', 'dt_cfl'),
                XSPH: ('ax', 'ay', 'az'), DCONT: ('arho',),
                DMOM: ('au', 'av', 'aw'), VISC: ('au', 'av', 'aw'),
                TENS: ('au', 'av', 'aw'), SDEN: ('rho',),
                LVD: ('au', 'av', 'aw')}

#: the columns of the stride-3 ``gradrho``, as the pack names them
GRADRHO = tuple(('gradrho', c) for c in range(3))
# props each term reads; the dest needs them without 'm', sources with
_BASE = ('x', 'y', 'z', 'u', 'v', 'w', 'h')
_TERM_READS = {CONT: ('m',), MOM: ('m', 'rho', 'p', 'cs'),
               XSPH: ('m', 'rho'), DCONT: ('m', 'rho') + GRADRHO,
               DMOM: ('m', 'rho'), VISC: ('m', 'rho'),
               TENS: ('m', 'rho', 'p', 'cs'), SDEN: ('m',),
               LVD: ('m', 'rho')}
_DEST_PROPS = ('x', 'y', 'z', 'u', 'v', 'w', 'h', 'rho', 'p', 'cs',
               'gradrho')

#: record planes of the packed copy (csrc/wcsph_terms.cuh); the third
#: only where the terms read rho, the fourth where they read gradrho
#: (``cell_pack.layout``)
PACK_RECORDS = (('x', 'y', 'z', 'h'), ('u', 'v', 'w', 'm'),
                ('rho', 'p', 'cs', None), GRADRHO + (None,))


# the wrappers run on every call of the host's hot loop: the two term
# tables below are computed once per term mask
@functools.lru_cache(maxsize=None)
def outputs_for(terms):
    return tuple(p for p in OUTPUTS
                 if any(terms & t and p in TERM_OUTPUTS[t]
                        for t in TERM_OUTPUTS))


@functools.lru_cache(maxsize=None)
def _reads(terms, with_mass):
    props = set(_BASE)
    for t, extra in _TERM_READS.items():
        if terms & t:
            props.update(extra)
    if not with_mass:
        props.discard('m')
    return frozenset(props)


def _equations(ps):
    """The Equation objects a ``PairSource`` stands for."""
    eqs = []
    if ps.terms & CONT:
        eqs.append(ContinuityEquation('dest', [ps.name]))
    if ps.terms & SDEN:
        eqs.append(SummationDensity('dest', [ps.name]))
    if ps.terms & MOM:
        eqs.append(MomentumEquation('dest', [ps.name], c0=ps.c0,
                                    alpha=ps.alpha, beta=ps.beta,
                                    tensile_correction=bool(
                                        ps.terms & TENS)))
    if ps.terms & XSPH:
        eqs.append(XSPHCorrection('dest', [ps.name], eps=ps.eps))
    if ps.terms & DCONT:
        eqs.append(ContinuityEquationDeltaSPH('dest', [ps.name],
                                              c0=ps.delta_c0,
                                              delta=ps.delta))
    if ps.terms & DMOM:
        eqs.append(MomentumEquationDeltaSPH('dest', [ps.name], rho0=ps.rho0,
                                            c0=ps.dmom_c0,
                                            alpha=ps.dmom_alpha))
    if ps.terms & VISC:
        eqs.append(LaminarViscosity('dest', [ps.name], nu=ps.nu,
                                    eta=ps.eta))
    if ps.terms & LVD:
        eqs.append(LaminarViscosityDeltaSPH('dest', [ps.name],
                                            dim=ps.lvd_dim,
                                            rho0=ps.lvd_rho0, nu=ps.lvd_nu))
    return eqs


@functools.lru_cache(maxsize=None)
def _w_deltap(cls, dim):
    """w(deltap) of the kernel ``cls(dim)``, unnormalised, in float64:
    the tensile correction's WIJ / WDP is w(q) / w(deltap)."""
    kernel = cls(dim=dim)
    return float(kernel._shape(torch.tensor(kernel.get_deltap(),
                                            dtype=torch.float64))[0])


def wcsph_pair_reference(dest, dest_cells, write_mask, pre, sources, grid,
                         kernel):
    """Plain torch version of ``wcsph_pair``: the torch pair engine
    running the equations the term masks stand for.

    ``dest``: state dict of the dest array; ``dest_cells``: its
    ``CellList``; ``write_mask``: bool rows or None; ``pre``: {output:
    value before the phase}; ``sources``: [(state, CellList,
    PairSource)]; ``grid``: the ``CellGrid`` of the cell lists.
    Returns {output: tensor}."""
    from pysph_tpu_torch.sph.acceleration_eval import run_pair_phase
    store = dict(dest)
    store.update(pre)
    for src, src_cells, ps in sources:
        run_pair_phase(_equations(ps), store, src, dest_cells, src_cells,
                       grid, kernel, write_mask, 0.0, 0.0)
    return {p: store[p] for p in pre}


def pack_layout(terms):
    """Prop names of the record planes of a source's packed copy under
    the term mask (``cell_pack.layout``)."""
    return cell_pack.layout(PACK_RECORDS, _reads(terms, with_mass=True))[1]


def pack_planes(terms):
    """Record planes of a source's packed copy under the term mask."""
    return len(pack_layout(terms))


def _packs(sources):
    return [(src, cells.order, pack_layout(ps.terms))
            for src, cells, ps in sources]


def pack_sources_reference(sources):
    """Plain torch version of ``pack_sources``: for each (state,
    ``CellList``, ``PairSource``) of a call, the ``(planes, n, 4)``
    records of its ``pack_layout`` gathered through the cell order."""
    return cell_pack.pack_reference(_packs(sources))


def pack_sources(sources):
    """The packed copy of every source of a call; same arguments and
    result as ``pack_sources_reference``.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/cell_pack.cu`` once for all the
    sources (``cell_pack.pack``)."""
    return cell_pack.pack(_packs(sources))


class _SrcArgs(ctypes.Structure):
    _fields_ = ([('pos', ctypes.c_void_p), ('vel', ctypes.c_void_p),
                 ('thermo', ctypes.c_void_p), ('grad', ctypes.c_void_p),
                 ('cell_start', ctypes.c_void_p),
                 ('cell_end', ctypes.c_void_p)] +
                [(k, ctypes.c_double) for k in (
                    'c0', 'alpha', 'beta', 'xsph_eps', 'delta', 'delta_c0',
                    'dmom_alpha', 'dmom_c0', 'rho0', 'nu', 'eta',
                    'lvd_fac')] +
                [('terms', ctypes.c_int32), ('pad', ctypes.c_int32)])


class WcsphArgs(ctypes.Structure):
    _fields_ = ([(p, ctypes.c_void_p) for p in _DEST_PROPS] +
                [('cell', ctypes.c_void_p), ('dorder', ctypes.c_void_p),
                 ('dcell_start', ctypes.c_void_p),
                 ('dcell_end', ctypes.c_void_p), ('wmask', ctypes.c_void_p),
                 ('pre', ctypes.c_void_p * len(OUTPUTS)),
                 ('out', ctypes.c_void_p * len(OUTPUTS)),
                 ('src', _SrcArgs * MAX_SOURCES),
                 ('radius_scale', ctypes.c_double),
                 ('kfac', ctypes.c_double), ('wdp', ctypes.c_double),
                 ('box', ctypes.c_double * 3)] +
                [(k, ctypes.c_int32) for k in (
                    'n_dest', 'n_src', 'nx', 'ny', 'nz', 'dim',
                    'kernel_kind', 'dtype', 'periodic')] +
                [('pack', cell_pack.PackArgs)])


def pair_args(name, dest, dest_cells, write_mask, pre, sources, grid,
              kernel, packed=False):
    """Check the arguments of a kernel that takes ``WcsphArgs``
    (``wcsph_pair``, ``dense_pair``, ``pair_stub``; ``name`` is for the
    messages) and fill them in.  With ``packed``, also the pack
    (``args.pack``, ``cell_pack.fill``) that the kernel's launch function
    runs before its walk, and the walk's pointers into its copies; without,
    no source records, for a kernel that walks none.  Returns (args,
    {output: empty tensor}, the buffer of the packed copies or None)."""
    x = dest['x']
    dev, fdt, n = x.device, x.dtype, x.shape[0]
    if fdt not in (torch.float32, torch.float64):
        raise ValueError('%s: dtype %s' % (name, fdt))
    if len(sources) > MAX_SOURCES:
        raise ValueError('%s: %d sources' % (name, len(sources)))
    kind = kernel_kind(kernel)
    if kind is None:
        raise ValueError('%s: no shape function for %r' % (name, kernel))
    i32 = torch.int32
    args = WcsphArgs()
    buf = cell_pack.fill(args.pack, _packs(sources), name) \
        if packed and sources else None
    terms = 0
    for k, (src, cells, ps) in enumerate(sources):
        terms |= ps.terms
        sa = args.src[k]
        if buf is not None:
            copy = args.pack.src[k]
            plane = copy.n * 4 * x.element_size()
            slots = cell_pack.layout(PACK_RECORDS, _reads(
                ps.terms, with_mass=True))[0]
            for q, field in enumerate(('pos', 'vel', 'thermo', 'grad')):
                if q in slots:
                    setattr(sa, field, copy.out + slots.index(q) * plane)
        sa.cell_start = data_ptr(cells.start, grid.ncells, i32, dev,
                                 'cell_start')
        sa.cell_end = data_ptr(cells.end, grid.ncells, i32, dev, 'cell_end')
        sa.c0, sa.alpha, sa.beta, sa.xsph_eps = (ps.c0, ps.alpha, ps.beta,
                                                 ps.eps)
        sa.delta, sa.delta_c0 = ps.delta, ps.delta_c0
        sa.dmom_alpha, sa.dmom_c0, sa.rho0 = (ps.dmom_alpha, ps.dmom_c0,
                                              ps.rho0)
        sa.nu, sa.eta = ps.nu, ps.eta
        # LaminarViscosityDeltaSPH's constant, as its loop multiplies it
        sa.lvd_fac = 2 * (ps.lvd_dim + 2) * ps.lvd_nu * ps.lvd_rho0
        sa.terms = ps.terms
    for p in _reads(terms, with_mass=False):
        if p in GRADRHO:
            continue
        setattr(args, p, data_ptr(dest[p], n, fdt, dev, 'd_' + p))
    if terms & DCONT:
        args.gradrho = data_ptr(dest['gradrho'], n, fdt, dev, 'd_gradrho',
                                width=3)
    args.cell = data_ptr(dest_cells.cell, n, i32, dev, 'dest cell')
    args.dorder = data_ptr(dest_cells.order, n, i32, dev, 'dest order')
    args.dcell_start = data_ptr(dest_cells.start, grid.ncells, i32, dev,
                                'dest cell_start')
    args.dcell_end = data_ptr(dest_cells.end, grid.ncells, i32, dev,
                              'dest cell_end')
    if write_mask is not None:
        args.wmask = data_ptr(write_mask, n, torch.bool, dev, 'write mask')
    if pre.keys() != set(outputs_for(terms)):
        raise ValueError('%s: pre values for %s, terms give %s'
                         % (name, sorted(pre), outputs_for(terms)))
    out = {}
    for k, p in enumerate(OUTPUTS):
        if p in pre:
            args.pre[k] = data_ptr(pre[p], n, fdt, dev, 'pre ' + p)
            out[p] = torch.empty_like(pre[p])
            args.out[k] = out[p].data_ptr()
    args.radius_scale = grid.radius_scale
    args.kfac = kernel.fac
    if terms & TENS:
        args.wdp = _w_deltap(type(kernel), kernel.dim)
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
    return args, out, buf


def launch_pair(name, op, dest, dest_cells, write_mask, pre, sources, grid,
                kernel):
    """Check the arguments and launch ``csrc/<name>.cu`` (``wcsph_pair``
    or ``dense_pair``, which take the same ``WcsphArgs``): the sources'
    pack, then the walk, from one host call on the current stream.
    Returns {output: tensor}."""
    n = dest['x'].shape[0]
    # the copies' buffer stays referenced until the launch is queued
    args, out, buf = pair_args(name, dest, dest_cells, write_mask, pre,
                               sources, grid, kernel, packed=n > 0)
    if n:
        build.launch(name, args, dest['x'].device)
        op.launches += 1
        cell_pack.pack.launches += bool(args.pack.n_src)
    return out


def wcsph_pair(dest, dest_cells, write_mask, pre, sources, grid, kernel):
    """Pair terms of one dest over its sources; same arguments and
    result as ``wcsph_pair_reference``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if dest['x'].device.type == 'cpu':
        return wcsph_pair_reference(dest, dest_cells, write_mask, pre,
                                    sources, grid, kernel)
    if dest['x'].device.type != 'cuda':
        raise ValueError('wcsph_pair: no kernel for device %s'
                         % dest['x'].device)
    return launch_pair('wcsph_pair', wcsph_pair, dest, dest_cells,
                       write_mask, pre, sources, grid, kernel)


#: kernel launches since the last reset (set to 0 to reset)
wcsph_pair.launches = 0
