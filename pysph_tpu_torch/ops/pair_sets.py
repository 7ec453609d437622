"""What the gas pair kernels' wrappers share (``ops/gasd_pair.py``,
``ops/gsph_pair.py``): a call's phase set, the props each set reads, the
sources' packed copy, the launch arguments that every mode fills, and the
plain version's loop over the sources.

A wrapper describes its kernel once, ``PhaseSets(name, sets, set_reads,
pack_records)``: ``sets``, the term mask of each phase id of its CUDA
kernel; ``set_reads``, {terms: (dest props, source props)} read beyond x,
y, z, h; ``pack_records``, the record planes of its packed copy (the
wrapper's ``PACK_RECORDS``, named in a ``plane q:`` comment of its
``.cu``).  Its ctypes ``_Args`` and ``_SrcArgs`` mirror its ``.cu`` and
hold the fields that ``fill`` sets under the same names.
"""

import torch

from pysph_tpu_torch.base.kernels import kernel_kind
from pysph_tpu_torch.ops import cell_pack
from pysph_tpu_torch.ops.build import data_ptr


class PhaseSets(object):
    """The phase sets of one pair kernel (see the module's docstring)."""

    def __init__(self, name, sets, set_reads, pack_records, max_sources=4):
        self.name = name
        self.sets = tuple(sets)
        self.set_reads = set_reads
        self.pack_records = pack_records
        self.max_sources = max_sources
        self._reads = {}

    def phase_of(self, terms):
        """The phase id of the set ``terms`` is, or None."""
        return self.sets.index(terms) if terms in self.sets else None

    def reads(self, terms, side):
        """The props (a frozenset) that the set ``terms`` reads of the
        dest (``side`` 0) or of a source (1)."""
        key = (terms, side)
        if key not in self._reads:
            self._reads[key] = frozenset(('x', 'y', 'z', 'h') +
                                         self.set_reads[terms][side])
        return self._reads[key]

    def pack_layout(self, terms):
        """(slots, planes): the record planes a source of the set
        ``terms`` packs, and their prop names (``cell_pack.layout``)."""
        return cell_pack.layout(self.pack_records, self.reads(terms, 1))

    def packs(self, sources, layout=None):
        """(state, order, planes) of each source's pack: its set's layout's
        planes, or ``layout``'s ((slots, planes), as ``pack_layout``
        gives) where given."""
        return [(src, cells.order, (self.pack_layout(s.terms)
                                    if layout is None else layout)[1])
                for src, cells, s in sources]

    def pack_sources_reference(self, sources):
        """Plain torch version of ``pack_sources``: for each (state,
        ``CellList``, source) of a call, the ``(planes, n, 4)`` records
        of its planes gathered through the cell order."""
        return cell_pack.pack_reference(self.packs(sources))

    def pack_sources(self, sources):
        """The packed copy of every source of a call; CPU tensors take
        the plain version, CUDA tensors launch ``csrc/cell_pack.cu``."""
        return cell_pack.pack(self.packs(sources))

    def phase(self, sources):
        """The phase id of a call's sources, which must be one set."""
        terms = {s.terms for _, _, s in sources}
        phase = self.phase_of(terms.pop()) if len(terms) == 1 else None
        if phase is None or not sources:
            raise ValueError('%s: sources of terms %s are not one phase set'
                             % (self.name,
                                sorted(s.terms for _, _, s in sources)))
        return phase

    def reference(self, dest, dest_cells, write_mask, pre, sources, grid,
                  kernel, t=0.0, dt=0.0, counts=False):
        """The torch pair engine running each source's equations on the
        exact lists (wrapped, with minimum images, on a periodic grid):
        the plain version of a call.  Returns {output: tensor}, with
        ``nnbr`` where ``counts``."""
        from pysph_tpu_torch.sph.acceleration_eval import run_pair_phase
        self.phase(sources)
        store = dict(dest)
        store.update(pre)
        for src, src_cells, s in sources:
            run_pair_phase(list(s.equations), store, src, dest_cells,
                           src_cells, grid, kernel, write_mask, t, dt)
        out = {p: store[p] for p in pre}
        if counts:
            out['nnbr'] = neighbour_counts(dest, dest_cells, sources, grid)
        return out

    def fill(self, args, dest, dest_cells, write_mask, sources, grid,
             kernel, phase, buf=None, layout=None):
        """Fill what every launch's ``args`` holds: the dest's props that
        the set reads, its cells and write mask, each source's packed
        planes (the set's layout, or ``layout``'s (slots, planes) where
        given, the caller pointing any other; in one buffer, ``buf`` where
        given), cells, terms and first row, the grid and the kernel;
        raises for a dtype, a number of sources or a kernel that the
        library lacks.  Returns the packs' buffer, which stays referenced
        until the launch is queued."""
        x = dest['x']
        dev, fdt, n = x.device, x.dtype, x.shape[0]
        if fdt not in (torch.float32, torch.float64):
            raise ValueError('%s: dtype %s' % (self.name, fdt))
        if len(sources) > self.max_sources:
            raise ValueError('%s: %d sources' % (self.name, len(sources)))
        kind = kernel_kind(kernel)
        if kind is None:
            raise ValueError('%s: no shape function for %r (1D kernels: '
                             'ROADMAP Queue 1 item 28)' % (self.name, kernel))
        terms = self.sets[phase]
        i32 = torch.int32
        buf = cell_pack.fill(args.pack, self.packs(sources, layout),
                             self.name, buf)
        slots = (self.pack_layout(terms) if layout is None else layout)[0]
        base = 0
        for k, (src, cells, s) in enumerate(sources):
            sa, c = args.src[k], args.pack.src[k]
            plane = c.n * 4 * x.element_size()
            for q, slot in enumerate(slots):
                sa.plane[slot] = c.out + q * plane
            sa.cell_start = data_ptr(cells.start, grid.ncells, i32, dev,
                                     'cell_start')
            sa.cell_end = data_ptr(cells.end, grid.ncells, i32, dev,
                                   'cell_end')
            sa.terms = s.terms
            sa.base = base
            base += c.n
        for p in self.reads(terms, 0):
            setattr(args, p, data_ptr(dest[p], n, fdt, dev, 'd_' + p))
        args.cell = data_ptr(dest_cells.cell, n, i32, dev, 'dest cell')
        args.dorder = data_ptr(dest_cells.order, n, i32, dev, 'dest order')
        if write_mask is not None:
            args.wmask = data_ptr(write_mask, n, torch.bool, dev,
                                  'write mask')
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
        return buf


def neighbour_counts(dest, dest_cells, sources, grid):
    """Each dest's pairs in support over a call's sources (int32): the
    plain version of a kernel's ``count``."""
    n = dest['x'].shape[0]
    out = torch.zeros(n, dtype=torch.int64, device=dest['x'].device)
    for src, cells, _ in sources:
        i, _ = grid.neighbor_pairs(dest, dest_cells, src, cells, (0, n))
        out += torch.bincount(i, minlength=n)
    return out.to(torch.int32)


def fill_outputs(args, outputs, pre, x, counts, widths=None):
    """Point ``args.pre`` and ``args.out`` at the pre values and at new
    output tensors of each of ``outputs`` in ``pre`` (by its index
    there), of ``x``'s length, dtype and device (``(n, widths[p])`` for a
    strided output), and ``args.count`` at a new ``nnbr`` where
    ``counts``.  Returns {output: tensor}."""
    dev, fdt, n = x.device, x.dtype, x.shape[0]
    out = {}
    for k, p in enumerate(outputs):
        if p in pre:
            args.pre[k] = data_ptr(pre[p], n, fdt, dev, 'pre ' + p,
                                   width=(widths or {}).get(p))
            out[p] = torch.empty_like(pre[p])
            args.out[k] = out[p].data_ptr()
    if counts:
        out['nnbr'] = torch.empty(n, dtype=torch.int32, device=dev)
        args.count = out['nnbr'].data_ptr()
    return out
