"""Sorted cell lists, kept Verlet-style: the neighbour structure of the
port.

Replaces the capacity-M dense grid of ``pysph_tpu/base/cell_grid.py``.
The TPU needed fixed-shape (cells, M) blocks because Mosaic has no
gather; a GPU gathers, so each array is binned into a uniform grid and
sorted by cell id:

- cell id per particle: ``ix + nx * (iy + ny * iz)``, with
  ``i = floor((x - origin) / width)`` clamped into the grid;
- ``order = argsort(cell id)`` (stable), and per cell the half-open range
  ``[start, end)`` of positions in ``order``.

There is no per-cell capacity, so nothing can overflow and no step has
to be redone.  The cell width is ``cell_slack * radius_scale * hmax``
with ``cell_slack = 1.1``, as in ``pysph_tpu``, so a pair within support
lies in the same or an adjacent cell, and stays so while no particle has
moved more than half the slack margin ``0.5 (cell_slack - 1) radius_scale
hmax`` since the binning (two particles may each move half of it toward
the other) and hmax has not grown past the width.  So a binning is kept
across evaluations and steps in a ``GridHandle`` (the lists, the origin,
the width and the positions at the binning) and rebuilt only when that
test fails (``ops/bin_cells.py``, on the card; the evaluator's
``prepare_reuse``).  Clamping keeps the rule true for particles outside
the grid: two coordinates less than one width apart floor to cells at
most one apart, and clamping cannot widen the gap.  The grid's origin and
width follow the particles at every binning; its cell counts are sized
at setup with ``PAD`` of headroom and 3 cells, as ``pysph_tpu``'s
``GridSpec`` is.  Clamping is correct but piles escaped particles into
the edge cells, so each binning also sets ``overflow``, a device flag
that some particle lies beyond the grid, and the solver ``grow``s the
grid when it reads it.

Particles keep their order: consumers read sources through ``order``.

A position or h that is not finite (a run that blew up) is not binned:
the binning keeps the handle as it was and sets the grid's
``nonfinite`` flag on the device (``nonfinite_flag``), which the solver
reads with its chunk's read (or its step's) and ``check_finite`` turns
into ``FloatingPointError``.

A periodic domain (``base/domain.py``, ``set_domain``) changes the
geometry on its periodic axes as ``pysph_tpu``'s ``GridSpec`` does: the
grid spans the box, ``max(floor(L / cell), 1)`` cells of width ``L /
dims`` from the domain's lower corner, fixed whatever the particles'
positions do; cell ids wrap modulo the counts instead of clamping; the
stencil wraps, and shrinks to ``(-1, 0)`` on an axis of two cells and
``(0,)`` on one of one cell so that no cell is visited twice; and the
support test and the reuse test take the minimum image of every
displacement. The exact lists (``neighbor_pairs``) are the plain version
of that walk.

Where an equation also writes h (``h_varies``; ``keeps_width``), each
binning that an evaluator keeps (its step's, and the re-binning after
each ``update_nnps`` group: ``sph/acceleration_eval.py::Binning``)
carries periodic counts of its own, ``max(floor(L / cell), 1)`` for the
``cell`` it was sized for (``cells_for``: the grid itself for its own
counts, else a ``GridView``, the grid with other periodic counts), held
on the host so that a captured chunk bakes them in.  Each binning that
ran raises its ``widest``, the support ``cell_slack radius_scale hmax``
it binned; where that is wider than its periodic cell (``cells_small``,
``outgrown``) what was evaluated on the small cells is run again from
the state before it, that binning sized for its width (by ``run_sized``
for the initial evaluation, by the solver's redo of the step or chunk;
``grows`` counts), and where a binning's widest over an initial
evaluation, or over the solver's last ``RESIZE_STEPS`` steps, is
``SHRINK`` of its cell or less (``oversized``) it is sized down for it
there, with no redo (``shrinks`` counts).  So GSPH's scaled density,
which bins at twice the h of its second density, and the second
density, the gradients and the acceleration each walk cells that fit
their own h.  Open grids size each binning's cells from its own hmax
already.

The torch pair engine's lists (``neighbor_pairs`` with a
``PairCapacity``) are built at capacities held on the host, one for the
stencil candidates and one for the pairs in support of a chunk of dest
rows, so that nothing is read back and a step can be captured into a
CUDA graph.  A chunk with more of either than its capacity drops the
excess: it ORs a device flag into ``pair_overflow`` (kept, like
``overflow_any``, where the caller set it) and raises the capacity's
running maxima (``need``), from which ``grow_pairs`` sizes the
capacities on the host; the caller then runs the evaluation again from
the state before it (``sph/acceleration_eval.py::run_sized``, the
solver's redo).  At any capacity that holds them the pairs are those of
the exact list (no capacity), in its order.
"""

import math
import weakref
from typing import NamedTuple

import numpy as np
import torch

#: headroom of the cell counts on each side of the particles' extent
#: (pysph_tpu/base/cell_grid.py:168)
PAD = 0.03
#: the fraction of its periodic cell that a binning's widest must fall to
#: before it is sized down: a halved h (GSPH's scaled h after its first
#: evaluation, its h from the volume after the setup's) bins a few
#: percent wider than half its cells, which floor(L / cell) widens
SHRINK = 0.55


class CellList(NamedTuple):
    """One array binned on a ``CellGrid``."""
    cell: torch.Tensor    # (n,) int32 cell id of each particle
    order: torch.Tensor   # (n,) int32 particle indices sorted by cell
    start: torch.Tensor   # (ncells,) int32 first position in ``order``
    end: torch.Tensor     # (ncells,) int32 one past the last


class PairCapacity(object):
    """The torch pair engine's capacities for one (dest, source) pair of
    arrays, a chunk of dest rows: ``candidates`` and ``pairs`` (host
    ints, 0 until sized), and ``need``, (2,) int64 on the device: the
    most candidates and pairs in support that a chunk has had (of the
    candidates within the capacity), raised in place by every list."""

    def __init__(self, device):
        self.candidates = 0
        self.pairs = 0
        self.need = torch.zeros(2, dtype=torch.int64, device=device)


#: a grown capacity's headroom over the count that outgrew it
PAIR_GROWTH = 1.25


class GridHandle(object):
    """One binning of some arrays on a ``CellGrid``, kept across
    evaluations: ``lists`` ({name: CellList}), the ``origin`` (3,) and
    ``width`` () it binned with, the positions the particles had then
    (``ref``, {name: (3, n)}), its ``overflow`` flag and the ``rebuild``
    flag of its last test (``ops/bin_cells.py``), all tensors on the
    states' device that each binning overwrites in place, so that a CUDA
    graph replaying a step sees the same storage; ``scratch`` is the
    kernel's; ``grid``, the geometry it bins on (a ``CellGrid`` or a
    ``GridView`` of one); ``binning``, the evaluator's ``Binning`` that
    keeps it (None elsewhere).  A new handle holds no particle in any
    cell and has width 0, so its first test rebuilds it; ``invalidate``
    sets the width to 0 again."""

    def __init__(self, grid, states):
        x = next(iter(states.values()))['x']
        dev, fdt, i32 = x.device, x.dtype, torch.int32
        self.grid = grid
        self.binning = None
        self.dims, self.ncells = grid.dims, grid.ncells
        self.names = tuple(states)
        self.sizes = tuple(s['x'].shape[0] for s in states.values())
        self.dtype, self.device = fdt, dev
        self.lists = {name: CellList(
            torch.zeros(n, dtype=i32, device=dev),
            torch.arange(n, dtype=i32, device=dev),
            torch.zeros(grid.ncells, dtype=i32, device=dev),
            torch.zeros(grid.ncells, dtype=i32, device=dev))
            for name, n in zip(self.names, self.sizes)}
        self.ref = {name: torch.zeros((3, n), dtype=fdt, device=dev)
                    for name, n in zip(self.names, self.sizes)}
        self.origin = torch.zeros(3, dtype=fdt, device=dev)
        self.width = torch.zeros((), dtype=fdt, device=dev)
        self.overflow = torch.zeros((), dtype=torch.bool, device=dev)
        self.rebuild = torch.zeros((), dtype=torch.bool, device=dev)
        self.scratch = None

    def fits(self, grid, states):
        """Whether the handle can hold a binning of ``states`` on
        ``grid``'s cell counts."""
        x = next(iter(states.values()))['x']
        return (self.dims == grid.dims and self.names == tuple(states) and
                self.sizes == tuple(s['x'].shape[0]
                                    for s in states.values()) and
                x.dtype == self.dtype and x.device == self.device)

    def invalidate(self):
        """Make the next test rebuild the binning (in place)."""
        self.width.zero_()

    def _tensors(self):
        out = [self.origin, self.width, self.overflow, self.rebuild]
        for cells in self.lists.values():
            out.extend(cells)
        return out + list(self.ref.values())

    def save(self):
        """Copies of the handle's tensors (``scratch`` aside), for
        ``restore``."""
        return [t.clone() for t in self._tensors()]

    def restore(self, saved):
        """Put back what ``save`` copied, in place."""
        for t, v in zip(self._tensors(), saved):
            t.copy_(v)


class CellGrid(object):
    """Cell counts of the grid; bins particle states into ``CellList``s.

    ``cell_slack`` scales the cells above the support (1.1, as in
    ``pysph_tpu``: the Verlet margin of the binning's reuse).
    ``overflow`` ORs the overflow flags of the binnings since the last
    grow (None before the first; the solver sets it to None after a
    chunk); ``overflow_any``, once set to a flag, ORs in every later
    binning's (the solver's chunks set and read it; None: not kept);
    ``grows`` counts the calls of ``grow`` and the re-sizings of a
    binning's periodic cells for an h that outgrew them, ``shrinks``
    those for an h that fell to ``SHRINK`` of them or less."""

    def __init__(self, dim, radius_scale, dims, cell_slack=1.1,
                 domain=None):
        self.dim = int(dim)
        self.radius_scale = float(radius_scale)
        self.cell_slack = float(cell_slack)
        #: the cell width of the last sizing from particles (None where
        #: the counts were given)
        self.cell = None
        self._set_domain(domain)
        self._set_dims(dims)
        self.overflow = None
        self.overflow_any = None
        self.grows = 0
        self.shrinks = 0
        self._handles = weakref.WeakSet()
        #: {(dest, source): PairCapacity} of the torch pair engine
        self.pair_caps = {}
        #: 0-d device bool that the torch engine's lists OR their
        #: overflow into while set (None: not kept)
        self.pair_overflow = None
        #: 0-d device bool that every binning that met a position or h
        #: that is not finite sets (``nonfinite_flag``; None before the
        #: first binning)
        self.nonfinite = None
        #: 0-d device bool that the gated density sweeps OR an
        #: evaluation that ran out of sweep slots into while set (None:
        #: not kept; ``ops/pair_engine.py::SweepPlan``)
        self.sweep_overflow = None
        #: whether an evaluator of the grid has an equation that writes h
        #: (set by the evaluators): only then do binnings keep a width
        self.h_varies = False

    def _set_domain(self, domain):
        """Keep ``domain`` (a ``DomainManager``, or None) and which axes
        below ``dim`` it makes periodic."""
        self.domain = domain
        self.periodic = tuple(
            domain is not None and bool(domain.periodic[d]) and d < self.dim
            for d in range(3))
        self.is_periodic = any(self.periodic)

    def set_domain(self, domain):
        """Take ``domain``'s periodic axes: their cell counts are set
        from the box for the cells of the grid's last sizing (``cell``)
        and every handle is invalidated, as after a ``resize``."""
        self._set_domain(domain)
        if self.is_periodic:
            if self.cell is None:
                raise ValueError('a periodic domain needs a grid sized from '
                                 'particles (from_particles)')
            self._set_dims(self.sized_dims(self.dims, self.cell))
        self.overflow = self.overflow_any = None
        for handle in list(self._handles):
            handle.invalidate()

    def _set_dims(self, dims):
        dims = tuple(int(d) for d in dims)
        self.dims = dims + (1,) * (3 - len(dims))
        self.ncells = self.dims[0] * self.dims[1] * self.dims[2]
        self._limit = None
        self._offsets = {}
        self._consts = {}
        self._views = {}

    @property
    def keeps_width(self):
        """Whether binnings keep their widest width and have periodic
        counts of their own: a periodic grid where an equation writes
        h."""
        return self.is_periodic and self.h_varies

    def cells_for(self, cell):
        """The geometry of a binning whose periodic cells are sized for
        cells of ``cell`` (a host float; None: the grid's own counts):
        the grid itself where the counts are its own, else a
        ``GridView`` with ``max(floor(L / cell), 1)`` cells on each
        periodic axis, made once per counts and grid size."""
        if cell is None or not self.is_periodic:
            return self
        dims = tuple(self.sized_dims(self.dims, cell))
        if dims == self.dims:
            return self
        view = self._views.get(dims)
        if view is None:
            view = self._views[dims] = GridView(self, dims)
        return view

    def sized_dims(self, dims, cell):
        """``dims`` with each periodic axis set to ``max(floor(L /
        cell), 1)`` cells (pysph_tpu/base/cell_grid.py:224-226)."""
        return [max(int(math.floor(self.domain.lengths[d] / cell)), 1)
                if self.periodic[d] else dims[d] for d in range(3)]

    def __repr__(self):
        return 'CellGrid(dim=%d, dims=%s, cell_slack=%g)' % (
            self.dim, self.dims, self.cell_slack)

    def half_margin(self):
        """The Verlet margin's half over hmax: ``0.5 (cell_slack - 1)
        radius_scale`` (pysph_tpu/sph/acceleration_eval.py:883)."""
        return 0.5 * (self.cell_slack - 1.0) * self.radius_scale

    @staticmethod
    def padded_dims(extent, width, dim):
        """Cell counts for a box of ``extent`` (3,) and cells of
        ``width``: ``PAD`` of headroom on each side and 3 cells more, on
        each axis below ``dim`` (pysph_tpu/base/cell_grid.py:228-230)."""
        return [int(extent[d] * (1 + 2 * PAD) / width) + 3 if d < dim
                else 1 for d in range(3)]

    @classmethod
    def from_particles(cls, particle_arrays, dim, radius_scale,
                       cell_slack=1.1, stratify=False, domain=None):
        """Size the grid to the bounding box of the particles, padded, for
        cells ``cell_slack`` times the support (the parameter and default
        of ``pysph_tpu``'s ``GridSpec.from_particles``); on the periodic
        axes of ``domain``, to the box."""
        if stratify:
            raise NotImplementedError('stratified variable-h binning is not '
                                      'ported yet (ROADMAP Queue 1, item 27)')
        los, his, hmax = [], [], 0.0
        for pa in particle_arrays:
            if pa.get_number_of_particles() == 0:
                continue
            xyz = np.stack([pa.x, pa.y, pa.z])
            los.append(xyz.min(axis=1))
            his.append(xyz.max(axis=1))
            hmax = max(hmax, float(np.max(pa.h)))
        if not los or hmax <= 0.0:
            raise ValueError('cannot size a cell grid without particles '
                             'of positive h')
        extent = np.max(his, axis=0) - np.min(los, axis=0)
        width = cell_slack * radius_scale * hmax
        grid = cls(dim, radius_scale, cls.padded_dims(extent, width, dim),
                   cell_slack, domain)
        grid.cell = width
        if grid.is_periodic:
            grid._set_dims(grid.sized_dims(grid.dims, width))
        return grid

    def grow(self, states):
        """Re-size the grid as ``resize`` does, after particles left
        it."""
        self.resize(states)
        self.grows += 1

    def resize(self, states, cell_slack=None):
        """Re-size the cell counts from the states' current bounding box
        and hmax, padded as ``from_particles`` does (one device-to-host
        copy), for cells ``cell_slack`` times the support where given.
        The grid is changed in place, so every evaluator that shares it
        bins on the new counts; every handle of the grid is invalidated,
        so its next test rebuilds it (made anew where the counts
        changed)."""
        if cell_slack is not None:
            self.cell_slack = float(cell_slack)
        lo, hi, hnow = self._box(states)
        box = torch.cat([hi - lo, hnow.reshape(1)]).tolist()
        width = self.cell_slack * self.radius_scale * box[3]
        self.cell = width
        self._set_dims(self.sized_dims(
            self.padded_dims(box[:3], width, self.dim), width))
        self.overflow = self.overflow_any = None
        for handle in list(self._handles):
            handle.invalidate()

    def handle_for(self, handle, states):
        """``handle`` where it fits the grid and ``states``, else a new,
        empty one of the grid (whose first test rebuilds it)."""
        if handle is not None and handle.fits(self, states):
            return handle
        handle = GridHandle(self, states)
        self._handles.add(handle)
        return handle

    def nonfinite_flag(self, device):
        """The grid's ``nonfinite`` flag on ``device`` (made where
        missing: by the first binning, which no capture holds)."""
        device = torch.device(device)
        if device.type == 'cuda' and device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        if self.nonfinite is None or self.nonfinite.device != device:
            self.nonfinite = torch.zeros((), dtype=torch.bool,
                                         device=device)
        return self.nonfinite

    def check_finite(self, flag=None):
        """Raise ``FloatingPointError`` where a binning met a position or
        h that is not finite: ``flag`` is the flag as the caller read it
        (a bool), else it is read here (one read).  Clears the flag."""
        if flag is None:
            flag = self.nonfinite is not None and bool(self.nonfinite)
        if flag:
            self.nonfinite.zero_()
            raise FloatingPointError(
                'a position or h is not finite: the binning refused the '
                'state (the run blew up)')

    def note_overflow(self, flag):
        """OR a binning's overflow flag into ``overflow`` (which it sets
        where None) and, where kept, ``overflow_any``."""
        self.overflow = flag if self.overflow is None else \
            self.overflow | flag
        if self.overflow_any is not None:
            self.overflow_any = self.overflow_any | flag

    # -- the torch pair engine's capacities ----------------------------
    def pair_capacity(self, dest, src, device):
        """The ``PairCapacity`` of the lists of ``dest`` against
        ``src`` (made where missing, unsized)."""
        cap = self.pair_caps.get((dest, src))
        if cap is None:
            cap = self.pair_caps[dest, src] = PairCapacity(device)
        return cap

    def watch_pairs(self):
        """Keep the torch engine's overflow flags from here on, in
        ``pair_overflow`` (where a capacity exists; made on its
        device)."""
        if self.pair_caps:
            need = next(iter(self.pair_caps.values())).need
            self.pair_overflow = torch.zeros((), dtype=torch.bool,
                                             device=need.device)

    def pairs_overflowed(self):
        """Whether a list overflowed since ``watch_pairs`` (one read where
        a flag was kept); stops keeping the flag."""
        flag, self.pair_overflow = self.pair_overflow, None
        return flag is not None and bool(flag)

    def grow_pairs(self):
        """Raise each capacity that a list outgrew to ``PAIR_GROWTH``
        times the count it needed (one read of every ``need``).  Returns
        the {(dest, source): (candidates, pairs)} grown."""
        keys = list(self.pair_caps)
        needs = torch.stack([self.pair_caps[k].need for k in keys]).tolist()
        grown = {}
        for key, (cand, pairs) in zip(keys, needs):
            cap = self.pair_caps[key]
            if cand > cap.candidates or pairs > cap.pairs:
                cap.candidates = max(cap.candidates,
                                     math.ceil(PAIR_GROWTH * cand))
                cap.pairs = max(cap.pairs, math.ceil(PAIR_GROWTH * pairs))
                grown[key] = (cap.candidates, cap.pairs)
        return grown

    def pair_key(self):
        """The capacities as a tuple (what a captured graph bakes in)."""
        return tuple((k, c.candidates, c.pairs)
                     for k, c in sorted(self.pair_caps.items()))

    @staticmethod
    def _box(states):
        """(lowest (3,), highest (3,), hmax ()) tensors of the particles
        of ``states`` on their device."""
        los, his, hmax = [], [], None
        for s in states:
            if s['x'].numel() == 0:
                continue
            lo, hi = torch.aminmax(torch.stack([s['x'], s['y'], s['z']]),
                                   dim=1)
            los.append(lo)
            his.append(hi)
            h = s['h'].max()
            hmax = h if hmax is None else torch.maximum(hmax, h)
        return (torch.stack(los).min(dim=0).values,
                torch.stack(his).max(dim=0).values, hmax)

    def offsets(self, device):
        """(S, 3) stencil offsets: -1..1 on each axis with more than one
        cell, 0 elsewhere (3^dim cells for a full grid), -1..0 on a
        periodic axis of two cells (``_stencil_offsets``,
        pysph_tpu/base/cell_grid.py:29-43); made once per size and
        device, so that a list built in a CUDA graph's capture copies
        nothing there."""
        device = torch.device(device)
        if device not in self._offsets:
            self._offsets[device] = torch.tensor(
                self.stencil_offsets(), dtype=torch.int64, device=device)
        return self._offsets[device]

    def axis_offsets(self, d):
        """The stencil offsets of axis ``d``."""
        n = self.dims[d]
        if n == 1:
            return (0,)
        if self.periodic[d] and n == 2:
            return (-1, 0)
        return (-1, 0, 1)

    def stencil_offsets(self):
        """[(ox, oy, oz)] of the stencil, z outermost and x innermost:
        the order of the walk."""
        axes = [self.axis_offsets(d) for d in range(3)]
        return [(a, b, c) for c in axes[2] for b in axes[1]
                for a in axes[0]]

    def box_host(self, dtype):
        """The periodic geometry in ``dtype``'s values, as Python floats
        (for a kernel's arguments): ``mins``, the box's lower corner;
        ``lengths``, the box lengths; ``widths``, the cell widths ``L /
        dims`` (each rounded once to ``dtype``) on the periodic axes, 0,
        1 and 1 elsewhere; ``stale``, the least periodic width, inf where
        no axis is periodic."""
        np_t = np.float64 if dtype == torch.float64 else np.float32
        dom = self.domain
        mins = [np_t(dom.mins[d] if self.periodic[d] else 0.0)
                for d in range(3)]
        lengths = [np_t(dom.lengths[d] if self.periodic[d] else 1.0)
                   for d in range(3)]
        widths = [lengths[d] / np_t(self.dims[d]) if self.periodic[d]
                  else np_t(1.0) for d in range(3)]
        stale = min([widths[d] for d in range(3) if self.periodic[d]],
                    default=np_t(np.inf))
        return dict(mins=[float(v) for v in mins],
                    lengths=[float(v) for v in lengths],
                    widths=[float(v) for v in widths], stale=float(stale))

    def box_consts(self, dtype, device):
        """``box_host`` as tensors of ``dtype`` on ``device`` (``mins``,
        ``lengths``, ``widths`` (3,), ``stale`` ()), and ``mask`` (3,)
        bool, the periodic axes; made once per size, so that a binning in
        a CUDA graph's capture copies nothing there."""
        key = (dtype, torch.device(device))
        if key not in self._consts:
            host = self.box_host(dtype)
            self._consts[key] = {
                k: torch.tensor(v, dtype=dtype, device=device)
                for k, v in host.items()}
            self._consts[key]['mask'] = torch.tensor(self.periodic,
                                                     device=device)
        return self._consts[key]

    def origin(self, lo):
        """The binning's origin from the particles' lowest coordinates
        ``lo`` (3,): the box's lower corner on the periodic axes."""
        if not self.is_periodic:
            return lo
        c = self.box_consts(lo.dtype, lo.device)
        return torch.where(c['mask'], c['mins'], lo)

    def stale_width(self, width):
        """The least cell width of a binning of width ``width`` (): the
        periodic axes' ``L / dims`` and, where an axis below ``dim`` is
        not periodic, ``width`` (the ``min(widths[:dim])`` of
        ``pysph_tpu``'s reuse test); 0 where ``width`` is 0, so that an
        invalidated handle is rebuilt on any grid."""
        if not self.is_periodic:
            return width
        stale = self.box_consts(width.dtype, width.device)['stale']
        if all(self.periodic[:self.dim]):
            return torch.where(width > 0, stale, width)
        return torch.minimum(width, stale)

    def _widest_cells(self):
        """Whether every periodic axis has one cell: no sizing can widen
        the cells (a support wider than the box is the minimum image's
        limit, not the grid's)."""
        return all(n == 1 for n, per in zip(self.dims, self.periodic)
                   if per)

    def cells_small(self, width):
        """0-d device bool: whether a binning of width ``width`` (the
        support of its hmax, slack included) is wider than a cell of the
        periodic axes, whose counts do not follow h (False on an open
        grid and where the periodic cells are as wide as the box).
        Nothing is read back."""
        if not self.is_periodic or self._widest_cells():
            return torch.zeros_like(width, dtype=torch.bool)
        return width > self.stale_width(width) * 1.0001

    def outgrown(self, width):
        """Whether a binning of width ``width`` (a host float, the widest
        that a binning on these counts met) was wider than a periodic
        cell: it missed pairs, and its binning must be sized for
        ``width`` and what it evaluated run again."""
        return self.is_periodic and not self._widest_cells() and \
            width > self.box_host(torch.float64)['stale'] * 1.0001

    def oversized(self, width):
        """Whether a binning whose widest over a run was ``width`` (a host
        float; 0: none ran) would fit periodic cells of ``SHRINK`` of the
        width or less: it may be sized down for ``width``, with a factor
        of ~1.8 of hysteresis, so that an h that wanders re-sizes
        rarely."""
        return self.is_periodic and \
            0.0 < width <= SHRINK * self.box_host(torch.float64)['stale']

    def image(self, d, dx):
        """The minimum image of the displacements ``dx`` along axis
        ``d``: ``dx - L round(dx / L)`` on a periodic axis (L a tensor
        on the device, so that the division is the kernels' IEEE one),
        ``dx`` elsewhere."""
        if not self.periodic[d]:
            return dx
        L = self.box_consts(dx.dtype, dx.device)['lengths'][d]
        return dx - L * torch.round(dx / L)

    def escaped(self, origin, hi, width):
        """0-d device bool: whether the highest coordinates ``hi`` lie at
        or beyond ``origin + dims * width`` on an axis of more than one
        cell that is not periodic, where binning clamps them into the
        edge cell.  Nothing is read back."""
        top = torch.floor((hi - origin) / width)
        if self._limit is None or self._limit.device != top.device or \
                self._limit.dtype != top.dtype:
            # the counts on the device, inf on an axis of one cell or a
            # periodic one: made once per size, so that a binning copies
            # nothing there
            self._limit = torch.tensor(
                [n if n > 1 and not per else float('inf')
                 for n, per in zip(self.dims, self.periodic)],
                dtype=top.dtype, device=top.device)
        return (top >= self._limit).any()

    def cell_ids(self, state, origin, width):
        """(n,) int64 cell id of each particle: clamped into the grid on
        an axis that is not periodic, modulo the counts on a periodic
        one, whose cells have their own width (``box_consts``)."""
        cid = torch.zeros_like(state['x'], dtype=torch.int64)
        stride = 1
        for d, key in enumerate('xyz'):
            n = self.dims[d]
            if self.periodic[d]:
                w = self.box_consts(width.dtype, width.device)['widths'][d]
                c = torch.floor((state[key] - origin[d]) / w)
                cid += torch.remainder(c.to(torch.int64), n) * stride
            elif n > 1:
                c = torch.floor((state[key] - origin[d]) / width)
                cid += c.clamp_(0, n - 1).to(torch.int64) * stride
            stride *= n
        return cid

    def bin(self, state, origin, width):
        """The ``CellList`` of one state on cells of ``width`` from
        ``origin`` (the plain binning)."""
        cid = self.cell_ids(state, origin, width)
        _, order = torch.sort(cid, stable=True)
        # not bincount: on CUDA it reads max(cid) back to size its output
        counts = torch.zeros(self.ncells, dtype=torch.int64,
                             device=cid.device).index_add_(
                                 0, cid, torch.ones_like(cid))
        end = torch.cumsum(counts, 0)
        start = end - counts
        i32 = torch.int32
        return CellList(cid.to(i32), order.to(i32), start.to(i32),
                        end.to(i32))

    def bin_all(self, states):
        """{name: CellList} of a fresh binning of a dict of states, into a
        new handle (``ops/bin_cells.py``: on CUDA tensors the kernels);
        sets ``overflow`` to its flag and ORs it into ``overflow_any``."""
        from pysph_tpu_torch.ops.bin_cells import bin_cells
        handle = self.handle_for(None, states)
        flag = bin_cells(self, states, handle, force=True)
        self.overflow = None
        self.note_overflow(handle.overflow & flag)
        return handle.lists

    def neighbor_pairs(self, dest, dest_cells, src, src_cells, rows,
                       cap=None):
        """The pair list of the dest rows ``rows = (a, b)`` against the
        source: every pair in the 3^dim-cell stencil (wrapped on the
        periodic axes) with ``r2 < (radius_scale * max(hi, hj))^2`` (of
        the minimum image there), in stencil-row-cell order (the
        self-pair kept).  Without ``cap``: ``(i, j)`` (int64), compacted
        to its size, which is read back.  With a ``PairCapacity``: ``(i,
        j, w)`` of ``cap.pairs`` entries, nothing read back; the entries
        past the pair count have ``i = a``, ``j = 0`` and the write row
        ``w = n`` (one past the dest's rows), the others ``w = i``; see
        the module's docstring for the overflow."""
        a, b = rows
        dims = self.dims
        dev = dest['x'].device
        offs = self.offsets(dev)
        cell = dest_cells.cell[a:b].to(torch.int64)
        c = [cell % dims[0], (cell // dims[0]) % dims[1],
             cell // (dims[0] * dims[1])]
        valid = torch.ones((b - a, offs.shape[0]), dtype=torch.bool,
                           device=dev)
        ncell = torch.zeros_like(valid, dtype=torch.int64)
        stride = 1
        for d in range(3):
            nc = c[d][:, None] + offs[:, d]
            if self.periodic[d]:
                nc = torch.remainder(nc, dims[d])
            else:
                valid &= (nc >= 0) & (nc < dims[d])
                nc = nc.clamp(0, dims[d] - 1)
            ncell += nc * stride
            stride *= dims[d]
        start = src_cells.start[ncell].to(torch.int64).reshape(-1)
        cnt = torch.where(valid, (src_cells.end[ncell] -
                                  src_cells.start[ncell]).to(torch.int64),
                          0).reshape(-1)
        if cap is not None:
            return self._capped_pairs(dest, src, src_cells, a, start, cnt,
                                      offs.shape[0], cap)
        total = int(cnt.sum())
        seg = torch.repeat_interleave(
            torch.arange(cnt.numel(), device=dev), cnt, output_size=total)
        first = torch.cumsum(cnt, 0) - cnt
        pos = start[seg] + (torch.arange(total, device=dev) - first[seg])
        j = src_cells.order[pos].to(torch.int64)
        i = a + torch.div(seg, offs.shape[0], rounding_mode='floor')
        keep = self._in_support(dest, src, i, j)
        return i[keep], j[keep]

    def _in_support(self, dest, src, i, j):
        dx = self.image(0, dest['x'][i] - src['x'][j])
        dy = self.image(1, dest['y'][i] - src['y'][j])
        dz = self.image(2, dest['z'][i] - src['z'][j])
        r2 = dx ** 2 + dy ** 2 + dz ** 2
        rs = self.radius_scale
        sup = torch.maximum(rs * dest['h'][i], rs * src['h'][j])
        return r2 < sup * sup

    def _capped_pairs(self, dest, src, src_cells, a, start, cnt, n_offs,
                      cap):
        """``neighbor_pairs`` at the capacities of ``cap``: candidate
        ``k`` lies in the stencil segment whose running end first passes
        ``k`` (``searchsorted``), the in-support ones are scattered to
        their rank among them; nothing is read back."""
        dev = cnt.device
        n_dest = dest['x'].shape[0]
        ends = torch.cumsum(cnt, 0)
        total = ends[-1]
        k = torch.arange(cap.candidates, device=dev)
        if src['x'].shape[0] == 0:
            k = k[:0]
        seg = torch.searchsorted(ends, k, right=True).clamp_(
            max=cnt.numel() - 1)
        live = k < total
        pos = torch.where(live, start[seg] + (k - (ends[seg] - cnt[seg])),
                          0)
        j = src_cells.order[pos].to(torch.int64)
        i = a + torch.div(seg, n_offs, rounding_mode='floor')
        keep = live & self._in_support(dest, src, i, j)
        rank = torch.cumsum(keep, 0) - 1
        n_pairs = rank[-1] + 1 if rank.numel() else total.new_zeros(())
        slot = torch.where(keep & (rank < cap.pairs), rank, cap.pairs)
        out_i = torch.full((cap.pairs + 1,), a, dtype=torch.int64,
                           device=dev).scatter_(0, slot, i)[:-1]
        out_j = torch.zeros(cap.pairs + 1, dtype=torch.int64,
                            device=dev).scatter_(0, slot, j)[:-1]
        out_w = torch.where(torch.arange(cap.pairs, device=dev) < n_pairs,
                            out_i, n_dest)
        counts = torch.stack([total, n_pairs])
        cap.need.copy_(torch.maximum(cap.need, counts))
        if self.pair_overflow is not None:
            self.pair_overflow = self.pair_overflow | (
                (total > cap.candidates) | (n_pairs > cap.pairs))
        return out_i, out_j, out_w


class GridView(CellGrid):
    """A ``CellGrid`` with periodic counts of its own (``CellGrid.
    cells_for``): the geometry of a binning sized for its own h.  It
    holds its counts and what is derived from them (the stencil, the
    periodic widths, the limits); every other attribute, the flags and
    the torch engine's capacities among them, is the grid's, read and
    written through.  Re-sizing (``grow``, ``resize``, ``set_domain``)
    is the grid's."""

    _OWN = frozenset(('_base', 'dims', 'ncells', '_limit', '_offsets',
                      '_consts', '_views'))

    def __init__(self, base, dims):
        object.__setattr__(self, '_base', base)
        self._set_dims(dims)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, '_base'), name)

    def __setattr__(self, name, value):
        if name in GridView._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self._base, name, value)

    def __repr__(self):
        return 'GridView(%r, dims=%s)' % (self._base, self.dims)

    def cells_for(self, cell):
        return self._base.cells_for(cell)

    def grow(self, states):
        self._base.grow(states)

    def resize(self, states, cell_slack=None):
        self._base.resize(states, cell_slack)

    def set_domain(self, domain):
        self._base.set_domain(domain)
