"""Sorted cell list: the neighbour structure of the port.

Replaces the capacity-M dense grid of ``pysph_tpu/base/cell_grid.py``.
The TPU needed fixed-shape (cells, M) blocks because Mosaic has no
gather; a GPU gathers, so each array is binned into a uniform grid and
sorted by cell id:

- cell id per particle: ``ix + nx * (iy + ny * iz)``, with
  ``i = floor((x - origin) / width)`` clamped into the grid;
- ``order = argsort(cell id)`` (stable), and per cell the half-open range
  ``[start, end)`` of positions in ``order``.

There is no per-cell capacity, so nothing can overflow and no step has
to be redone.  The cell width is at least ``radius_scale * hmax``, so a
pair within support lies in the same or an adjacent cell.  Clamping
keeps that true for particles outside the grid: two coordinates less
than one width apart floor to cells at most one apart, and clamping
cannot widen the gap.  The grid's origin and width follow the particles
at every binning; its cell counts are sized at setup with ``PAD`` of
headroom and 3 cells, as ``pysph_tpu``'s ``GridSpec`` is.  Clamping is
correct but piles escaped particles into the edge cells, so each binning
also sets ``overflow``, a device flag that some particle lies beyond
the grid, and the solver ``grow``s the grid when it reads it.

Particles keep their order: consumers read sources through ``order``.
"""

from typing import NamedTuple

import torch

# Headroom over radius_scale * hmax so that a pair exactly at the
# support radius cannot land two cells apart through rounding of the
# cell coordinate.
CELL_SLACK = 1.001
#: headroom of the cell counts on each side of the particles' extent
#: (pysph_tpu/base/cell_grid.py:168)
PAD = 0.03


class CellList(NamedTuple):
    """One array binned on a ``CellGrid``."""
    cell: torch.Tensor    # (n,) int32 cell id of each particle
    order: torch.Tensor   # (n,) int32 particle indices sorted by cell
    start: torch.Tensor   # (ncells,) int32 first position in ``order``
    end: torch.Tensor     # (ncells,) int32 one past the last


class CellGrid(object):
    """Cell counts of the grid; bins particle states into ``CellList``s.

    ``overflow`` is the last binning's device flag (None before the
    first); ``overflow_any``, once set to a flag, ORs in every later
    binning's (the solver's chunks set and read it; None: not kept);
    ``grows`` counts the calls of ``grow``."""

    def __init__(self, dim, radius_scale, dims):
        self.dim = int(dim)
        self.radius_scale = float(radius_scale)
        self._set_dims(dims)
        self.overflow = None
        self.overflow_any = None
        self.grows = 0

    def _set_dims(self, dims):
        dims = tuple(int(d) for d in dims)
        self.dims = dims + (1,) * (3 - len(dims))
        self.ncells = self.dims[0] * self.dims[1] * self.dims[2]
        self._limit = None

    def __repr__(self):
        return 'CellGrid(dim=%d, dims=%s)' % (self.dim, self.dims)

    @staticmethod
    def padded_dims(extent, width, dim):
        """Cell counts for a box of ``extent`` (3,) and cells of
        ``width``: ``PAD`` of headroom on each side and 3 cells more, on
        each axis below ``dim`` (pysph_tpu/base/cell_grid.py:228-230)."""
        return [int(extent[d] * (1 + 2 * PAD) / width) + 3 if d < dim
                else 1 for d in range(3)]

    @classmethod
    def from_particles(cls, particle_arrays, dim, radius_scale):
        """Size the grid to the bounding box of the particles, padded."""
        import numpy as np
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
        width = CELL_SLACK * radius_scale * hmax
        return cls(dim, radius_scale, cls.padded_dims(extent, width, dim))

    def grow(self, states):
        """Re-size the cell counts from the states' current bounding box
        and hmax, padded as ``from_particles`` does (one device-to-host
        copy).  The grid is changed in place, so every evaluator that
        shares it bins on the new counts from its next binning on; the
        ``CellList``s of earlier binnings no longer fit it."""
        lo, hi, hmax = self._box(states)
        box = torch.cat([hi - lo, hmax.reshape(1)]).tolist()
        width = CELL_SLACK * self.radius_scale * box[3]
        self._set_dims(self.padded_dims(box[:3], width, self.dim))
        self.overflow = self.overflow_any = None
        self.grows += 1

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
        cell, 0 elsewhere (3^dim cells for a full grid)."""
        axes = [(-1, 0, 1) if self.dims[d] > 1 else (0,)
                for d in range(3)]
        return torch.tensor([(a, b, c) for c in axes[2] for b in axes[1]
                             for a in axes[0]], dtype=torch.int64,
                            device=device)

    def geometry(self, states):
        """(origin (3,), width (), overflow ()) tensors on the states'
        device: the lower corner of all particles, the cell width, and
        whether some particle lies at or beyond ``origin + dims * width``
        on an axis of more than one cell, where binning clamps it into
        the edge cell.  Nothing is read back."""
        origin, hi, hmax = self._box(states)
        width = CELL_SLACK * self.radius_scale * hmax
        top = torch.floor((hi - origin) / width)
        if self._limit is None or self._limit.device != top.device or \
                self._limit.dtype != top.dtype:
            # the counts on the device, inf on an axis of one cell: made
            # once per size, so that a binning copies nothing there
            self._limit = torch.tensor(
                [n if n > 1 else float('inf') for n in self.dims],
                dtype=top.dtype, device=top.device)
        return origin, width, (top >= self._limit).any()

    def cell_ids(self, state, origin, width):
        """(n,) int64 cell id of each particle."""
        cid = torch.zeros_like(state['x'], dtype=torch.int64)
        stride = 1
        for d, key in enumerate('xyz'):
            n = self.dims[d]
            if n > 1:
                c = torch.floor((state[key] - origin[d]) / width)
                cid += c.clamp_(0, n - 1).to(torch.int64) * stride
            stride *= n
        return cid

    def bin(self, state, origin, width):
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
        """{name: CellList} for a dict of states binned on one grid; sets
        ``overflow`` (``geometry``) and ORs it into ``overflow_any``."""
        origin, width, self.overflow = self.geometry(states.values())
        if self.overflow_any is not None:
            self.overflow_any = self.overflow_any | self.overflow
        return {name: self.bin(s, origin, width)
                for name, s in states.items()}

    def neighbor_pairs(self, dest, dest_cells, src, src_cells, rows):
        """Compacted pair list ``(i, j)`` (int64) of the dest rows
        ``rows = (a, b)`` against the source: every pair in the
        3^dim-cell stencil with ``r2 < (radius_scale * max(hi, hj))^2``.
        The self-pair is kept."""
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
            valid &= (nc >= 0) & (nc < dims[d])
            ncell += nc.clamp(0, dims[d] - 1) * stride
            stride *= dims[d]
        start = src_cells.start[ncell].to(torch.int64).reshape(-1)
        cnt = torch.where(valid, (src_cells.end[ncell] -
                                  src_cells.start[ncell]).to(torch.int64),
                          0).reshape(-1)
        total = int(cnt.sum())
        seg = torch.repeat_interleave(
            torch.arange(cnt.numel(), device=dev), cnt, output_size=total)
        first = torch.cumsum(cnt, 0) - cnt
        pos = start[seg] + (torch.arange(total, device=dev) - first[seg])
        j = src_cells.order[pos].to(torch.int64)
        i = a + torch.div(seg, offs.shape[0], rounding_mode='floor')
        dx = dest['x'][i] - src['x'][j]
        dy = dest['y'][i] - src['y'][j]
        dz = dest['z'][i] - src['z'][j]
        r2 = dx ** 2 + dy ** 2 + dz ** 2
        rs = self.radius_scale
        sup = torch.maximum(rs * dest['h'][i], rs * src['h'][j])
        keep = r2 < sup * sup
        return i[keep], j[keep]
