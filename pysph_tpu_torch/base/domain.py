"""Domain manager: the simulation box, its periodic axes and the wrap.

Port of ``pysph_tpu/base/domain.py``.  Periodicity is algebraic, as
there: no ghost particles are made; cell ids wrap modulo the grid on a
periodic axis (``base/cell_grid.py``, ``csrc/bin_cells.cu``), the stencil
wraps with them (``csrc/cell_walk.cuh``), and every pair displacement
takes its minimum image.  That is exact for boxes wider than two support
radii.  The operations are plain torch functions on tensors of any
device, so the integrator wraps positions inside a captured chunk.

Mirror boundaries (the reference's reflected ghost particles) are not
ported: ``mirror_in_*`` raises ``NotImplementedError``.
"""

import torch

_MIRROR_ITEM = 'ROADMAP Queue 1 item 27'


class DomainManager(object):
    def __init__(self, xmin=-1000.0, xmax=1000.0, ymin=0.0, ymax=0.0,
                 zmin=0.0, zmax=0.0, periodic_in_x=False, periodic_in_y=False,
                 periodic_in_z=False, n_layers=2.0, mirror_in_x=False,
                 mirror_in_y=False, mirror_in_z=False, props=None):
        if mirror_in_x or mirror_in_y or mirror_in_z:
            raise NotImplementedError('mirror boundaries are not ported yet '
                                      '(%s)' % _MIRROR_ITEM)
        self.xmin, self.xmax = float(xmin), float(xmax)
        self.ymin, self.ymax = float(ymin), float(ymax)
        self.zmin, self.zmax = float(zmin), float(zmax)
        self.periodic_in_x = bool(periodic_in_x)
        self.periodic_in_y = bool(periodic_in_y)
        self.periodic_in_z = bool(periodic_in_z)
        self.n_layers = n_layers
        self.props = props
        self.is_periodic = any(self.periodic)

    def __repr__(self):
        return ('DomainManager(periodic=%s%s%s)' %
                tuple('xyz'[i] if f else ''
                      for i, f in enumerate(self.periodic)))

    @property
    def periodic(self):
        return (self.periodic_in_x, self.periodic_in_y, self.periodic_in_z)

    @property
    def mins(self):
        return (self.xmin, self.ymin, self.zmin)

    @property
    def lengths(self):
        return (self.xmax - self.xmin, self.ymax - self.ymin,
                self.zmax - self.zmin)

    def wrap_positions(self, x, y, z):
        """Box-wrap the periodic coordinates: ``lo + (c - lo) mod L``
        (``torch.remainder``, the floored modulo of ``jnp.mod``)."""
        out = []
        for c, lo, L, flag in zip((x, y, z), self.mins, self.lengths,
                                  self.periodic):
            out.append(lo + torch.remainder(c - lo, L) if flag else c)
        return tuple(out)

    def wrap_state(self, state):
        """``state`` with its positions wrapped (a new dict; the same one
        where no axis is periodic)."""
        if not self.is_periodic:
            return state
        out = dict(state)
        out['x'], out['y'], out['z'] = self.wrap_positions(
            state['x'], state['y'], state['z'])
        return out

    def minimum_image(self, dx, dy, dz):
        """The minimum image of pair displacements: ``d - L round(d /
        L)`` on each periodic axis, ``torch.round`` rounding half to even
        as ``jnp.round`` does."""
        out = []
        for d, L, flag in zip((dx, dy, dz), self.lengths, self.periodic):
            out.append(d - L * torch.round(d / L) if flag else d)
        return tuple(out)
