"""The hand-off of a linked pair of pair-kernel calls: one call walks and
writes a neighbour list, a later call of the same dest reads it instead
of walking again.

Seven kernels run linked calls (``ops/pair_engine.py::link_pairs`` and
``link_sweep`` form them): ``delta_pair`` (the moment launch emits, the
corrected gradient launch consumes), ``tvf_pair`` (the density launch
emits, the momentum launch consumes), ``iisph_pair`` (a dest's first
launch that sees all its sources emits, every later launch of its
evaluation reads, the pressure sweep's again each sweep; a reader may
take fewer of the emitter's sources), ``gasd_pair`` (each sweep of
``GasDScheme``'s density iteration emits, ``MPMAccelerations``' launch
reads the last one's list where the hand-off's ``use`` flag says that
the iteration ended converged, and walks elsewhere) and ``gsph_pair``
(``GSPHScheme``'s gradients launch emits, its acceleration launch reads
the list and the gradients' copies of planes 0-2) and ``crksph_pair``
(``CRKSPHScheme``'s number density launch emits, the moments, density,
velocity gradient and momentum launches of the same evaluation read, a
group of lanes a dest taking every G-th entry; its capacity is its own,
``crksph_pair.CAPACITY``) and ``tsph_pair`` (each sweep of
``TSPHScheme``'s density iteration emits, as ``gasd_pair``'s, and its
velocity gradient and momentum launches read the last one's list where
the hand-off's ``use`` flag is set).  Nothing between the
two calls moves ``x y z h``, so the emitting call's pairs in support are
the consuming call's, in the same order.  The emitting call returns,
beside its output, a ``Handoff``: its sources' packed copies and the
neighbour list, each dest's in-support source positions in the walk's
order (``neighbours_reference``), up to ``CAPACITY[dim]`` a dest, with
its count.  A consuming warp that holds a dest past the capacity walks; the
emitting launch counts such dests on the card (``overflowed``).  The
plans of a pair share a ``Link``, through which the evaluator runs them.
"""

from typing import NamedTuple

import torch

#: entries of the neighbour list a dest, by the kernel's dim: the most
#: pairs a dest held on the card, 81 in dam_break_3d dx=0.02 after its
#: damped steps (3D) and 45 in the perturbed drop (2D), with headroom
#: (PERF.md); a dest past it makes its warp walk (``crksph_pair`` has a
#: capacity of its own)
CAPACITY = {1: 16, 2: 64, 3: 128}


class Handoff(NamedTuple):
    """What an emitting call leaves for its consuming call: the sources'
    packed copies, one after another (``cell_pack.fill``'s buffer), and
    the neighbour list: ``nbr[c, p]`` is the c-th source position in
    support of the dest at sorted position ``p`` (in the numbering of
    ``neighbours_reference``), for ``c < min(count[p], capacity)``;
    ``count[p]`` may exceed the capacity ``nbr.shape[0]``.  ``sources``:
    ((name, particles), ...) of the copies; ``planes``: the record planes
    of each copy, plane 0 ``{x y z h}`` first (None: plane 0 alone);
    ``use``: a 0-d device bool, where given the consumer reads the list
    only where it is set and walks elsewhere (``gasd_pair``'s momentum
    launch: set where the density iteration ended converged).  On the
    CPU, where the plain consumer walks, ``buf`` and ``nbr`` are empty
    and ``count`` is None."""
    buf: torch.Tensor
    nbr: torch.Tensor
    count: torch.Tensor
    sources: tuple
    planes: tuple = None
    use: torch.Tensor = None

    def plane0(self):
        """The offset in ``buf``, in values, of each copy's plane 0."""
        offsets, off = [], 0
        for k, (_, n) in enumerate(self.sources):
            offsets.append(off)
            off += 4 * n * (1 if self.planes is None else self.planes[k])
        return offsets, off


def copies_of(sources):
    """((name, particles), ...) of a call's (state, cells, spec)
    sources."""
    return tuple((spec.name, st['x'].shape[0]) for st, _, spec in sources)


def empty_handoff(dest, sources):
    """The hand-off of an emitting call whose consumer walks (the plain
    versions on the CPU): no copies and no list."""
    x = dest['x']
    return Handoff(x.new_empty(0), torch.empty(
        (0, x.shape[0]), dtype=torch.int32, device=x.device), None,
        copies_of(sources))


def check_handoff(name, handoff, dest, sources):
    """Raise unless ``handoff`` was emitted by a call over ``sources`` on
    ``dest``'s device for as many dests."""
    x = dest['x']
    if handoff.sources != copies_of(sources) or \
            handoff.buf.dtype != x.dtype or \
            handoff.buf.device != x.device or \
            handoff.nbr.shape[1] != x.shape[0]:
        raise ValueError('%s: a hand-off of %s for %d dests on %s, given to '
                         'a call over %s for %d dests on %s' % (
                             name, handoff.sources, handoff.nbr.shape[1],
                             handoff.buf.device, copies_of(sources),
                             x.shape[0], x.device))


def neighbours_reference(dest, dest_cells, sources, grid):
    """The pairs in support of each dest in the kernels' walk order:
    (count, positions).  ``count``: int32 (n,), the pairs of the dest at
    each sorted position of ``dest_cells.order``; ``positions``: int32,
    the dests' source positions one dest after another in that order,
    each dest's in the walk's order: the sources in order, then the
    stencil rows (z outer, y inner), x by stencil offset, position
    (``grid.neighbor_pairs``' order).  On a periodic grid that is the
    order of ``csrc/cell_walk.cuh::walk_rows_periodic``: the rows wrap, a
    row crossing the grid's end on x takes its cells before the end,
    then those from cell 0 (``ops/cell_walk.py::periodic_spans``), and on
    an axis of one or two cells the stencil shrinks
    (``CellGrid.axis_offsets``).  Source s's position k is numbered
    ``base_s + k``, ``base_s`` the particles of the sources before it."""
    from pysph_tpu_torch.sph.acceleration_eval import PAIR_CHUNK
    x = dest['x']
    n, dev = x.shape[0], x.device
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[dest_cells.order.long()] = torch.arange(n, device=dev)
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    keys, vals, base = [none], [none], 0
    for s, (src, cells, _) in enumerate(sources):
        ns = src['x'].shape[0]
        where = torch.empty(ns, dtype=torch.int64, device=dev)
        where[cells.order.long()] = torch.arange(ns, device=dev)
        for a in range(0, n, PAIR_CHUNK):
            i, j = grid.neighbor_pairs(dest, dest_cells, src, cells,
                                       (a, min(n, a + PAIR_CHUNK)))
            keys.append(rank[i] * len(sources) + s)
            vals.append(base + where[j])
        base += ns
    key = torch.cat(keys)
    # stable: a (dest, source)'s pairs keep neighbor_pairs' order
    key, perm = torch.sort(key, stable=True)
    count = torch.bincount(key // len(sources), minlength=n)
    return count.to(torch.int32), torch.cat(vals)[perm].to(torch.int32)


def _slots(kept):
    """(dest, slot) of every entry of lists of ``kept`` entries a dest."""
    p = torch.repeat_interleave(torch.arange(kept.shape[0],
                                             device=kept.device), kept)
    c = torch.arange(p.shape[0], device=p.device) - torch.repeat_interleave(
        torch.cumsum(kept, 0) - kept, kept)
    return p, c


def cut(count, positions, capacity):
    """``positions`` (``neighbours_reference``'s) without each dest's
    entries past ``capacity``."""
    _, c = _slots(count.long())
    return positions[c < capacity]


def listed(handoff):
    """(count, positions) of a hand-off's neighbour list, as
    ``neighbours_reference`` gives them, each dest's list cut at the
    capacity (``cut``)."""
    nbr = handoff.nbr
    p, c = _slots(handoff.count.long().clamp(max=nbr.shape[0]))
    return handoff.count, nbr[c, p]


_OVERFLOW = {}


def overflow_counter(name, device):
    """The int32 device counter to which every emitting launch of the
    kernel ``name`` adds its dests past the capacity.  Made on first
    use, which a CUDA graph capture must not be."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    if (name, device) not in _OVERFLOW:
        if device.type == 'cuda' and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError('%s: the overflow counter of %s is made in '
                               'a capture; emit once before it'
                               % (name, device))
        _OVERFLOW[name, device] = torch.zeros(1, dtype=torch.int32,
                                              device=device)
    return _OVERFLOW[name, device]


def overflowed(name, device):
    """The dests past the capacity that ``name``'s emitting launches
    counted since the last ``reset_overflow`` (reads the counter)."""
    return int(overflow_counter(name, device)[0])


def reset_overflow(name, device):
    overflow_counter(name, device).zero_()


class Link(object):
    """An emitting plan and the consuming plan of a later group, linked
    by ``ops/pair_engine.py::link_pairs``, and the plans of the groups
    between them that read the same list (``middle``: ``tvf_pair``'s
    mean-pressure plan between the density and the momentum plan of
    ``EDACScheme`` with walls; ``iisph_pair``'s plans between the
    emitter and the force, some run once a pressure sweep): the
    evaluator runs them through ``run``, the hand-off kept until the
    last consumer takes it."""

    def __init__(self, emitter, consumer, middle=()):
        self.emitter = emitter
        self.consumer = consumer
        self.middle = tuple(middle)
        self.handoff = None

    @property
    def consumers(self):
        return self.middle + (self.consumer,)

    def run(self, plan, args):
        """The result of ``plan`` (one of the link's) on its
        arguments."""
        if plan is self.emitter:
            out, self.handoff = plan.op(*args, emit=True)
            return out
        handoff = self.handoff
        if plan is self.consumer:
            self.handoff = None
        if handoff is None:
            raise RuntimeError('%s: the linked consumer of %s runs without '
                               'the hand-off of its emitting call'
                               % (plan.op.__name__, plan.dest))
        return plan.op(*args, handoff=handoff)
