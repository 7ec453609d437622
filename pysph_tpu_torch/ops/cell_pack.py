"""The packed, cell-sorted copy of a pair call's sources: layout, wrapper,
launch counter and plain version.

Every pair kernel reads each source through a copy made for the call:
position ``k`` holds particle ``order[k]`` (the source's cell order), as
records of four values of the working type in planes.  Each kernel names
its planes in a table of four prop names each (``None``: always 0):
``ops/wcsph_pair.py``, ``ops/gtvf_pair.py`` and ``ops/fused_pair.py``
``PACK_RECORDS``, and the same table in a comment of the ``.cu``.  A
name is a prop of stride 1 or ``(prop, c)``, column ``c`` of a strided
prop (an ``(n, k)`` tensor, e.g. ``('gradrho', 0)``).  A source packs
plane 0 (``{x y z h}``, read by every candidate's support test) and each
plane that holds a prop its terms read (``layout``), and a prop its
terms do not read is written as 0.

A pack is given as ``(state, order, planes)``: the source's state dict,
its ``CellList.order`` and the prop names of the planes it packs.  For
CUDA tensors ``pack`` launches ``csrc/cell_pack.cu`` once for all the
sources of a call and counts the launch in ``pack.launches``; the walks'
launch functions launch the same kernel before their walk (their
wrappers fill its ``PackArgs`` with ``fill`` and count it there).  For
CPU tensors ``pack`` calls ``pack_reference``.
"""

import ctypes
import functools

import torch

from pysph_tpu_torch.ops import build
from pysph_tpu_torch.ops.build import data_ptr

MAX_SOURCES = 4
#: record planes a source can pack (csrc/cell_pack.cuh kMaxPlanes)
MAX_PLANES = 10


@functools.lru_cache(maxsize=None)
def layout(table, reads):
    """(slots, planes) of a source whose terms read the props ``reads``
    (a frozenset): the indices into ``table`` of the planes it packs,
    plane 0 and each one holding a prop of ``reads``, and their prop
    names, ``None`` where ``reads`` lacks the prop."""
    slots = tuple(q for q, names in enumerate(table)
                  if q == 0 or reads.intersection(names))
    return slots, tuple(tuple(p if p in reads else None for p in table[q])
                        for q in slots)


def column(state, name):
    """The ``(n,)`` values a plane name stands for: ``state[name]``, or
    column ``c`` of ``state[prop]`` for ``(prop, c)``."""
    if isinstance(name, tuple):
        prop, c = name
        return state[prop][:, c]
    return state[name]


def pack_reference(packs):
    """Plain torch version of ``pack``: for each ``(state, order,
    planes)`` the ``(len(planes), n, 4)`` records gathered through
    ``order``."""
    out = []
    for state, order, planes in packs:
        idx = order.long()
        zero = torch.zeros_like(state['x'][idx])
        out.append(torch.stack([
            torch.stack([zero if p is None else column(state, p)[idx]
                         for p in names], dim=1)
            for names in planes]))
    return out


class _PackSrc(ctypes.Structure):
    _fields_ = [('prop', (ctypes.c_void_p * 4) * MAX_PLANES),
                ('stride', (ctypes.c_int32 * 4) * MAX_PLANES),
                ('order', ctypes.c_void_p), ('out', ctypes.c_void_p),
                ('n', ctypes.c_int32), ('planes', ctypes.c_int32)]


class PackArgs(ctypes.Structure):
    # run, skip0: the pack's optional device gates (csrc/cell_pack.cuh),
    # null unless a launch function sets them
    _fields_ = [('src', _PackSrc * MAX_SOURCES), ('n_src', ctypes.c_int32),
                ('dtype', ctypes.c_int32), ('run', ctypes.c_void_p),
                ('skip0', ctypes.c_void_p)]


def fill(args, packs, name, buf=None):
    """Fill the ``PackArgs`` ``args`` for ``packs`` on the card, checking
    their props (``name`` is for the messages), and allocate the copies
    in one buffer (or take ``buf``, of that size and dtype), in the order
    of ``packs``, each starting at a whole record (``args.src[k].out``
    points at copy k).  Returns the buffer,
    which must stay referenced until the launch is queued; ``args.n_src``
    stays 0 where no source has a particle, and then nothing is to be
    launched."""
    x = packs[0][0]['x']
    dev, fdt = x.device, x.dtype
    if fdt not in (torch.float32, torch.float64):
        raise ValueError('%s: dtype %s' % (name, fdt))
    if len(packs) > MAX_SOURCES:
        raise ValueError('%s: %d sources' % (name, len(packs)))
    sizes = [len(planes) * state['x'].shape[0] * 4
             for state, _, planes in packs]
    if buf is None:
        buf = torch.empty(sum(sizes), dtype=fdt, device=dev)
    elif buf.numel() != sum(sizes) or buf.dtype != fdt or \
            buf.device != dev:
        raise ValueError('%s: a buffer of %d %s values on %s for copies of '
                         '%d' % (name, buf.numel(), buf.dtype, buf.device,
                                 sum(sizes)))
    ptr, es = buf.data_ptr(), buf.element_size()
    for k, (state, order, planes) in enumerate(packs):
        sa = args.src[k]
        ns = state['x'].shape[0]
        if len(planes) > MAX_PLANES:
            raise ValueError('%s: %d record planes' % (name, len(planes)))
        for q, names in enumerate(planes):
            for c, p in enumerate(names):
                if p is None:
                    continue
                if isinstance(p, tuple):
                    prop, col = p
                    t = state[prop]
                    width = t.shape[1] if t.dim() == 2 else 0
                    if not 0 <= col < width:
                        raise ValueError('%s: s_%s has no column %d'
                                         % (name, prop, col))
                    sa.prop[q][c] = data_ptr(
                        t, ns, fdt, dev, 's_' + prop,
                        width=width) + col * t.element_size()
                    sa.stride[q][c] = width
                else:
                    sa.prop[q][c] = data_ptr(state[p], ns, fdt, dev, 's_' + p)
                    sa.stride[q][c] = 1
        sa.order = data_ptr(order, ns, torch.int32, dev, 'source order')
        sa.out = ptr
        sa.planes, sa.n = len(planes), ns
        ptr += sizes[k] * es
    args.n_src = len(packs) if sum(sizes) else 0
    args.dtype = 1 if fdt == torch.float64 else 0
    return buf


def copies(buf, packs):
    """The ``(planes, n, 4)`` copies of ``packs`` in ``fill``'s buffer."""
    out, off = [], 0
    for state, _, planes in packs:
        shape = (len(planes), state['x'].shape[0], 4)
        size = shape[0] * shape[1] * 4
        out.append(buf[off:off + size].view(shape))
        off += size
    return out


def pack(packs):
    """The packed copy of each ``(state, order, planes)``; same result as
    ``pack_reference``.  CPU tensors take the plain version; CUDA tensors
    launch ``csrc/cell_pack.cu`` once for all."""
    if not packs:
        return []
    dev = packs[0][0]['x'].device
    if dev.type == 'cpu':
        return pack_reference(packs)
    if dev.type != 'cuda':
        raise ValueError('cell_pack: no kernel for device %s' % dev)
    args = PackArgs()
    buf = fill(args, packs, 'cell_pack')
    if args.n_src:
        build.launch('cell_pack', args, dev)
        pack.launches += 1
    return copies(buf, packs)


#: kernel launches since the last reset (set to 0 to reset), by ``pack``
#: and by every pair call, whose launch function launches the pack first
pack.launches = 0
