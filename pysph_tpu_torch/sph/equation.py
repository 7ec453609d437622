"""The pairwise equation DSL on torch tensors.

Port of ``pysph_tpu/sph/equation.py``; the contract is the same: an
``Equation(dest, sources)`` may define

- ``initialize(d_idx, d_*...)``                    -- per dest particle
- ``loop(d_idx, s_idx, d_*, s_*, precomputed...)`` -- per neighbour pair
- ``post_loop(d_idx, d_*...)``                     -- per dest particle

with arrays requested by name (``d_``/``s_`` prefixes) and the
precomputed pair symbols (HIJ, XIJ, VIJ, R2IJ, RIJ, RINV, WIJ, DWIJ,
...).  Methods run once, batched:

- in per-particle phases ``d_prop[d_idx]`` is the whole ``(n,)`` column
  and an assignment writes it back under the phase's write mask;
- in the pair phase the engine holds a compacted pair list ``(i, j)``:
  ``d_prop[d_idx]`` reads ``d_prop[i]`` and ``s_prop[s_idx]`` reads
  ``s_prop[j]``, one value per pair, and ``d_acc[d_idx] += expr`` becomes
  an ``index_add_`` of the per-pair increments into row ``i`` (into the
  write rows ``w`` of a list at a capacity, whose entries past the pair
  count go to a scratch row);
- a stride-``k`` property is an ``(n, k)`` tensor, and ``d_p[k*d_idx + c]``
  (``s_p[...]`` likewise) addresses its column ``c`` in both phases; in
  a per-particle phase ``d_p.whole()`` is the whole tensor and
  ``d_p.assign(value)`` writes all of it at once;
- ``if cond:`` on pair values becomes ``torch.where``; ``MAX`` marks
  max accumulation (``scatter_reduce`` with ``amax``).
"""

import inspect
from functools import lru_cache

import torch


class IndexSym(object):
    """The ``d_idx``/``s_idx`` sentinel, with the affine arithmetic of
    strided access: ``k*d_idx + c`` is column ``c`` of a stride-``k``
    property."""

    __slots__ = ('role', 'mul', 'off')

    def __init__(self, role, mul=1, off=0):
        self.role = role
        self.mul = mul
        self.off = off

    def __mul__(self, k):
        return IndexSym(self.role, self.mul * int(k), self.off * int(k))

    __rmul__ = __mul__

    def __add__(self, c):
        if isinstance(c, IndexSym):
            raise TypeError('cannot add two index symbols')
        return IndexSym(self.role, self.mul, self.off + int(c))

    __radd__ = __add__

    def __repr__(self):
        return 'IndexSym(%s, mul=%d, off=%d)' % (self.role, self.mul,
                                                 self.off)


def _check_index(key, name):
    if not isinstance(key, IndexSym):
        raise NotImplementedError(
            'indexing %r with %r: only d_idx/s_idx are ported yet (ROADMAP '
            'Queue 1 item 21, DSL breadth)' % (name, key))


def column(t, key, name):
    """The ``(n,)`` column of property tensor ``t`` that ``key``
    addresses: ``t`` itself for a ``(n,)`` property, ``t[:, off]`` for a
    ``(n, k)`` one indexed as ``k*d_idx + off``."""
    _check_index(key, name)
    stride = 1 if t.dim() == 1 else t.shape[1]
    if key.mul != stride or not 0 <= key.off < stride:
        raise IndexError('property %r has stride %d but was indexed as '
                         '%d*idx + %d' % (name, stride, key.mul, key.off))
    return t if stride == 1 else t[:, key.off]


def with_column(t, key, col):
    """``t`` with the column ``key`` addresses replaced by ``col`` (a new
    tensor: states may share their tensors)."""
    if t.dim() == 1:
        return col.contiguous()
    out = t.clone()
    out[:, key.off] = col
    return out


UNIT = IndexSym('dest')


class SymVec(object):
    """A mutable 3-component pair symbol (XIJ, VIJ, DWIJ)."""

    __slots__ = ('comps',)

    def __init__(self, comps):
        self.comps = list(comps)

    def __getitem__(self, i):
        return self.comps[i]

    def __setitem__(self, i, value):
        self.comps[i] = value


class _AccumMax(object):
    __slots__ = ('value',)

    def __init__(self, value):
        self.value = value


def _as_tensor_pair(a, b):
    ta, tb = torch.is_tensor(a), torch.is_tensor(b)
    # a Python number is filled on the device: no copy from the host,
    # which a CUDA graph's capture refuses
    if ta and not tb:
        b = torch.full_like(a, b)
    elif tb and not ta:
        a = torch.full_like(b, a)
    return a, b


def MAX(a, b):
    """DSL max: in a pair ``loop``, ``d_x[d_idx] = MAX(expr,
    d_x[d_idx])`` accumulates the maximum over neighbours."""
    a, b = _as_tensor_pair(a, b)
    return _AccumMax(torch.maximum(a, b))


class ArrayView(object):
    """Per-particle view over one property of a state dict; writes go
    back under ``write_mask`` (None = every row)."""

    __slots__ = ('store', 'name', 'write_mask')

    def __init__(self, store, name, write_mask=None):
        self.store = store
        self.name = name
        self.write_mask = write_mask

    def __getitem__(self, key):
        # a copy: ``d_x[d_idx] += v`` runs an in-place add on what this
        # returns before ``__setitem__`` applies the write mask
        return column(self.store[self.name], key, self.name).clone()

    def __setitem__(self, key, value):
        if isinstance(value, _AccumMax):
            value = value.value
        arr = self.store[self.name]
        col = column(arr, key, self.name)
        if torch.is_tensor(value):
            new = value.to(col.dtype).expand_as(col)
        else:   # a Python number: no host-to-device copy
            new = torch.full_like(col, value)
        if self.write_mask is not None:
            new = torch.where(self.write_mask, new, col)
        self.store[self.name] = with_column(arr, key, new)

    def whole(self):
        """The whole property: ``(n,)``, or ``(n, k)`` for stride ``k``
        (the tensor of the state; do not write into it)."""
        return self.store[self.name]

    def assign(self, value):
        """Write the whole property at once under the write mask:
        ``value`` a number or a tensor of the property's shape.  One new
        tensor, where writing each of ``k`` columns through
        ``with_column`` makes ``k`` (CRKSPH's stride-27 moments)."""
        arr = self.store[self.name]
        if torch.is_tensor(value):
            new = value.to(arr.dtype).expand_as(arr)
        else:
            new = torch.full_like(arr, value)
        if self.write_mask is not None:
            mask = self.write_mask if arr.dim() == 1 else \
                self.write_mask[:, None]
            new = torch.where(mask, new, arr)
        self.store[self.name] = new.contiguous()


class PairDestView(object):
    """Dest view in the pair phase: reads ``d[i]`` per pair; writes
    accumulate per pair into row ``i`` and are committed at once (under
    the write mask), so later reads see them, as in ``pysph_tpu``'s XLA
    engine."""

    __slots__ = ('ctx', 'name')

    def __init__(self, ctx, name):
        self.ctx = ctx
        self.name = name

    def __getitem__(self, key):
        # a copy, so that ``+=`` cannot change the cached pre-write read
        return self.ctx.dget(self.name, key).clone()

    def __setitem__(self, key, value):
        ctx = self.ctx
        col = column(ctx.dest[self.name], key, self.name)
        # the write rows; at a capacity, the entries past the pair count
        # write a scratch row past the dest's, which is dropped
        w = ctx.i if ctx.w is None else ctx.w
        if isinstance(value, _AccumMax):
            v = value.value.to(col.dtype).expand(w.shape)
            seg = col.new_full((col.shape[0] + 1,), -float('inf'))
            new = torch.maximum(col, seg.scatter_reduce_(0, w, v,
                                                         'amax')[:-1])
        else:
            v = torch.as_tensor(value, dtype=col.dtype, device=col.device)
            if v.shape != w.shape:
                raise NotImplementedError(
                    'write of shape %s to %r in a pair loop: only per-pair '
                    'accumulation is supported' % (tuple(v.shape),
                                                   self.name))
            new = torch.cat([col, col.new_zeros(1)]).index_add_(
                0, w, v - ctx.dget(self.name, key))[:-1]
        if ctx.write_mask is not None:
            new = torch.where(ctx.write_mask, new, col)
        ctx.commit(self.name, key, new)


class PairSrcView(object):
    """Source view in the pair phase: reads ``s[j]`` per pair."""

    __slots__ = ('ctx', 'name')

    def __init__(self, ctx, name):
        self.ctx = ctx
        self.name = name

    def __getitem__(self, key):
        return self.ctx.sget(self.name, key)

    def __setitem__(self, key, value):
        raise ValueError('equations may only write d_* arrays at d_idx '
                         '(attempted write to source %r)' % self.name)


def _method_args(method):
    return _cached_args(method.__func__ if hasattr(method, '__func__')
                        else method)


@lru_cache(maxsize=None)
def _cached_args(func):
    return tuple(p for p in inspect.signature(func).parameters
                 if p != 'self')


class Equation(object):
    """Base class of all equations."""

    def __init__(self, dest, sources=None, name=None):
        self.dest = dest
        if sources is not None and len(sources) == 0:
            sources = None
        self.sources = sources
        self.no_source = sources is None
        self.name = name if name is not None else self.__class__.__name__

    def __repr__(self):
        return '%s(dest=%r, sources=%r)' % (self.__class__.__name__,
                                            self.dest, self.sources)


class Group(object):
    """Ordered set of equations evaluated together.  With ``real`` the
    group writes only local particles (``tag == 0``).

    A group may hold sub-groups instead of equations (``has_subgroups``),
    and with ``iterate`` it runs its sub-tree again and again: at most
    ``max_iterations`` sweeps, stopping after a sweep once its equations'
    ``converged`` all say so and ``min_iterations`` sweeps have run (the
    evaluator's ``_run_iterated``).  With ``update_nnps`` the evaluator
    bins afresh after the group or, where it iterates, at the top of
    every sweep, as ``pysph_tpu``'s does (the grad-h density iteration
    changes h every sweep).  The other group features of ``pysph_tpu``
    (``condition``, ``pre``/``post``, ``start_idx``/``stop_idx``) are
    refused until they are ported."""

    def __init__(self, equations, real=True, update_nnps=False,
                 iterate=False, max_iterations=1, min_iterations=0,
                 **features):
        self.equations = list(equations)
        self.real = real
        self.update_nnps = bool(update_nnps)
        self.iterate = iterate
        self.max_iterations = max_iterations
        self.min_iterations = min_iterations
        self.has_subgroups = all(isinstance(e, Group) for e in
                                 self.equations) and len(self.equations) > 0
        used = sorted(k for k, v in features.items() if v)
        if used:
            raise NotImplementedError(
                'group features %s are not ported yet (ROADMAP Queue 1 '
                'item 21, DSL breadth)' % used)
        if not self.has_subgroups and any(isinstance(e, Group)
                                          for e in self.equations):
            raise NotImplementedError(
                'a group of equations and sub-groups together is not '
                'ported (ROADMAP Queue 1 item 21, DSL breadth)')

    def __repr__(self):
        return 'Group(n_eq=%d, real=%s, iterate=%s)' % (
            len(self.equations), self.real, self.iterate)

    def write_mask(self, state):
        """Rows the group may write: every particle of the (unpadded)
        state, and only local ones (``tag == 0``) when ``real``; None
        means every row."""
        if self.real:
            return state['tag'] == 0
        return None


class MultiStageEquations(object):
    """One list of groups per acceleration evaluator, for integrators
    that evaluate different equations at different stages (GTVF)."""

    def __init__(self, groups):
        self.groups = list(groups)

    def __len__(self):
        return len(self.groups)

    def __repr__(self):
        return 'MultiStageEquations(n_stages=%d)' % len(self.groups)


def get_arrays_used_in_equation(equation):
    """Names of the d_*/s_* properties an equation's methods request."""
    d_props, s_props = set(), set()
    for name in ('initialize', 'loop', 'post_loop'):
        method = getattr(equation, name, None)
        if method is None:
            continue
        for arg in _method_args(method):
            if arg in ('d_idx', 's_idx'):
                continue
            if arg.startswith('d_'):
                d_props.add(arg[2:])
            elif arg.startswith('s_'):
                s_props.add(arg[2:])
    return d_props, s_props
