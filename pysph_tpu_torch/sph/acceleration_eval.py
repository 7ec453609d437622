"""Acceleration evaluator and the generic torch pair engine.

Port of ``pysph_tpu/sph/acceleration_eval.py``.  Groups run in order;
per group and dest array the phases run as in the reference:
``initialize`` -> source-less ``loop`` -> pair ``loop`` per source ->
``post_loop``.

Groups nest: a group of sub-groups runs them in order, and an iterated
group (``Group(iterate=True)``) runs its sub-tree in sweeps until its
equations' ``converged`` all hold and ``min_iterations`` sweeps ran, at
most ``max_iterations`` (``_run_iterated``).  Where the tree is IISPH's
pressure solve on ``iisph_pair`` (``ops/pair_engine.py::plan_solve``),
one ``iisph_solve`` call runs every sweep, the loop condition on the
device, and nothing is read back (its plain version on the CPU reads
``converged`` on the host); where it is ``GasDScheme``'s density
iteration on ``gasd_pair`` or ``TSPHScheme``'s on ``tsph_pair``
(``plan_sweep``), each sweep is one gated ``gasd_sweep`` or
``tsph_sweep`` launch after the reuse test of the evaluator's own
binning, a chunk's evaluation runs a fixed number of such slots with
nothing read, and the host loop outside chunks reads the count of
unconverged particles (``_run_swept``); any other iterated group sweeps
on the host, which reads ``converged`` once a sweep, one 0-d tensor, and
only where its answer can stop the loop.  ``converged_reads`` counts the host
loop's reads, ``sweeps`` the sweeps of each iterated group run.  After a
dest's ``post_loop`` an equation's ``reduce(dst, t, dt)`` runs on a
``ReduceView`` of the dest.

Pair phases take one of the engines, chosen once per (group, dest) when
the evaluator is built and recorded in ``engine_choices``:

- ``'kernel'`` or ``'dense'`` (the configured engine): the phase set
  matches one of that engine's hand-written pair kernels
  (``ops/pair_engine.py``), which then runs every source of the dest in
  one call;
- ``'torch'``: the generic engine below, for any equation.  From the
  sorted cell lists it builds compacted ``(i, j)`` pair lists
  chunked over dest rows (bounded memory), evaluates the equations'
  ``loop`` bodies on per-pair tensors and accumulates with
  ``index_add`` / ``scatter_reduce``.  Its lists are at capacities held
  on the host (``CellGrid.neighbor_pairs`` with a ``PairCapacity`` per
  (dest, source)), so it reads nothing back and a step on it captures
  into a CUDA graph; a list past its capacity sets the grid's
  ``pair_overflow`` flag and the evaluation is run again with grown
  capacities (``run_sized`` here, the solver's redo in the time loop).
  On exact lists (no capacity) it is also the plain version that the
  kernels are tested against.

An evaluation does not bin its start: ``compute`` takes a
``GridHandle`` (``base/cell_grid.py``) that ``prepare`` bins afresh and
``prepare_reuse`` keeps while its test holds (Verlet-style, as
``pysph_tpu``'s; the integrator calls them, once a step per evaluator by
default).  A group with ``update_nnps`` (the gas-dynamics schemes' h
updates) bins afresh after it, or at the top of each of its sweeps where
it iterates, into a handle of the evaluator's own for that group
(``_rebin_into``), which every later group of the evaluation reads; the
integrator's handle and its reuse test are left as they were; nothing is
read there (a position or h that is not finite is not binned and flags
the grid, which the solver reads).  Each such binning, and the step's,
is a ``Binning``: on a periodic grid where an equation writes h
(``CellGrid.keeps_width``) it has periodic counts of its own, sized for
the widest binning it met (``base/cell_grid.py``; ``run_sized`` and the
solver re-size them).  ``make_acceleration_evals`` builds one evaluator
per stage of a ``MultiStageEquations``, all on one ``CellGrid``.
"""

import logging
from collections import OrderedDict

import torch

from pysph_tpu_torch.ops.bin_cells import bin_cells
from pysph_tpu_torch.ops.sweeps import SweepLog, keep_sweeping
from pysph_tpu_torch.ops.pair_engine import (
    PairIneligible, SweepPlan, link_pairs, link_sweep, plan_pair_phases,
    plan_solve, plan_sweep)
from pysph_tpu_torch.sph.equation import (
    UNIT, ArrayView, Group, IndexSym, MultiStageEquations, PairDestView,
    PairSrcView, SymVec, _method_args, column, get_arrays_used_in_equation,
    with_column)

logger = logging.getLogger(__name__)

#: Dest rows per pair-list chunk: about 475 candidates per dest at the
#: dam break's density keep each chunk's pair tensors near 8M entries.
PAIR_CHUNK = 16384

_DSL_ITEM = 'ROADMAP Queue 1 item 21, DSL breadth'


class PairContext(object):
    """Precomputed pair symbols over one chunk's pair list ``(i, j)``.

    ``dest`` is the live dest state (writes are committed into it);
    ``src`` is the source state as it was when the source's phase
    began; ``w``: the write rows of a list at a capacity
    (``CellGrid.neighbor_pairs``), None for an exact list; ``grid``: the
    ``CellGrid`` of the lists, whose periodic axes give ``XIJ`` (and
    every symbol built from it) its minimum image."""

    SYMBOLS = ('HIJ', 'EPS', 'RHOIJ', 'RHOIJ1', 'XIJ', 'VIJ', 'R2IJ',
               'RIJ', 'RINV', 'WIJ', 'WI', 'WJ', 'DWIJ', 'DWI', 'DWJ',
               'GHI', 'GHJ', 'GHIJ', 'WDASHI', 'WDASHJ', 'WDASHIJ', 'WDP')

    def __init__(self, dest, src, i, j, kernel, write_mask, w=None,
                 grid=None):
        self.dest = dest
        self.src = src
        self.i = i
        self.j = j
        self.w = w
        self.grid = grid if grid is not None and grid.is_periodic else None
        self.kernel = kernel
        self.write_mask = write_mask
        self._d = {}
        self._s = {}
        self._sym = {}

    def dget(self, prop, key=UNIT):
        ck = (prop, key.off)
        if ck not in self._d:
            self._d[ck] = column(self.dest[prop], key, prop)[self.i]
        return self._d[ck]

    def sget(self, prop, key=UNIT):
        ck = (prop, key.off)
        if ck not in self._s:
            self._s[ck] = column(self.src[prop], key, prop)[self.j]
        return self._s[ck]

    def commit(self, prop, key, col):
        self.dest[prop] = with_column(self.dest[prop], key, col)
        self._d.pop((prop, key.off), None)

    def sym(self, name):
        if name not in self._sym:
            self._sym[name] = getattr(self, '_c_' + name.lower())()
        return self._sym[name]

    def _c_hij(self):
        return 0.5 * (self.dget('h') + self.sget('h'))

    def _c_eps(self):
        hij = self.sym('HIJ')
        return 0.01 * hij * hij

    def _c_rhoij(self):
        return 0.5 * (self.dget('rho') + self.sget('rho'))

    def _c_rhoij1(self):
        rhoij = self.sym('RHOIJ')
        return 1.0 / torch.where(rhoij != 0.0, rhoij, 1.0)

    def _c_xij(self):
        xij = [self.dget(c) - self.sget(c) for c in 'xyz']
        if self.grid is not None:
            xij = [self.grid.image(d, v) for d, v in enumerate(xij)]
        return SymVec(xij)

    def _c_vij(self):
        return SymVec([self.dget(c) - self.sget(c) for c in 'uvw'])

    def _c_r2ij(self):
        xij = self.sym('XIJ')
        return xij[0] ** 2 + xij[1] ** 2 + xij[2] ** 2

    def _c_rinv(self):
        r2 = self.sym('R2IJ')
        big = r2 > 1e-24
        return torch.where(big, torch.rsqrt(torch.where(big, r2, 1.0)),
                           0.0)

    def _c_rij(self):
        return self.sym('R2IJ') * self.sym('RINV')

    def _kparts(self, kind='ij'):
        """(h1, q, w, dw, fac) at the smoothing length of ``kind`` ('ij':
        HIJ, 'i': the dest's h, 'j': the source's): one reciprocal and
        one shape evaluation shared by the symbols of that h."""
        key = '_KP_' + kind
        if key not in self._sym:
            h = self.sym('HIJ') if kind == 'ij' else \
                self.dget('h') if kind == 'i' else self.sget('h')
            h1 = 1.0 / torch.where(h > 0.0, h, 1.0)
            q = self.sym('RIJ') * h1
            w, dw = self.kernel._shape(q)
            dim = self.kernel.dim
            fac = self.kernel.fac * (h1 if dim == 1 else h1 * h1
                                     if dim == 2 else h1 * h1 * h1)
            self._sym[key] = (h1, q, w, dw, fac)
        return self._sym[key]

    def _w(self, kind):
        _h1, _q, w, _dw, fac = self._kparts(kind)
        return w * fac

    def _grad(self, kind):
        h1, _q, _w, dw, fac = self._kparts(kind)
        xij = self.sym('XIJ')
        tmp = torch.where(self.sym('RIJ') > 1e-12,
                          dw * fac * h1 * self.sym('RINV'), 0.0)
        return SymVec([tmp * xij[0], tmp * xij[1], tmp * xij[2]])

    def _gradh(self, kind):
        h1, q, w, dw, fac = self._kparts(kind)
        return -fac * h1 * (dw * q + w * self.kernel.dim)

    def _wdash(self, kind):
        _h1, _q, _w, dw, fac = self._kparts(kind)
        return dw * fac

    def _c_wij(self):
        return self._w('ij')

    def _c_wi(self):
        return self._w('i')

    def _c_wj(self):
        return self._w('j')

    def _c_dwij(self):
        return self._grad('ij')

    def _c_dwi(self):
        return self._grad('i')

    def _c_dwj(self):
        return self._grad('j')

    def _c_ghij(self):
        return self._gradh('ij')

    def _c_ghi(self):
        return self._gradh('i')

    def _c_ghj(self):
        return self._gradh('j')

    def _c_wdashij(self):
        return self._wdash('ij')

    def _c_wdashi(self):
        return self._wdash('i')

    def _c_wdashj(self):
        return self._wdash('j')

    def _c_wdp(self):
        # W at rij = deltap HIJ: q = deltap, so only fac is per pair; w at
        # deltap is taken on the host in the working dtype (nothing is
        # copied to the card, so that a chunk's capture takes it)
        fac = self._kparts('ij')[4]
        w_dp, _ = self.kernel._shape(torch.tensor(self.kernel.get_deltap(),
                                                  dtype=fac.dtype))
        return fac * float(w_dp)


class _ReduceArray(object):
    """One prop or constant of a ``ReduceView``: ``[key]`` reads
    ``state[name][key]`` (a slice, an index), and an assignment writes a
    new tensor with ``[key]`` set, on the state's device (no host copy),
    unmasked."""

    __slots__ = ('store', 'name')

    def __init__(self, store, name):
        self.store = store
        self.name = name

    def __getitem__(self, key):
        return self.store[self.name][key]

    def __setitem__(self, key, value):
        # a new tensor: the solver's saved states share the old one
        t = self.store[self.name].clone()
        t[key] = value
        self.store[self.name] = t


class ReduceView(object):
    """The ``dst`` of ``reduce(dst, t, dt)`` and ``converged(dst)``: the
    dest's props and constants by attribute, read live from its state
    dict and written on the device (``_ReduceArray``); ``mask``: the
    group's write mask (None: every row), ``active``: every row."""

    def __init__(self, store, mask):
        object.__setattr__(self, '_store', store)
        object.__setattr__(self, 'mask', mask)
        object.__setattr__(self, 'active', torch.ones_like(
            store['x'], dtype=torch.bool))

    def __getattr__(self, name):
        store = object.__getattribute__(self, '_store')
        if name in store:
            return _ReduceArray(store, name)
        raise AttributeError(name)


def _bind_particle_phase(method, store, write_mask, t, dt, consts=(),
                         kernel=None):
    """Run a per-particle method batched over every row of ``store``."""
    kwargs = {}
    for arg in _method_args(method):
        if arg == 'd_idx':
            kwargs[arg] = IndexSym('dest')
        elif arg == 't':
            kwargs[arg] = t
        elif arg == 'dt':
            kwargs[arg] = dt
        elif arg == 'SPH_KERNEL':
            kwargs[arg] = kernel
        elif arg.startswith('d_'):
            prop = arg[2:]
            kwargs[arg] = ArrayView(
                store, prop, None if prop in consts else write_mask)
        else:
            raise ValueError('cannot bind argument %r of %r in a '
                             'per-particle phase' % (arg, method))
    method(**kwargs)


def _bind_pair_phase(method, ctx, t, dt):
    kwargs = {}
    for arg in _method_args(method):
        if arg == 'd_idx':
            kwargs[arg] = IndexSym('dest')
        elif arg == 's_idx':
            kwargs[arg] = IndexSym('src')
        elif arg == 't':
            kwargs[arg] = t
        elif arg == 'dt':
            kwargs[arg] = dt
        elif arg == 'SPH_KERNEL':
            kwargs[arg] = ctx.kernel
        elif arg in PairContext.SYMBOLS:
            kwargs[arg] = ctx.sym(arg)
        elif arg.startswith('d_'):
            kwargs[arg] = PairDestView(ctx, arg[2:])
        elif arg.startswith('s_'):
            kwargs[arg] = PairSrcView(ctx, arg[2:])
        else:
            raise NotImplementedError(
                'pair argument %r of %r is not ported yet (%s)'
                % (arg, method, _DSL_ITEM))
    method(**kwargs)


def run_pair_phase(eqs, dest, src, dest_cells, src_cells, grid, kernel,
                   write_mask, t, dt, chunk=PAIR_CHUNK, cap=None):
    """The torch pair engine: run the ``loop`` of every equation in
    ``eqs`` over all (dest, src) pairs in support, updating the ``dest``
    state dict in place; a chunk of ``chunk`` dest rows at a time, on
    lists at the capacities of ``cap`` (a ``PairCapacity``: nothing is
    read back) or, without, on exact lists (their sizes read back: the
    kernels' plain versions)."""
    src = dict(src)
    n = dest['x'].shape[0]
    for a in range(0, n, chunk):
        i, j, *w = grid.neighbor_pairs(dest, dest_cells, src, src_cells,
                                       (a, min(n, a + chunk)), cap)
        ctx = PairContext(dest, src, i, j, kernel, write_mask,
                          w[0] if w else None, grid)
        for eq in eqs:
            _bind_pair_phase(eq.loop, ctx, t, dt)


def _writes_h(eq):
    """Whether a phase of ``eq`` that runs on the dest alone takes
    ``d_h`` (``initialize``, ``post_loop``, a source-less ``loop``): one
    that may write h (a pair ``loop`` reads it)."""
    phases = ['initialize', 'post_loop'] + (['loop'] if eq.no_source else [])
    return any('d_h' in _method_args(getattr(eq, m))
               for m in phases if getattr(eq, m, None) is not None)


class Binning(object):
    """One binning that an evaluator keeps across evaluations: the
    step's (the integrator's handle, or ``update_and_compute``'s), or the
    re-binning after one ``update_nnps`` group (or at the top of each of
    its sweeps, or after an ``initialize`` that writes h), whose
    ``handle`` the evaluator holds.  ``cell``: the periodic cell width it
    is sized for (a host float; None: the grid's counts), read where the
    grid keeps widths (``CellGrid.keeps_width``); ``widest``: a 0-d
    float64 tensor on the device that each binning of it that ran raises
    to its width, cleared by the caller (None where no width is kept)."""

    def __init__(self, name):
        self.name = name
        self.cell = None
        self.handle = None
        self.widest = None

    def cells(self, grid):
        """The geometry it bins on (``CellGrid.cells_for``)."""
        return grid.cells_for(self.cell)

    def clear(self):
        if self.widest is not None:
            self.widest.zero_()


def sized_binnings(evals):
    """The ``Binning``s of the evaluators ``evals`` that keep a width."""
    return [b for a in evals for b in a.kept_binnings()
            if b.widest is not None]


def grow_binnings(grid, binnings, widths, where):
    """Size each of ``binnings`` whose widest binning (``widths``, host
    floats, in order) outgrew its periodic cells for that width; returns
    whether one did (what it evaluated must run again; ``grid.grows``
    counts once).  ``where`` names the run for the log."""
    grown = [(b, w) for b, w in zip(binnings, widths)
             if b.cells(grid).outgrown(w)]
    for b, w in grown:
        b.cell = w
    if grown:
        grid.grows += 1
        logger.info('%s: h grew past the periodic cells of %s; re-sized to '
                    '%s, run again', where, [b.name for b, _ in grown],
                    [b.cells(grid).dims for b, _ in grown])
    return bool(grown)


def shrink_binnings(grid, binnings, widths, where):
    """Size down each of ``binnings`` whose widest binning (``widths``)
    fits ``SHRINK`` of its periodic cells or less (about half), for that
    width (``grid.shrinks`` counts each)."""
    for b, w in zip(binnings, widths):
        if b.cells(grid).oversized(w):
            b.cell = w
            grid.shrinks += 1
            logger.info('%s: the binning %s fits about half its periodic '
                        'cells; re-sized to %s', where, b.name,
                        b.cells(grid).dims)


def run_sized(grid, states, run, evals=()):
    """Run ``run()``, an eager evaluation that writes ``states`` (a dict
    of state dicts, whose entries it replaces), again from the states as
    they were, with ``grid``'s pair capacities grown (and its
    ``nonfinite`` flag cleared), until no torch engine pair list
    overflowed: one read a run where a dest is on that engine, none
    else.  The first capacities are sized so.  Where the grid keeps
    widths (``CellGrid.keeps_width``) it also runs again where a binning
    of the evaluators ``evals`` outgrew its periodic cells, that binning
    sized for its width, and after the run sizes down a binning whose
    cells are twice its width or more (``grow_binnings``,
    ``shrink_binnings``; one read a run, with the pair flag)."""
    saved = {name: dict(st) for name, st in states.items()}
    while True:
        grid.watch_pairs()
        for b in sized_binnings(evals):
            b.clear()
        run()
        binnings = sized_binnings(evals)
        flag = grid.pair_overflow
        grid.pair_overflow = None
        if binnings:
            vals = torch.stack([b.widest for b in binnings] + (
                [] if flag is None else [flag.to(torch.float64)])).tolist()
            overflowed = flag is not None and bool(vals.pop())
            redo = grow_binnings(grid, binnings, vals, 'the evaluation')
        else:
            overflowed = flag is not None and bool(flag)
            redo = False
        if not (redo or overflowed):
            if binnings:
                shrink_binnings(grid, binnings, vals, 'the evaluation')
            return
        if overflowed:
            grown = grid.grow_pairs()
            logger.info('torch pair engine capacities grown: %s', grown)
        # what the dropped pairs gave is run again: a binning of it that
        # was not finite does not count
        if grid.nonfinite is not None:
            grid.nonfinite.zero_()
        for name, st in states.items():
            st.clear()
            st.update(saved[name])


def make_acceleration_evals(particle_arrays, equations, kernel, config,
                            grid):
    """One ``AccelerationEval`` per stage of ``MultiStageEquations``, or
    one for a plain list of groups."""
    stages = equations.groups if isinstance(
        equations, MultiStageEquations) else [equations]
    return [AccelerationEval(particle_arrays, eqs, kernel, config, grid)
            for eqs in stages]


class AccelerationEval(object):
    """Evaluates one list of Groups over the particle states."""

    def __init__(self, particle_arrays, equations, kernel, config, grid):
        self.kernel = kernel
        self.config = config
        self.grid = grid
        self.consts = {pa.name: set(pa.constants) for pa in particle_arrays}
        self._avail = {pa.name: set(pa.properties) | set(pa.constants)
                       for pa in particle_arrays}
        self.groups = self._make_groups(equations)
        self._validate()
        self.arrays_used = sorted(
            {eq.dest for eq in self._iter_equations()} |
            {s for eq in self._iter_equations() for s in eq.sources or ()})
        # {(dest, (srcs,)): 'kernel' | 'dense' | 'torch'}, filled while
        # planning
        self.engine_choices = {}
        #: run the iterated groups that have a ``SolvePlan`` through it
        #: (False: on the host, as the others; the tools' per-launch
        #: chain)
        self.solve_iterated = True
        self._sweeps = []
        self._sweep_log = None
        self._plans = self._plan()
        self.domain = grid.domain
        if any(_writes_h(eq) for eq in self._iter_equations()):
            grid.h_varies = True
        # the handle of update_and_compute
        self._handle = None
        #: {None (the step's) or id(group): Binning}, made at first use
        self._binnings = OrderedDict()
        #: {id(group): the Binning whose lists the group's pair phases
        #: read in the last evaluation}
        self.last_reads = {}
        #: the host loop's reads of ``converged``
        self.converged_reads = 0
        #: the calls of ``_rebin_into`` (the re-binnings of ``update_nnps``
        #: groups; a captured one counts once)
        self.binnings = 0
        #: the binnings of ``_rebin_into`` that ran (a 0-d float64 tensor on
        #: the device, None before the first; nothing read)
        self.rebuilds = None

    @staticmethod
    def _make_groups(equations):
        if isinstance(equations, Group):
            return [equations]
        groups, pending = [], []
        for item in equations:
            if isinstance(item, Group):
                if pending:
                    groups.append(Group(pending))
                    pending = []
                groups.append(item)
            else:
                pending.append(item)
        if pending:
            groups.append(Group(pending))
        return groups

    def leaf_groups(self, groups=None):
        """The groups that hold equations, in the order they run (a
        sweep of an iterated group once)."""
        for g in (self.groups if groups is None else groups):
            if g.has_subgroups:
                yield from self.leaf_groups(g.equations)
            else:
                yield g

    def _iter_equations(self, groups=None):
        for g in self.leaf_groups(groups):
            yield from g.equations

    def _iterated(self, groups=None):
        """The iterated groups of the tree, outermost first."""
        for g in (self.groups if groups is None else groups):
            if g.iterate:
                yield g
            if g.has_subgroups:
                yield from self._iterated(g.equations)

    @property
    def has_iterated(self):
        """Whether a group of the tree iterates."""
        return any(True for _ in self._iterated())

    @property
    def host_iterated(self):
        """Whether a group of the tree iterates on the host (no
        ``SolvePlan``, or ``solve_iterated`` off)."""
        return any(not (self.solve_iterated and id(g) in self._solves)
                   for g in self._iterated())

    @property
    def sweeps(self):
        """The sweeps of each iterated group run, in order (append-only:
        clear it to reset); reads the device's ``SweepLog`` of the
        ``iisph_solve`` runs since the last access (one read where there
        is one)."""
        if self._sweep_log is not None:
            self._sweeps.extend(self._sweep_log.drain())
        return self._sweeps

    def _validate(self):
        for eq in self._iter_equations():
            for m in ('initialize_pair', 'loop_all', 'py_initialize'):
                if getattr(eq, m, None) is not None:
                    raise NotImplementedError(
                        '%s.%s is not ported yet (%s)' % (
                            eq.name, m, _DSL_ITEM))
            d_props, s_props = get_arrays_used_in_equation(eq)
            missing = d_props - self._avail.get(eq.dest, set())
            if eq.dest not in self._avail or missing:
                raise RuntimeError('Destination %s missing properties %s '
                                   'required by %s' % (
                                       eq.dest, sorted(missing), eq.name))
            for src in eq.sources or ():
                smissing = s_props - self._avail.get(src, set())
                if src not in self._avail or smissing:
                    raise RuntimeError('Source %s missing properties %s '
                                       'required by %s' % (
                                           src, sorted(smissing), eq.name))

    @staticmethod
    def _dest_order(group):
        dests = OrderedDict()
        for eq in group.equations:
            if not isinstance(eq, Group):
                dests.setdefault(eq.dest, []).append(eq)
        return dests

    @staticmethod
    def _sources(eqs):
        sources = OrderedDict()
        for eq in eqs:
            for src in eq.sources or ():
                sources.setdefault(src, []).append(eq)
        return sources

    def _plan(self):
        plans = {}
        leaves = list(self.leaf_groups())
        for group in leaves:
            for dest, eqs in self._dest_order(group).items():
                sources = self._sources(eqs)
                if not sources:
                    continue
                key = (dest, tuple(sources))
                plan = None
                engine = self.config.engine
                if engine != 'torch':
                    try:
                        plan = plan_pair_phases(dest, sources, self.kernel,
                                                engine)
                    except PairIneligible as e:
                        logger.info('torch pair engine for %s <- %s: %s',
                                    dest, list(sources), e)
                self.engine_choices[key] = 'torch' if plan is None \
                    else engine
                plans[(id(group), dest)] = plan
                if plan is None:
                    for src in sources:
                        self.grid.pair_capacity(dest, src,
                                                self.config.device)
        link_pairs(leaves, plans)
        # {id(iterated group): SolvePlan or SweepPlan}
        self._solves = {}
        for group in self._iterated():
            try:
                self._solves[id(group)] = plan_solve(group, plans,
                                                     self.kernel)
                continue
            except PairIneligible as e:
                why = str(e)
            try:
                sweep = self._solves[id(group)] = plan_sweep(group, plans,
                                                             self.kernel)
                link_sweep(sweep, leaves, plans)
            except PairIneligible as e:
                logger.info('host loop for the iterated group %r: %s; %s',
                            group, why, e)
        if self._solves and self._sweep_log is None:
            self._sweep_log = SweepLog(self.config.device)
        return plans

    def set_domain(self, domain):
        """Take ``domain`` (a ``DomainManager``): its periodic axes reach
        the grid (``CellGrid.set_domain``: the counts, the wrapped cells
        and stencil, the minimum image of the lists and of ``XIJ``), and
        the pair phases are planned again for them."""
        self.domain = domain
        if self.grid.domain is not domain:
            self.grid.set_domain(domain)
        self.engine_choices = {}
        self._plans = self._plan()

    # -- binning -------------------------------------------------------
    def prepare(self, states, handle=None):
        """Bin the arrays of ``arrays_used`` afresh (port of
        ``pysph_tpu``'s ``prepare``), into ``handle`` where it fits the
        grid, else into a new one.  Returns (handle, rebuild flag)."""
        return self._bin(states, handle, force=True)

    def prepare_reuse(self, states, handle, active=None):
        """Verlet-list reuse (port of ``pysph_tpu``'s ``prepare_reuse``):
        keep the binning of ``handle`` while every particle has moved less
        than half the slack margin since it was binned and hmax has not
        grown past its width, else rebuild it in place; with ``active``
        (a 0-d device bool) rebuild only where it is set.  The test and
        the binning run on the states' device (``ops/bin_cells.py``) and
        nothing is read back.  Returns (handle, rebuild flag): a new
        handle where ``handle`` is None or no longer fits the grid, whose
        test always rebuilds (where active).  On a periodic grid the
        displacements are minimum images, as a wrap moves a coordinate by
        a box length."""
        return self._bin(states, handle, force=False, active=active)

    def binning(self, group=None):
        """The ``Binning`` of ``group``'s re-binning (None: the step's),
        made where missing."""
        key = None if group is None else id(group)
        b = self._binnings.get(key)
        if b is None:
            name = 'step' if group is None else 'group %d' % next(
                k for k, g in enumerate(self._all_groups()) if g is group)
            b = self._binnings[key] = Binning(name)
        return b

    def kept_binnings(self):
        """The ``Binning``s made so far, the step's first."""
        return list(self._binnings.values())

    def _all_groups(self, groups=None):
        for g in (self.groups if groups is None else groups):
            yield g
            if g.has_subgroups:
                yield from self._all_groups(g.equations)

    def _bin(self, states, handle, force, active=None, binning=None):
        sub = {n: states[n] for n in self.arrays_used}
        b = self.binning() if binning is None else binning
        grid = b.cells(self.grid)
        handle = b.handle = grid.handle_for(handle, sub)
        handle.binning = b
        flag = bin_cells(grid, sub, handle, force, active)
        # a kept binning reports no overflow
        self.grid.note_overflow(handle.overflow & flag)
        if self.grid.keeps_width:
            # h past the binning's periodic cells: the caller re-sizes
            # and redoes; far inside them: it sizes them down
            if b.widest is None:
                b.widest = torch.zeros((), dtype=torch.float64,
                                       device=flag.device)
            b.widest.copy_(torch.maximum(
                b.widest, torch.where(flag, handle.width, 0.0)
                .to(torch.float64)))
        return handle, flag

    # -- execution -----------------------------------------------------
    def update_and_compute(self, t, dt, states):
        """Bin afresh (into the evaluator's own handle), then evaluate:
        one evaluation as the reference's ``update_and_compute``, run
        again where a torch engine pair list overflowed (``run_sized``)."""
        def run():
            self._handle, _ = self.prepare(states, self._handle)
            self.compute(t, dt, states, self._handle)

        run_sized(self.grid, states, run, [self])
        return states

    def compute(self, t, dt, states, handle, active=None):
        """One evaluation on the binning of ``handle``; updates the
        per-array state dicts in place.  The torch engine's lists are at
        the grid's capacities: a caller that may meet an overflow keeps
        ``grid.pair_overflow`` (``run_sized``, the solver).  ``active``:
        the solver's chunk flag (a 0-d bool tensor), which an
        ``iisph_solve`` sweeps under (none where it is false).  A group
        with ``update_nnps`` bins afresh after it runs (at the top of
        each sweep where it iterates) into the evaluator's own handle,
        whose lists every later group of the evaluation reads
        (``_rebin_into``); ``handle`` is left as it was."""
        for group in self.groups:
            handle = self._dispatch(group, t, dt, states, handle, active)
        return states

    def _rebin_into(self, states, group, active=None, force=True):
        """Bin into the evaluator's own handle of ``group`` (its
        ``Binning``) and return the handle: afresh (``prepare``, as
        ``pysph_tpu``'s re-binning after an ``update_nnps`` group) or,
        without ``force``, where its reuse test fails; with ``active`` (a
        0-d device bool) only where it is set.  Nothing is read: a state
        that is not finite sets the grid's ``nonfinite`` flag
        (``ops/bin_cells.py``), a torch engine list of the run that
        dropped pairs its ``pair_overflow``, and the solver reads both.
        Counted in ``binnings`` (calls) and ``rebuilds`` (binnings that
        ran, on the device)."""
        b = self.binning(group)
        handle, flag = self._bin(states, b.handle, force, active, b)
        self.binnings += 1
        if self.rebuilds is None:
            self.rebuilds = torch.zeros((), dtype=torch.float64,
                                        device=flag.device)
        self.rebuilds.add_(flag)
        return handle

    def drop_own_binnings(self):
        """Forget the evaluator's own handles: the next re-binning of
        each group bins into a new one."""
        for b in self._binnings.values():
            b.handle = None

    def nnps_state(self):
        """A copy of the evaluator's own binnings (``_rebin_into``'s handles)
        and their count, for ``restore_nnps`` (the solver's redo)."""
        own = [(b, b.handle, None if b.handle is None else b.handle.save())
               for key, b in self._binnings.items() if key is not None]
        return (own, None if self.rebuilds is None
                else self.rebuilds.clone())

    def restore_nnps(self, saved):
        """Put back what ``nnps_state`` copied, in place."""
        own, rebuilds = saved
        for b, h, kept in own:
            b.handle = h
            if h is not None:
                h.restore(kept)
        if rebuilds is not None:
            self.rebuilds.copy_(rebuilds)

    def sweep_plans(self):
        """The ``SweepPlan`` of each iterated group that has one."""
        return [p for p in self._solves.values() if isinstance(p, SweepPlan)]

    def sweep_key(self):
        """The sweep slots of each ``SweepPlan`` (sized where not yet):
        what a captured chunk bakes in."""
        return tuple(p.sized() for p in self.sweep_plans())

    def _dispatch(self, group, t, dt, states, handle, active=None):
        """Run ``group`` on the binning of ``handle``; returns the handle
        whose lists the groups after it read."""
        if group.iterate:
            return self._run_iterated(group, t, dt, states, handle, active)
        handle = self._sweep(group, t, dt, states, handle, active)
        return self._rebin_into(states, group, active) \
            if group.update_nnps else handle

    def _sweep(self, group, t, dt, states, handle, active=None):
        """One pass of ``group``'s sub-tree (or its own equations); returns
        the handle after it (a sub-group may re-bin)."""
        if not group.has_subgroups:
            return self._run_group(group, t, dt, states, handle, active)
        for sub in group.equations:
            handle = self._dispatch(sub, t, dt, states, handle, active)
        return handle

    def _run_iterated(self, group, t, dt, states, handle, active=None):
        """Sweeps of ``group``'s sub-tree (or its own equations) while
        fewer than ``max_iterations`` ran and not (converged and at least
        ``min_iterations`` ran), as ``pysph_tpu``'s ``lax.while_loop``:
        by its ``SolvePlan`` where it has one (``iisph_solve``, its sweeps
        logged on the device), by its ``SweepPlan`` (``_run_swept``),
        else on the host, which reads ``converged`` (one ``.item()``) only
        after a sweep that has run ``min_iterations`` and not
        ``max_iterations``.  With ``update_nnps`` each sweep first bins
        afresh (``_rebin_into``), and the groups after it read the last sweep's
        binning.  Returns the handle of the groups after it."""
        plan = self._solves.get(id(group)) if self.solve_iterated else None
        if isinstance(plan, SweepPlan):
            return self._run_swept(plan, states, active)
        if plan is not None:
            plan.execute(states, handle.lists, handle.grid, dt, active,
                         self._sweep_log)
            return handle
        max_it = int(group.max_iterations)
        min_it = int(group.min_iterations)
        it = 0
        while it < max_it:
            if group.update_nnps:
                handle = self._rebin_into(states, group)
            handle = self._sweep(group, t, dt, states, handle)
            it += 1
            if it < min_it or it >= max_it:
                continue
            conv = self._converged(group, states)
            if conv is True:
                break
            self.converged_reads += 1
            if conv.item():
                break
        self.sweeps.append(it)
        return handle

    def _run_swept(self, plan, states, active=None):
        """The sweeps of a ``SweepPlan``'s group (its sweep op), each
        after the reuse test of the evaluator's own binning (positions do
        not move during the iteration, so it re-bins only where h grew
        past the cells; the pairs in support are those of a fresh
        binning), under the loop condition of ``_run_iterated``.  Outside
        a chunk (``active`` None) on the host: the count of unconverged
        particles read after a sweep that can stop the loop (counted in
        ``converged_reads``).  In a chunk, ``plan.slots`` sweeps, each
        gated on the card by ``active`` and the loop condition, nothing
        read; where an evaluation would sweep past its slots, the grid's
        ``sweep_overflow`` (where kept) is set, and the solver runs the
        chunk again with more slots.  Either way the sweeps are the same,
        bit for bit, and logged on the device; the linked plans read the
        last sweep's list where it left every particle converged.
        Returns the handle of the last sweep's binning."""
        min_it, max_it = plan.min_iterations, plan.max_iterations
        if active is None:
            it, conv = 0, False
            while keep_sweeping(it, conv, min_it, max_it):
                handle = self._rebin_into(states, plan.group, force=False)
                unconv = plan.sweep(states, handle.lists, handle.grid)
                it += 1
                if min_it <= it < max_it:
                    self.converged_reads += 1
                    conv = not int(unconv)
            if conv:
                plan.seen = max(plan.seen, it)
            converged = unconv == 0
        else:
            it = torch.zeros((), dtype=torch.int32, device=active.device)
            converged = torch.zeros_like(active)
            for _ in range(plan.sized()):
                runs = active & (it < max_it) & ~(converged & (it >= min_it))
                handle = self._rebin_into(states, plan.group, runs,
                                          force=False)
                unconv = plan.sweep(states, handle.lists, handle.grid, runs)
                converged = torch.where(runs, unconv == 0, converged)
                it = it + runs
            more = active & (it < max_it) & ~(converged & (it >= min_it))
            if self.grid.sweep_overflow is not None:
                self.grid.sweep_overflow = self.grid.sweep_overflow | more
        self._sweep_log.add(it, active)
        plan.hand_off(states, converged)
        return handle

    def _converged(self, group, states):
        """The AND of the ``converged`` of every equation of ``group``'s
        tree (``converged(dst)`` or ``converged()``; a value > 0 holds):
        a 0-d bool tensor, or True where no equation has one."""
        conv = True
        for eq in self._iter_equations([group]):
            fn = getattr(eq, 'converged', None)
            if fn is None:
                continue
            if 'dst' in _method_args(fn):
                val = fn(dst=ReduceView(states[eq.dest], None))
            else:
                val = fn()
            held = torch.as_tensor(val) > 0
            conv = held if conv is True else conv & held
        return conv

    def _run_group(self, group, t, dt, states, handle, active=None):
        """One pass of ``group``'s own equations on the binning of
        ``handle``; returns the handle after it.  Where a dest's
        ``initialize`` writes h (ADKE's density resets it to h0), the
        evaluator's own binning of the group runs its reuse test right
        after it (``_rebin_into``, rebuilt where h grew past the cells), so
        that the pair phases see every pair in support of the new h."""
        kernel = self.kernel
        for dest, eqs in self._dest_order(group).items():
            store = states[dest]
            consts = self.consts[dest]
            wm = group.write_mask(store)
            for eq in eqs:
                fn = getattr(eq, 'initialize', None)
                if fn is not None:
                    _bind_particle_phase(fn, store, wm, t, dt, consts, kernel)
            for eq in eqs:
                if eq.no_source and getattr(eq, 'loop', None) is not None:
                    _bind_particle_phase(eq.loop, store, wm, t, dt, consts,
                                         kernel)
            if any('d_h' in _method_args(eq.initialize) for eq in eqs
                   if getattr(eq, 'initialize', None) is not None):
                handle = self._rebin_into(states, group, active,
                                          force=False)
            sources = self._sources(eqs)
            if sources:
                self.last_reads[id(group)] = handle.binning
            cells, grid = handle.lists, handle.grid
            plan = self._plans.get((id(group), dest))
            if plan is not None:
                plan.execute(store, states, cells, grid, wm, dt, t=t)
            else:
                for src, src_eqs in sources.items():
                    run_pair_phase(
                        [eq for eq in src_eqs
                         if getattr(eq, 'loop', None) is not None],
                        store, states[src], cells[dest], cells[src],
                        grid, kernel, wm, t, dt,
                        cap=self.grid.pair_caps[dest, src])
            for eq in eqs:
                fn = getattr(eq, 'post_loop', None)
                if fn is not None:
                    _bind_particle_phase(fn, store, wm, t, dt, consts, kernel)
            for eq in eqs:
                fn = getattr(eq, 'reduce', None)
                if fn is not None:
                    fn(dst=ReduceView(store, wm), t=t, dt=dt)
        return handle
