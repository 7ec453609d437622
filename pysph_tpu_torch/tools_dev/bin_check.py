"""The binning kernels against their plain version, and their times.

``check(grid, states)`` holds ``ops/bin_cells.py::bin_cells`` (the CUDA
kernels) to ``bin_cells_reference`` on the same inputs, exactly: two
handles of ``states`` on ``grid``, one for each, go through the same
calls and after each every tensor of the two handles must be equal bit
for bit, and the flags too:

1. a forced binning (flag 1);
2. the test on the same positions (kept: flag 0);
3. the particles moved by a seeded fraction of the margin and one of
   them past it (and wrapped into a periodic box, so that some jump by
   its length), tested with ``active`` 0 (flag 0): the handle must
   stay bitwise as it was;
4. the same, active (flag 1: rebuilt on the moved positions);
5. the test on those positions (kept).

``times(grid, states)`` gives the device time of a kept and of a rebuilt
binning replayed from a CUDA graph, each kernel's time in a rebuilt one
(``torch.profiler``), the plain version's time, and the work of each
(``tools_dev/roofline.py``).  Both run on the card only.
"""

import numpy as np
import torch

from pysph_tpu_torch.ops import bin_cells as bc
from pysph_tpu_torch.tools_dev import common, roofline

#: the flags of the calls of ``check``, in order
FLAGS = (True, False, False, True, False)


def _tensors(handle):
    out = [('origin', handle.origin), ('width', handle.width),
           ('overflow', handle.overflow), ('rebuild', handle.rebuild)]
    for name in handle.names:
        cl = handle.lists[name]
        out += [(name + '.' + k, getattr(cl, k)) for k in cl._fields]
        out.append((name + '.ref', handle.ref[name]))
    return out


def _moved(grid, states, seed):
    """``states`` with every particle moved by up to 0.3 of the margin
    and the first particle of the first array by 1.5 times it."""
    rng = np.random.default_rng(seed)
    hmax = max(float(s['h'].max()) for s in states.values()
               if s['h'].numel())
    margin = grid.half_margin() * hmax
    out = {}
    for name, s in states.items():
        s = dict(s)
        n = s['x'].shape[0]
        for d, c in enumerate('xyz'):
            if d >= grid.dim or n == 0:
                continue
            step = rng.uniform(-0.3, 0.3, n) * margin / np.sqrt(grid.dim)
            s[c] = s[c] + torch.as_tensor(step, dtype=s[c].dtype,
                                          device=s[c].device)
        out[name] = s
    first = next(name for name, s in out.items() if s['x'].shape[0])
    x = out[first]['x'].clone()
    x[0] = x[0] + 1.5 * margin
    out[first]['x'] = x
    if grid.is_periodic:
        # wrapped into the box: those that crossed it jump by a length
        out = {name: grid.domain.wrap_state(s) for name, s in out.items()}
    return out


def check(grid, states, seed=0, label=''):
    """Raises AssertionError where the kernels and the plain version
    differ; returns the number of calls compared."""
    kernel, plain = (grid.handle_for(None, states) for _ in range(2))
    moved = _moved(grid, states, seed)
    no = torch.zeros((), dtype=torch.bool, device=kernel.width.device)
    yes = torch.ones_like(no)
    calls = ((states, True, None), (states, False, None),
             (moved, False, no), (moved, False, yes), (moved, False, None))
    for k, ((st, force, active), flag) in enumerate(zip(calls, FLAGS)):
        before = [t.clone() for _, t in _tensors(kernel)]
        got = bc.bin_cells(grid, st, kernel, force, active)
        want = bc.bin_cells_reference(grid, st, plain, force, active)
        torch.cuda.synchronize()
        if bool(got) != flag or bool(want) != flag:
            raise AssertionError('%s call %d: flags %s (kernel), %s (plain), '
                                 'expected %s' % (label, k, bool(got),
                                                  bool(want), flag))
        for (name, a), (_, b) in zip(_tensors(kernel), _tensors(plain)):
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError('%s call %d: %s differs from the plain '
                                     'version' % (label, k, name))
        if not flag:
            for (name, a), b in zip(_tensors(kernel), before):
                if name != 'rebuild' and not torch.equal(a, b):
                    raise AssertionError('%s call %d: %s changed under the '
                                         'flag 0' % (label, k, name))
    return len(calls)


def times(grid, states, reps=20):
    """{kept_ms, rebuilt_ms, rebuilt_kernels, plain_ms, kept_work,
    rebuilt_work}: device milliseconds a call in a CUDA graph (the kept
    one's positions are the ones the rebuilt one binned), {kernel: ms} of
    a rebuilt call, the plain version's milliseconds eagerly."""
    handle = grid.handle_for(None, states)

    def rebuild():
        bc.bin_cells(grid, states, handle, force=True)
    rebuilt = common.graph_ms(rebuild, reps)
    kernels = common.graph_kernels_ms(rebuild, reps)
    kept = common.graph_ms(lambda: bc.bin_cells(grid, states, handle), reps)
    if bool(handle.rebuild):
        raise AssertionError('the test rebuilt a binning of unmoved '
                             'particles')
    plain = grid.handle_for(None, states)
    plain_ms = common.events_ms(lambda: bc.bin_cells_reference(
        grid, states, plain, force=True), reps)
    return dict(kept_ms=kept, rebuilt_ms=rebuilt, rebuilt_kernels=kernels,
                plain_ms=plain_ms,
                kept_work=roofline.bin_work(grid, states, False),
                rebuilt_work=roofline.bin_work(grid, states, True))
