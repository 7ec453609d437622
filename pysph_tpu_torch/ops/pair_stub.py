"""The pair kernel's walk without its arithmetic: wrapper, launch counter
and plain version.

``pair_stub`` is the port's counterpart of the zero-writing stubs that
``tools_dev/prof_dma.py`` and ``tools_dev/prof_phases.py`` swap in for
the engine's Pallas kernel: it takes ``wcsph_pair``'s arguments, makes
the loads of ``mode`` and writes 0 to every output of ``pre``:

- ``all``: ``wcsph_pair``'s walk (``csrc/cell_walk.cuh``: each lane
  walks its cells ``cx - 1 .. cx + 1`` in every stencil row of every
  source's packed copy) and its loads (the support test decides, as
  there, which pairs load the term mask's records);
- ``third``: the same walk over the lane's own cell ``cx`` only, one x
  offset of three;
- ``dest``: the dest's props only, no walk;
- ``none``: no loads, the stores only.

The plain version, ``pair_stub_reference``, returns the zeros and
launches nothing: it is also the tools' "skip" variant.

For CUDA tensors it calls ``csrc/pair_stub.cu`` (built on first use by
``ops/build.py``) once: in the modes that walk its launch function
launches the source pack first, as ``wcsph_pair``'s does (counted in
``cell_pack.pack.launches``); the stub's launch is counted in
``pair_stub.launches``.  For CPU tensors it calls the plain version.
"""

import ctypes

import torch

from pysph_tpu_torch.ops import build, cell_pack
from pysph_tpu_torch.ops.wcsph_pair import WcsphArgs, pair_args

#: in the order of the kernel's Mode enum
MODES = ('none', 'dest', 'third', 'all')


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError('pair_stub: mode %r is not one of %s'
                         % (mode, MODES))


def pair_stub_reference(dest, dest_cells, write_mask, pre, sources, grid,
                        kernel, mode='all'):
    """Plain torch version of ``pair_stub``: {output: zeros like pre}."""
    _check_mode(mode)
    return {p: torch.zeros_like(v) for p, v in pre.items()}


class StubArgs(ctypes.Structure):
    _fields_ = [('a', WcsphArgs), ('sink', ctypes.c_void_p),
                ('mode', ctypes.c_int32), ('write_sink', ctypes.c_int32)]


def pair_stub(dest, dest_cells, write_mask, pre, sources, grid, kernel,
              mode='all'):
    """Zeros for every output of ``pre``, after the loads of ``mode``;
    ``wcsph_pair``'s arguments.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    _check_mode(mode)
    dev = dest['x'].device
    if dev.type == 'cpu':
        return pair_stub_reference(dest, dest_cells, write_mask, pre,
                                   sources, grid, kernel, mode)
    if dev.type != 'cuda':
        raise ValueError('pair_stub: no kernel for device %s' % dev)
    walks = mode in ('third', 'all') and dest['x'].shape[0] > 0
    # the copies' buffer stays referenced until the launch is queued
    args, out, buf = pair_args('pair_stub', dest, dest_cells, write_mask,
                               pre, sources, grid, kernel, packed=walks)
    if args.n_dest == 0:
        return out
    build.launch('pair_stub', StubArgs(args, None, MODES.index(mode), 0),
                 dev)
    pair_stub.launches += 1
    cell_pack.pack.launches += bool(args.pack.n_src)
    return out


#: kernel launches since the last reset (set to 0 to reset)
pair_stub.launches = 0
