"""The launch and gather probes: wrappers, launch counters and plain
versions.

``micro_launch`` is the counterpart of the Pallas probe in
``tools_dev/micro_launch.py`` (its ``kern`` and grid spec,
``micro_launch.py:29-44``): program ``a`` sums ``n_views`` views of
``(planes, tz, lanes)`` floats of ``src``, view ``v`` being block
``(a * 7 + v * 3) % n_blocks``, and keeps the first 8 lanes::

    out[a, 0, t, l] = sum_v sum_p src[(a*7 + v*3) % n_blocks, p, t, l]

``micro_engine`` is the counterpart of the Pallas mock of the compact
engine's grid spec in ``tools_dev/micro_engine.py`` (``:23-106``):
program ``a`` sums plane 0 of ``n_views`` neighbour views of each source
pack over its lanes, and writes the row sums to all 5 output planes::

    acc[t] = sum_si sum_(oy, ox) sum_l src[si, blk, 0, t, l]
    out[a, po, t, m] = acc[t]

with ``blk = inv[si][(clip(bi+ox)*ny + clip(bj+oy))*n_zt + bz]`` under
``dyn_maps`` and ``(a*7 + ox*3 + oy + si) % n_sblocks`` otherwise.  The
TPU tool's dest pack never reaches its output; these functions do not
take it.  Its ``scratch`` and ``when_gate`` flags only change how the
TPU writes the same function and have no counterpart here.

For CUDA tensors each wrapper launches its kernel (``csrc/micro_launch.cu``,
``csrc/micro_engine.cu``, built on first use by ``ops/build.py``) on the
current stream, so a CUDA graph can capture it, and counts the launch in
``<wrapper>.launches`` (at capture, not at replay); for CPU tensors it
calls the plain version.
"""

import ctypes

import numpy as np
import torch

from pysph_tpu_torch.ops import build

#: neighbour views (oy, ox), oy major, as ``micro_engine.py:42``
OFFSETS = tuple((oy, ox) for oy in (-1, 0, 1) for ox in (-1, 0, 1))
OUT_LANES = 8      # lanes of a micro_launch output row
OUT_PLANES = 5     # planes of a micro_engine output block
#: the compact engine's block grid at dam_break_3d dx=0.02
#: (``micro_engine.py:25, 32, 40``): B blocks, nx * ny * n_zt = B
B, NX, NY, N_ZT = 4416, 64, 23, 3


def _check_src(src, dim, what):
    if src.dtype != torch.float32 or src.dim() != dim or \
            not src.is_contiguous():
        raise ValueError('%s must be a contiguous %d-d float32 tensor, got '
                         '%s %s' % (what, dim, tuple(src.shape), src.dtype))


def _launch_check(src, n_programs, n_views):
    _check_src(src, 4, 'micro_launch src')
    tz, lanes = src.shape[2], src.shape[3]
    if n_programs < 0 or n_views < 0 or lanes < OUT_LANES or \
            tz * OUT_LANES > 1024 or src.shape[0] < 1:
        raise ValueError('micro_launch: %d programs, %d views, src %s'
                         % (n_programs, n_views, tuple(src.shape)))


def launch_map(n_programs, n_views, n_blocks, device=None):
    """(n_programs, n_views) int64: the block of each program's views."""
    a = torch.arange(n_programs, device=device)[:, None]
    v = torch.arange(n_views, device=device)[None, :]
    return (a * 7 + v * 3) % n_blocks


def micro_launch_reference(src, n_programs, n_views):
    """Plain torch version of ``micro_launch``."""
    _launch_check(src, n_programs, n_views)
    idx = launch_map(n_programs, n_views, src.shape[0], src.device)
    rows = src[..., :OUT_LANES][idx]   # (programs, views, planes, tz, 8)
    return rows.sum(dim=(1, 2)).unsqueeze(1)


class _LaunchArgs(ctypes.Structure):
    _fields_ = [('src', ctypes.c_void_p), ('out', ctypes.c_void_p)] + \
        [(k, ctypes.c_int32) for k in ('n_programs', 'n_views', 'planes',
                                       'tz', 'lanes', 'n_blocks')]


def micro_launch(src, n_programs, n_views):
    """``(n_programs, 1, tz, 8)`` view sums of ``src`` (``(n_blocks,
    planes, tz, lanes)`` float32).  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if src.device.type == 'cpu':
        return micro_launch_reference(src, n_programs, n_views)
    if src.device.type != 'cuda':
        raise ValueError('micro_launch: no kernel for device %s'
                         % src.device)
    _launch_check(src, n_programs, n_views)
    n_blocks, planes, tz, lanes = src.shape
    out = torch.empty((n_programs, 1, tz, OUT_LANES), dtype=src.dtype,
                      device=src.device)
    args = _LaunchArgs(src.data_ptr(), out.data_ptr(), n_programs, n_views,
                       planes, tz, lanes, n_blocks)
    if n_programs:
        build.launch('micro_launch', args, src.device)
        micro_launch.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to reset)
micro_launch.launches = 0


def engine_maps(a_max, n_src, n_sblocks, b=B, ny=NY, n_zt=N_ZT, seed=0):
    """The tool's scalar-prefetch maps, from the same seeded numpy draws
    (``micro_engine.py:30-39``): ``(bi, bj, bz, inv)`` as int32 numpy
    arrays, ``inv`` of shape ``(n_src, b)`` with values in
    ``[0, n_sblocks]``."""
    rng = np.random.RandomState(seed)
    ids = rng.permutation(b)[:a_max].astype(np.int32)
    bi = ids // (ny * n_zt)
    bj = (ids // n_zt) % ny
    bz = ids % n_zt
    inv = np.stack([rng.randint(0, n_sblocks + 1, b).astype(np.int32)
                    for _ in range(n_src)])
    return bi, bj, bz, inv


def _engine_check(src, bi, bj, bz, inv, n_views, nx, ny, n_zt):
    _check_src(src, 5, 'micro_engine src')
    a_max, (n_src, b) = bi.shape[0], inv.shape
    if not (1 <= n_views <= len(OFFSETS) and 1 <= n_src == src.shape[0] and
            bi.shape == bj.shape == bz.shape and src.shape[1] >= 2):
        raise ValueError('micro_engine: %d views, src %s, maps %s %s'
                         % (n_views, tuple(src.shape), tuple(bi.shape),
                            tuple(inv.shape)))
    # a clipped cell index reaches nx * ny * n_zt - 1: inv must hold it
    if nx * ny * n_zt > b:
        raise ValueError('micro_engine: nx * ny * n_zt = %d cells, but inv '
                         'maps %d' % (nx * ny * n_zt, b))
    return a_max, n_src, b


def engine_cells(bi, bj, bz, n_views=9, nx=NX, ny=NY, n_zt=N_ZT):
    """(a_max, n_views) int64: the clipped cell index of each view,
    which ``inv`` maps to a source block under ``dyn_maps``."""
    bi, bj, bz = bi.long(), bj.long(), bz.long()
    return torch.stack([((bi + ox).clamp(0, nx - 1) * ny +
                         (bj + oy).clamp(0, ny - 1)) * n_zt + bz
                        for oy, ox in OFFSETS[:n_views]], dim=1)


def engine_blocks(bi, bj, bz, inv, n_sblocks, n_views=9, dyn_maps=True,
                  nx=NX, ny=NY, n_zt=N_ZT):
    """(n_src, a_max, n_views) int64: the source block of each view."""
    if dyn_maps:
        return inv.long()[:, engine_cells(bi, bj, bz, n_views, nx, ny,
                                          n_zt)]
    a = torch.arange(bi.shape[0], device=bi.device)[:, None]
    off = torch.tensor([ox * 3 + oy for oy, ox in OFFSETS[:n_views]],
                       device=bi.device)
    si = torch.arange(inv.shape[0], device=bi.device)[:, None, None]
    return (a * 7 + off + si) % n_sblocks


def micro_engine_reference(src, bi, bj, bz, inv, n_views=9, dyn_maps=True,
                           md=32, nx=NX, ny=NY, n_zt=N_ZT):
    """Plain torch version of ``micro_engine``."""
    a_max, n_src, _ = _engine_check(src, bi, bj, bz, inv, n_views, nx, ny,
                                    n_zt)
    n_sblocks = src.shape[1] - 1
    blocks = engine_blocks(bi, bj, bz, inv, n_sblocks, n_views, dyn_maps,
                           nx, ny, n_zt)
    tz = src.shape[3]
    acc = torch.zeros((a_max, tz), dtype=src.dtype, device=src.device)
    for si in range(n_src):
        plane0 = src[si, :, 0].sum(dim=-1)        # (n_sblocks + 1, tz)
        acc += plane0[blocks[si]].sum(dim=1)
    return acc[:, None, :, None].expand(a_max, OUT_PLANES, tz,
                                        md).contiguous()


class _EngineArgs(ctypes.Structure):
    _fields_ = [(p, ctypes.c_void_p) for p in
                ('src', 'bi', 'bj', 'bz', 'inv', 'out')] + \
        [(k, ctypes.c_int32) for k in (
            'a_max', 'n_src', 'n_sblocks', 'planes', 'tz', 'lanes', 'md',
            'n_views', 'dyn_maps', 'nx', 'ny', 'n_zt', 'b', 'pad')]


def micro_engine(src, bi, bj, bz, inv, n_views=9, dyn_maps=True, md=32,
                 nx=NX, ny=NY, n_zt=N_ZT):
    """``(a_max, 5, tz, md)`` per-program view sums of the source packs
    ``src`` (``(n_src, n_sblocks + 1, planes, tz, lanes)`` float32)
    through the int32 maps ``bi, bj, bz`` (``(a_max,)``) and ``inv``
    (``(n_src, B)``).  CPU tensors take the plain version; CUDA tensors
    launch the kernel.  The map values are trusted (no device read-back,
    so that a CUDA graph can capture the call): ``engine_maps`` makes
    them in range."""
    if src.device.type == 'cpu':
        return micro_engine_reference(src, bi, bj, bz, inv, n_views,
                                      dyn_maps, md, nx, ny, n_zt)
    if src.device.type != 'cuda':
        raise ValueError('micro_engine: no kernel for device %s'
                         % src.device)
    a_max, n_src, b = _engine_check(src, bi, bj, bz, inv, n_views, nx, ny,
                                    n_zt)
    dev = src.device
    ptrs = [build.data_ptr(t, a_max, torch.int32, dev, name)
            for t, name in ((bi, 'bi'), (bj, 'bj'), (bz, 'bz'))]
    if inv.dtype != torch.int32 or inv.device != dev or \
            not inv.is_contiguous():
        raise ValueError('micro_engine: inv must be a contiguous int32 '
                         'tensor on %s' % dev)
    _, n_sb1, planes, tz, lanes = src.shape
    out = torch.empty((a_max, OUT_PLANES, tz, md), dtype=src.dtype,
                      device=dev)
    args = _EngineArgs(src.data_ptr(), *ptrs, inv.data_ptr(),
                       out.data_ptr(), a_max, n_src, n_sb1 - 1, planes, tz,
                       lanes, md, n_views, int(bool(dyn_maps)), nx, ny,
                       n_zt, b, 0)
    if a_max:
        build.launch('micro_engine', args, dev)
        micro_engine.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to reset)
micro_engine.launches = 0
