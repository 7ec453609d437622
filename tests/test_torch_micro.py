"""The port's launch and gather probes (``ops/micro.py``) against the
JAX tools' Pallas kernels, run with ``interpret=True`` on the CPU.

The tools build their kernels inside ``bench`` closures that cannot be
imported, and the tools stay as they are, so the kernels and grid specs
below are transcribed from ``tools_dev/micro_launch.py:29-44`` and
``tools_dev/micro_engine.py:45-106``.  Inputs are seeded normal floats
(under the tools' ``ones`` a wrong index map goes unseen).  Tolerance:
1e-6 of max|ref|, float32 sums taken in another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pysph_tpu_torch.ops import micro
from pysph_tpu_torch.tools_dev import micro_engine as tool_engine
from pysph_tpu_torch.tools_dev import micro_launch as tool_launch
from pysph_tpu_torch.tools_dev import roofline
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401

TOL = 1e-6


def _jax_micro_launch(src, n_programs, n_views):
    """micro_launch.py:27-44 and the call of :51-54, interpreted."""
    n_blocks, planes, tz, lanes = src.shape

    def imap(a, v=0):
        return ((a * 7 + v * 3) % n_blocks, 0, 0, 0)

    in_specs = [pl.BlockSpec((1, planes, tz, lanes),
                             functools.partial(imap, v=v))
                for v in range(n_views)]
    out_spec = pl.BlockSpec((1, 1, tz, 8), lambda a: (a, 0, 0, 0))
    out_shape = jax.ShapeDtypeStruct((n_programs, 1, tz, 8), jnp.float32)

    def kern(*refs):
        outr = refs[-1]
        acc = jnp.zeros((tz, 8), jnp.float32)
        for v in range(n_views):
            acc = acc + jnp.sum(refs[v][0], axis=0)[:, :8]
        outr[0, 0] = acc

    x = jnp.asarray(src)
    return np.asarray(pl.pallas_call(
        kern, grid=(n_programs,), in_specs=in_specs, out_specs=out_spec,
        out_shape=out_shape, interpret=True)(*([x] * n_views)))


def _jax_micro_engine(src, bi, bj, bz, inv, md, nx, ny, n_zt, dyn_maps=True,
                      n_views=9, scratch=True, when_gate=True, pd=1):
    """micro_engine.py:26-115 (one call of the kernel), interpreted;
    ``src`` is the stack of the tool's ``s_packs``."""
    n_src, n_sb1, pp, tz, lanes = src.shape
    n_sblocks = n_sb1 - 1
    a_max = bi.shape[0]
    fdt = jnp.float32
    d_pack = jnp.ones((a_max, 2 + pd, tz, md), fdt)
    s_packs = [jnp.asarray(src[si]) for si in range(n_src)]
    na = jnp.asarray([a_max], jnp.int32)
    invs = [jnp.asarray(inv[si]) for si in range(n_src)]
    offs = [(oy, ox) for oy in (-1, 0, 1) for ox in (-1, 0, 1)][:n_views]

    def smap(a, bi_, bj_, bz_, na_, *inv_, ox=0, oy=0, si=0):
        i2 = jnp.clip(bi_[a] + ox, 0, nx - 1)
        j2 = jnp.clip(bj_[a] + oy, 0, ny - 1)
        flat = (i2 * ny + j2) * n_zt + bz_[a]
        return (inv_[si][flat], 0, 0, 0)

    def smap_static(a, bi_, bj_, bz_, na_, *inv_, ox=0, oy=0, si=0):
        return ((a * 7 + ox * 3 + oy + si) % n_sblocks, 0, 0, 0)

    def dest_map(a, *r):
        return (a, 0, 0, 0)

    in_specs = [pl.BlockSpec((1, 2 + pd, tz, md), dest_map)]
    for si in range(n_src):
        for oy, ox in offs:
            in_specs.append(pl.BlockSpec(
                (1, pp, tz, lanes),
                functools.partial(smap if dyn_maps else smap_static,
                                  ox=ox, oy=oy, si=si)))
    po = 5
    out_spec = pl.BlockSpec((1, po, tz, md), dest_map)
    out_shape = jax.ShapeDtypeStruct((a_max, po, tz, md), fdt)

    def kern(*refs):
        it = iter(refs)
        next(it)
        next(it)
        next(it)
        na_r = next(it)
        for _ in range(n_src):
            next(it)
        next(it)
        s_refs = [next(it) for _ in range(n_src * len(offs))]
        out_ref = next(it)
        scr = [next(it) for _ in range(po)] if scratch else None
        valid = pl.program_id(0) < na_r[0]

        def _body():
            acc = jnp.zeros((tz, md), fdt)
            for r in s_refs:
                acc = acc + jnp.sum(r[0, 0], axis=-1, keepdims=True)
            if scratch:
                for k in range(po):
                    scr[k][...] = acc
                for k in range(po):
                    out_ref[0, k] = scr[k][...]
            else:
                for k in range(po):
                    out_ref[0, k] = acc

        if when_gate:
            pl.when(valid)(_body)
        else:
            _body()

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=4 + n_src, grid=(a_max,), in_specs=in_specs,
        out_specs=out_spec,
        scratch_shapes=[pltpu.VMEM((tz, md), fdt)
                        for _ in range(po)] if scratch else [])
    args = [jnp.asarray(bi), jnp.asarray(bj), jnp.asarray(bz), na, *invs,
            d_pack]
    for si in range(n_src):
        args += [s_packs[si]] * len(offs)
    return np.asarray(pl.pallas_call(kern, grid_spec=grid_spec,
                                     out_shape=out_shape,
                                     interpret=True)(*args))


def _check(got, ref):
    got = got.numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= TOL * np.abs(ref).max(), err


@pytest.mark.parametrize('n_programs,n_views,tz,lanes,planes,n_blocks', [
    (6, 1, 8, 128, 1, 16), (6, 3, 8, 16, 2, 16), (6, 9, 8, 24, 2, 5),
    (7, 4, 3, 8, 3, 11)])
def test_micro_launch_matches_the_pallas_probe(n_programs, n_views, tz,
                                               lanes, planes, n_blocks):
    src = tool_launch.make_src(tz, lanes, planes, 'cpu', n_blocks, seed=3)
    ref = _jax_micro_launch(src.numpy(), n_programs, n_views)
    _check(micro.micro_launch(src, n_programs, n_views), ref)
    _check(micro.micro_launch_reference(src, n_programs, n_views), ref)


def test_micro_launch_feedback_loop_and_work_on_the_cpu():
    """The tool's inner loop runs on a CPU tensor (the plain version), and
    its work counts the distinct blocks the views reach."""
    src = tool_launch.make_src(8, 16, 2, 'cpu', n_blocks=16)
    first = micro.micro_launch(src.clone(), 6, 3)
    out = tool_launch.feedback_loop(src, 6, 3, k=3)
    assert out.shape == (6, 1, 8, 8)
    assert float((out - first).abs().max()) < 1e-5
    blocks = {(a * 7 + v * 3) % 16 for a in range(6) for v in range(3)}
    work = roofline.micro_launch_work(src, 6, 3)
    assert work['bytes'] == (len(blocks) * 2 + 6) * 8 * 8 * 4
    assert work['flops'] == 6 * 3 * 2 * 8 * 8


# a reduced block grid: nx * ny * n_zt = B = 60
NX, NY, NZT, B = 4, 5, 3, 60


def _engine_inputs(a_max=6, n_src=2, n_sblocks=10, pp=2, tz=8, lanes=24,
                   seed=5):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(n_src, n_sblocks + 1, pp, tz, lanes)).astype(
        np.float32)
    maps = micro.engine_maps(a_max, n_src, n_sblocks, b=B, ny=NY, n_zt=NZT)
    return src, maps


@pytest.mark.parametrize('dyn_maps,n_views,scratch,when_gate', [
    (True, 9, True, True), (False, 9, True, True), (True, 3, True, True),
    (False, 3, True, True), (True, 9, False, False)])
def test_micro_engine_matches_the_pallas_mock(dyn_maps, n_views, scratch,
                                              when_gate):
    """Every flag of the tool; ``scratch`` and ``when_gate`` do not change
    the function."""
    md = 4
    src, maps = _engine_inputs()
    ref = _jax_micro_engine(src, *maps, md=md, nx=NX, ny=NY, n_zt=NZT,
                            dyn_maps=dyn_maps, n_views=n_views,
                            scratch=scratch, when_gate=when_gate)
    args = (torch.as_tensor(src), *(torch.as_tensor(m) for m in maps))
    kw = dict(n_views=n_views, dyn_maps=dyn_maps, md=md, nx=NX, ny=NY,
              n_zt=NZT)
    _check(micro.micro_engine(*args, **kw), ref)
    _check(micro.micro_engine_reference(*args, **kw), ref)


def test_micro_engine_maps_are_the_tools_draws_and_checked():
    """``engine_maps`` repeats the tool's seeded draws, and the wrapper
    refuses a block grid whose clipped cell index ``inv`` cannot hold."""
    rng = np.random.RandomState(0)
    ids = rng.permutation(micro.B)[:748]
    inv0 = rng.randint(0, 749, micro.B)
    bi, bj, bz, inv = micro.engine_maps(748, 3, 748)
    np.testing.assert_array_equal(bi, ids // (micro.NY * micro.N_ZT))
    np.testing.assert_array_equal(bj, (ids // micro.N_ZT) % micro.NY)
    np.testing.assert_array_equal(bz, ids % micro.N_ZT)
    np.testing.assert_array_equal(inv[0], inv0)
    assert micro.NX * micro.NY * micro.N_ZT == micro.B
    assert int(micro.engine_cells(*(torch.as_tensor(m) for m in
                                    (bi, bj, bz))).max()) < micro.B
    src, maps = _engine_inputs()
    args = (torch.as_tensor(src), *(torch.as_tensor(m) for m in maps))
    with pytest.raises(ValueError, match='nx \\* ny \\* n_zt'):
        micro.micro_engine(*args, nx=NX + 1, ny=NY, n_zt=NZT)


def test_micro_engine_tool_case_runs_on_the_cpu():
    """The tool's case ``fluid-1src`` and its loop on the CPU: the output
    is the plain version's, the dest pack only takes the feedback."""
    d_pack, args, kw = tool_engine.make_case('fluid-1src', 'cpu')
    before = d_pack.clone()
    out = tool_engine.feedback_loop(d_pack, args, kw, k=2)
    assert out.shape == (748, 5, 8, 32)
    torch.testing.assert_close(out, micro.micro_engine_reference(*args,
                                                                 **kw))
    shift = (d_pack - before).abs().max()
    assert float(shift) < 1e-6
    work = roofline.micro_engine_work(*args, **kw)
    assert work['flops'] == 748 * 9 * 8 * 96
