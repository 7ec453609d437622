"""Every stage of every integrator step class of the port against the
same class of ``pysph_tpu`` (float64, on the CPU).

Each case is one (class, stage): the stage's ``d_*`` props are seeded
normal values (numpy ``default_rng``) on 17 particles, a seeded write
mask leaves some rows as they were, and both packages' binders run the
stage (``pysph_tpu``'s on jax arrays, the port's on torch tensors) with
the same ``t`` and ``dt``: every prop within 1e-14 of its max.  The
classes of schemes the port lacks yet (transport velocity, gas dynamics,
solid mechanics, rigid bodies, inlets) are held here stage by stage.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysph_tpu.base.kernels import CubicSpline as JaxCubicSpline
from pysph_tpu.sph import integrator_step as jax_steps
from pysph_tpu.sph.acceleration_eval import (
    ArraySchema, _bind_particle_phase as jax_bind)
from pysph_tpu_torch.base.kernels import CubicSpline
from pysph_tpu_torch.sph import integrator_step as steps
from pysph_tpu_torch.sph.acceleration_eval import _bind_particle_phase
from pysph_tpu_torch.sph.equation import _method_args

N = 17
T, DT = 0.2, 0.013
TOL = 1e-14
STAGES = ('initialize', 'stage1', 'stage2', 'stage3', 'stage4', 'stage5')


def _classes(module):
    return {name: cls for name, cls in vars(module).items()
            if inspect.isclass(cls) and issubclass(cls, module.IntegratorStep)
            and cls is not module.IntegratorStep}


CASES = [(name, stage) for name, cls in sorted(_classes(jax_steps).items())
         for stage in STAGES if hasattr(cls, stage)]


def test_every_class_is_ported():
    """The port has every step class of ``pysph_tpu``, with its stages
    and helper methods (16 classes)."""
    mine, theirs = _classes(steps), _classes(jax_steps)
    assert set(mine) == set(theirs) and len(mine) == 16
    for name, cls in theirs.items():
        own = {m for m in vars(cls) if not m.startswith('__')}
        assert own == {m for m in vars(mine[name])
                       if not m.startswith('__')}, name


def _inputs(props, seed):
    rng = np.random.default_rng(seed)
    values = {p: rng.normal(size=N) for p in props}
    mask = rng.random(N) < 0.8
    return values, mask


@pytest.mark.parametrize('name,stage', CASES)
def test_stage_matches_jax(name, stage):
    jax_fn = getattr(_classes(jax_steps)[name](), stage)
    fn = getattr(_classes(steps)[name](), stage)
    props = sorted(a[2:] for a in _method_args(jax_fn) if a.startswith('d_'))
    assert props == sorted(a[2:] for a in _method_args(fn)
                           if a.startswith('d_'))
    values, mask = _inputs(props, seed=CASES.index((name, stage)))
    jstore = {p: jnp.asarray(v) for p, v in values.items()}
    schema = ArraySchema(name='fluid', props=tuple(props), strides={},
                         consts=())
    jax_bind(jax_fn, jstore, schema, jnp.asarray(mask), T, DT,
             JaxCubicSpline(dim=2))
    store = {p: torch.as_tensor(v) for p, v in values.items()}
    _bind_particle_phase(fn, store, torch.as_tensor(mask), T, DT, (),
                         CubicSpline(dim=2))
    changed = 0
    for p in props:
        want = np.asarray(jstore[p])
        got = store[p].numpy()
        scale = max(np.abs(want).max(), np.finfo(float).tiny)
        err = np.abs(got - want).max() / scale
        assert err <= TOL, '%s.%s %s: scaled error %.3g' % (name, stage, p,
                                                            err)
        changed += not np.array_equal(want, values[p])
        # the masked rows stay as they were
        assert np.array_equal(got[~mask], values[p][~mask]), p
    assert changed or (name, stage) == ('OneStageRigidBodyStep', 'stage1')
