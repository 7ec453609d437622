"""ParticleArray state carried across from pysph_tpu and back."""

import numpy as np
import torch

from pysph_tpu.base.utils import get_particle_array_wcsph as jax_wcsph
from pysph_tpu_torch.base.particle_array import ParticleArray
from pysph_tpu_torch.base.utils import get_particle_array_wcsph
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.tools_dev.testing import one_torch_thread  # noqa: F401


def _jax_array():
    rng = np.random.default_rng(2)
    n = 37
    pa = jax_wcsph(name='fluid', x=rng.uniform(size=n),
                   y=rng.uniform(size=n), z=rng.uniform(size=n),
                   u=rng.normal(size=n), rho=1000.0 + rng.normal(size=n),
                   h=np.full(n, 0.026), m=np.full(n, 8e-3))
    pa.tag[::5] = 2
    pa.add_constant('lb_weight', 0.1)
    return pa


def test_from_numpy_to_numpy_round_trip():
    ref = _jax_array()
    props = {k: v.copy() for k, v in ref.properties.items()}
    consts = {k: v.copy() for k, v in ref.constants.items()}
    pa = ParticleArray.from_numpy('fluid', props, consts)
    assert pa.name == 'fluid'
    assert pa.get_number_of_particles() == 37
    got_props, got_consts = pa.to_numpy()
    assert list(got_props) == list(props)
    for k, v in props.items():
        assert got_props[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got_props[k], v, err_msg=k)
    for k, v in consts.items():
        np.testing.assert_array_equal(got_consts[k], v, err_msg=k)


def test_device_state_round_trip_and_factory():
    ref = _jax_array()
    pa = ParticleArray.from_numpy('fluid', dict(ref.properties),
                                  dict(ref.constants))
    state = pa.to_device(Config(device='cpu', dtype=torch.float64))
    assert state['x'].dtype == torch.float64
    assert state['tag'].dtype == torch.int32
    assert state['x'].shape == (37,)
    state['rho'] = state['rho'] + 1.0
    pa.update_from_device(state)
    np.testing.assert_array_equal(pa.rho, ref.rho + 1.0)
    np.testing.assert_array_equal(pa.tag, ref.tag)
    # the port's factory makes the same property set as the JAX one
    mine = get_particle_array_wcsph(name='junk', x=[0.0, 1.0])
    theirs = jax_wcsph(name='junk', x=[0.0, 1.0])
    assert sorted(mine.properties) == sorted(theirs.properties)
    assert mine.output_property_arrays == theirs.output_property_arrays
