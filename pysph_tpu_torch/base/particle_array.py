"""Particle arrays: the host container and its device state.

Port of ``pysph_tpu/base/particle_array.py``.  The host master copy is
plain numpy (setup/IO, never the hot path): a named collection of
per-particle properties and named constants.  Float properties are kept
in float64 on the host and cast to the run's dtype on the way to the
device.

A property may have a stride ``k`` (``add_property(name, stride=k)``,
recorded in ``pa.stride``): ``k`` values per particle, flat ``(n*k,)`` on
the host as in ``pysph_tpu``.

``to_device(config)`` gives the compute representation: a dict of
unpadded torch tensors, one per property and constant, on the run's
device; a stride-``k`` property is one ``(n, k)`` tensor, so that
``d_p[k*d_idx + c]`` is its column ``c``.  Unlike the JAX package there is
no padding to a capacity and no ``n_act``: every row of a tensor is a
particle.  ``update_from_device`` copies results back.

``from_numpy``/``to_numpy`` carry the same particles across from (and
back to) ``pysph_tpu`` as plain numpy, which is how the tests put one
state into both packages.
"""

from collections import OrderedDict

import numpy as np
import torch


_INT_TYPES = {'int': np.int32, 'long': np.int64, 'unsigned int': np.uint32}
_TORCH_INT = {np.dtype(np.int32): torch.int32,
              np.dtype(np.int64): torch.int64,
              # torch has no full uint32 arithmetic: widen
              np.dtype(np.uint32): torch.int64}


def _np_dtype(type_name):
    return _INT_TYPES.get(type_name, np.float64)


class ParticleArray(object):
    """A named set of per-particle properties and constants."""

    def __init__(self, name='', constants=None, **props):
        self.name = name
        self.properties = OrderedDict()
        self.stride = {}
        self._type = {}
        self.default_values = {}
        self.constants = OrderedDict()
        self.output_property_arrays = []

        nparticles = 0
        for data in props.values():
            if data is not None:
                nparticles = max(nparticles,
                                 np.atleast_1d(np.asarray(data)).size)
        for prop, data in props.items():
            if prop in ('tag', 'pid'):
                self.add_property(prop, type='int', data=data,
                                  _n=nparticles)
            elif prop == 'gid':
                self.add_property(prop, type='unsigned int', data=data,
                                  default=(1 << 32) - 1, _n=nparticles)
            else:
                self.add_property(prop, data=data, _n=nparticles)
        for name_, value in (constants or {}).items():
            self.add_constant(name_, value)

    # -- introspection -------------------------------------------------
    def get_number_of_particles(self):
        if not self.properties:
            return 0
        name, arr = next(iter(self.properties.items()))
        return arr.size // self.stride.get(name, 1)

    @property
    def num_real_particles(self):
        """Particles tagged local (``tag == 0``); all without a tag."""
        if 'tag' in self.properties:
            return int(np.sum(self.properties['tag'] == 0))
        return self.get_number_of_particles()

    # -- properties / constants ----------------------------------------
    def add_property(self, name, type='double', default=None, data=None,
                     stride=1, _n=None):
        dtype = _np_dtype(type)
        if default is None:
            default = 0
        n = self.get_number_of_particles() if _n is None else _n
        size = n * stride
        if data is None:
            arr = np.full(size, default, dtype=dtype)
        else:
            arr = np.atleast_1d(np.asarray(data)).astype(dtype).ravel()
            if arr.size == 1 and size > 1:
                arr = np.full(size, arr[0], dtype=dtype)
            elif arr.size < size:
                arr = np.concatenate(
                    [arr, np.full(size - arr.size, default, dtype=dtype)])
            else:
                arr = arr.copy()
        self.properties[name] = arr
        self.stride[name] = stride
        self._type[name] = type
        self.default_values[name] = default
        return self

    def remove_property(self, name):
        for d in (self.properties, self.stride, self._type,
                  self.default_values):
            d.pop(name, None)

    def add_constant(self, name, value):
        v = np.atleast_1d(np.asarray(value))
        if v.dtype.kind == 'f':
            v = v.astype(np.float64)
        self.constants[name] = v

    def set_output_arrays(self, props):
        self.output_property_arrays = list(props)

    def add_output_arrays(self, props):
        for p in props:
            if p not in self.output_property_arrays:
                self.output_property_arrays.append(p)

    # -- data access ---------------------------------------------------
    def set(self, **props):
        for name, data in props.items():
            arr = self.properties[name]
            data = np.asarray(data, dtype=arr.dtype).ravel()
            arr[:data.size] = data

    def __getattr__(self, name):
        props = self.__dict__.get('properties')
        if props is not None and name in props:
            return props[name]
        consts = self.__dict__.get('constants')
        if consts is not None and name in consts:
            return consts[name]
        raise AttributeError('%r object has no attribute %r' %
                             (self.__class__.__name__, name))

    def __setattr__(self, name, value):
        if 'properties' in self.__dict__ and name in self.properties:
            self.set(**{name: value})
        else:
            object.__setattr__(self, name, value)

    # -- carrying state across packages --------------------------------
    @classmethod
    def from_numpy(cls, name, props, constants=None, stride=None):
        """Build an array from ``{prop: flat ndarray}`` and ``{prop:
        stride}`` (ints keep their integer type, everything else becomes
        float64)."""
        pa = cls(name=name)
        stride = stride or {}
        n = max((np.asarray(v).size // stride.get(k, 1)
                 for k, v in props.items()), default=0)
        for prop, data in props.items():
            data = np.asarray(data)
            kind = data.dtype.kind
            if kind in 'iub':
                type_ = {np.dtype(np.int64): 'long',
                         np.dtype(np.uint32): 'unsigned int'}.get(
                             data.dtype, 'int')
            else:
                type_ = 'double'
            pa.add_property(prop, type=type_, data=data,
                            stride=stride.get(prop, 1), _n=n)
        for cname, value in (constants or {}).items():
            pa.add_constant(cname, value)
        return pa

    def to_numpy(self):
        """``(props, constants)`` as dicts of numpy copies (strided
        properties flat; ``stride`` gives their strides)."""
        return ({k: v.copy() for k, v in self.properties.items()},
                {k: v.copy() for k, v in self.constants.items()})

    # -- device state --------------------------------------------------
    def to_device(self, config):
        """Dict of tensors on ``config.device``: float properties and
        constants in ``config.dtype``, integer ones in int32/int64; a
        stride-k property as an ``(n, k)`` tensor."""
        state = {}
        for name, arr in list(self.properties.items()) + \
                list(self.constants.items()):
            if name in state:
                raise ValueError('constant %r shadows a property' % name)
            k = self.stride.get(name, 1) if name in self.properties else 1
            if k > 1:
                arr = arr.reshape(-1, k)
            if arr.dtype.kind == 'f':
                t = torch.as_tensor(arr, dtype=config.dtype)
            else:
                t = torch.as_tensor(arr.astype(np.int64)).to(
                    _TORCH_INT.get(arr.dtype, torch.int64))
            state[name] = t.to(config.device)
        return state

    def update_from_device(self, state):
        for name, t in state.items():
            host = t.detach().cpu().numpy().reshape(-1)
            if name in self.properties:
                self.properties[name][:] = host.astype(
                    self.properties[name].dtype)
            elif name in self.constants:
                self.constants[name] = host.astype(
                    self.constants[name].dtype)
