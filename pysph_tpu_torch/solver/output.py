"""Simulation output: dump and load (port of
``pysph_tpu/solver/output.py``).

The file layouts and keys are those of the JAX package, so that each
package loads the other's files:

- npz ("version 2"): ``version``, ``particles`` ({array: {'name',
  'properties': {prop: {'name', 'type', 'default', 'stride', 'data'}},
  'constants', 'output_property_arrays', 'arrays': {prop: ndarray}}})
  and ``solver_data`` ({'dt', 't', 'count'}), pickled object arrays;
- hdf5, when ``h5py`` imports: groups ``solver_data`` (attributes) and
  ``particles/<array>/{arrays,constants}``.

A dump reads the host ``ParticleArray``s; the solver copies the device
state to them first, so a dump is a sync point.
"""

import os

import numpy

from pysph_tpu_torch.base.particle_array import ParticleArray

output_formats = ('hdf5', 'npz')


def _has_h5py():
    try:
        import h5py  # noqa: F401
        return True
    except ImportError:
        return False


def get_particles_info(particles):
    """The metadata dict of the particle arrays (names, property
    metadata, constants, output arrays)."""
    info = {}
    for pa in particles:
        props = {}
        for name in pa.properties:
            props[name] = {
                'name': name,
                'type': pa._type.get(name, 'double'),
                'default': pa.default_values.get(name, 0),
                'stride': pa.stride.get(name, 1),
                'data': None,
            }
        info[pa.name] = {
            'name': pa.name,
            'properties': props,
            'constants': {k: numpy.asarray(v)
                          for k, v in pa.constants.items()},
            'output_property_arrays': list(pa.output_property_arrays),
        }
    return info


def get_property_arrays(pa, all=False, only_real=True):
    """Numpy data of the output properties (or of all properties)."""
    props = (list(pa.properties.keys()) if all or
             not pa.output_property_arrays else pa.output_property_arrays)
    n = pa.num_real_particles if only_real else pa.get_number_of_particles()
    out = {}
    for name in props:
        if name not in pa.properties:
            continue
        s = pa.stride.get(name, 1)
        out[name] = numpy.array(pa.properties[name][:n * s])
    return out


class Output(object):
    def __init__(self, detailed_output=False, only_real=True,
                 compress=False):
        self.detailed_output = detailed_output
        self.only_real = only_real
        self.compress = compress

    def dump(self, fname, particles, solver_data):
        self.particle_data = get_particles_info(particles)
        self.all_array_data = {
            pa.name: get_property_arrays(pa, all=self.detailed_output,
                                         only_real=self.only_real)
            for pa in particles}
        self.solver_data = dict(solver_data)
        self._dump(fname)

    def load(self, fname):
        return self._load(fname)


class NumpyOutput(Output):
    """The npz "version 2" layout."""

    def _dump(self, filename):
        save = numpy.savez_compressed if self.compress else numpy.savez
        for name, arrays in self.all_array_data.items():
            self.particle_data[name]['arrays'] = arrays
        save(filename, version=2, particles=self.particle_data,
             solver_data=self.solver_data)

    def _load(self, fname):
        data = numpy.load(fname, allow_pickle=True)
        if 'version' not in data.files:
            raise RuntimeError('Wrong file type! No version number recorded.')
        version = int(data['version'])
        if version != 2:
            raise RuntimeError('Unsupported output version %r' % version)
        ret = {'arrays': {}}
        ret['solver_data'] = data['solver_data'].reshape(1)[0]
        particles = data['particles'].reshape(1)[0]
        for array_name, array_info in particles.items():
            props = array_info['properties']
            arrays = array_info['arrays']
            ret['arrays'][array_name] = _make_array(
                array_name,
                [(prop, meta.get('type', 'double'), meta.get('default', 0),
                  meta.get('stride', 1), arrays.get(prop))
                 for prop, meta in props.items()],
                array_info.get('constants', {}),
                array_info.get('output_property_arrays', []))
        return ret


class HDFOutput(Output):
    """The hdf5 layout."""

    def _dump(self, filename):
        import h5py
        with h5py.File(filename, 'w') as f:
            sgrp = f.create_group('solver_data')
            for k, v in self.solver_data.items():
                sgrp.attrs[k] = v
            pgrp = f.create_group('particles')
            for name, info in self.particle_data.items():
                agrp = pgrp.create_group(name)
                agrp.attrs['output_property_arrays'] = [
                    numpy.bytes_(s) for s in info['output_property_arrays']]
                cgrp = agrp.create_group('constants')
                for cname, cval in info['constants'].items():
                    cgrp.create_dataset(cname, data=cval)
                dgrp = agrp.create_group('arrays')
                arrays = self.all_array_data[name]
                for prop, meta in info['properties'].items():
                    if prop in arrays:
                        ds = dgrp.create_dataset(prop, data=arrays[prop])
                    else:
                        ds = dgrp.create_dataset(prop, data=[])
                        ds.attrs['stored'] = False
                    for mk, mv in meta.items():
                        if mv is not None and mk != 'data':
                            ds.attrs[mk] = mv

    def _load(self, fname):
        import h5py
        ret = {'arrays': {}}
        with h5py.File(fname, 'r') as f:
            ret['solver_data'] = dict(f['solver_data'].attrs)
            for name, agrp in f['particles'].items():
                props = [(prop, ds.attrs.get('type', 'double'),
                          ds.attrs.get('default', 0),
                          int(ds.attrs.get('stride', 1)),
                          numpy.asarray(ds) if len(ds) else None)
                         for prop, ds in agrp['arrays'].items()]
                ret['arrays'][name] = _make_array(
                    name, props,
                    {c: numpy.asarray(ds)
                     for c, ds in agrp['constants'].items()},
                    [s.decode() if isinstance(s, bytes) else str(s) for s
                     in agrp.attrs.get('output_property_arrays', [])])
        return ret


def _make_array(name, props, constants, output_arrays):
    """A ``ParticleArray`` from loaded ``(prop, type, default, stride,
    data or None)`` entries: the particle count is the longest stored
    property's, and a property that was not stored gets its default."""
    pa = ParticleArray(name=name)
    n = max((len(data) // stride for _p, _t, _d, stride, data in props
             if data is not None), default=0)
    for prop, type_, default, stride, data in props:
        pa.add_property(prop, type=str(type_), default=default, data=data,
                        stride=stride, _n=n)
    for cname, cval in constants.items():
        pa.add_constant(cname, cval)
    pa.set_output_arrays(list(output_arrays))
    return pa


def dump(filename, particles, solver_data, detailed_output=False,
         only_real=True, compress=False):
    """Dump the particles and the solver's ``solver_data``; the extension
    picks the format (hdf5 if ``h5py`` imports, else npz, where none is
    given).  Returns the file name written."""
    if filename.endswith(output_formats):
        fname = os.path.splitext(filename)[0]
        ext = os.path.splitext(filename)[1][1:]
    else:
        fname = filename
        ext = 'hdf5' if _has_h5py() else 'npz'
    if ext == 'hdf5' and _has_h5py():
        output = HDFOutput(detailed_output, only_real, compress)
    else:
        ext = 'npz'
        output = NumpyOutput(detailed_output, only_real, compress)
    filename = fname + '.' + ext
    output.dump(filename, particles, solver_data)
    return filename


def load(fname):
    """Load a dump: {'arrays': {name: ParticleArray}, 'solver_data':
    dict}."""
    if fname.endswith('npz'):
        output = NumpyOutput()
    elif fname.endswith('hdf5'):
        output = HDFOutput()
    else:
        raise RuntimeError('Unknown file format %r' % fname)
    if not os.path.isfile(fname):
        raise RuntimeError('File %s not present' % fname)
    return output.load(fname)
