"""Particle-array factories (port of ``pysph_tpu/base/utils.py``)."""

import numpy

from pysph_tpu_torch.base.particle_array import ParticleArray

DEFAULT_PROPS = set(
    ('x', 'y', 'z', 'u', 'v', 'w', 'm', 'h', 'rho', 'p',
     'au', 'av', 'aw', 'gid', 'pid', 'tag')
)


def get_particle_array(additional_props=None, constants=None, **props):
    """A particle array with the default SPH properties; keywords set
    property data and ``additional_props`` adds more."""
    name = props.pop('name', 'array')
    pa = ParticleArray(name=name, constants=constants)
    nparticles = 0
    for data in props.values():
        if data is not None:
            nparticles = max(nparticles, numpy.atleast_1d(
                numpy.asarray(data)).size)

    all_props = set(DEFAULT_PROPS)
    if additional_props:
        all_props = all_props.union(additional_props)
    all_props = all_props.union(props.keys())

    for prop in sorted(all_props):
        data = props.get(prop, None)
        if prop in ('tag', 'pid'):
            pa.add_property(prop, type='int', data=data, _n=nparticles)
        elif prop == 'gid':
            if data is None:
                data = numpy.arange(nparticles, dtype=numpy.uint32)
            pa.add_property(prop, type='unsigned int', data=data,
                            default=(1 << 32) - 1, _n=nparticles)
        else:
            pa.add_property(prop, data=data, _n=nparticles)
    pa.set_output_arrays(['x', 'y', 'z', 'u', 'v', 'w', 'rho', 'm', 'h',
                          'pid', 'gid', 'tag', 'p'])
    return pa


def get_particle_array_wcsph(constants=None, **props):
    """WCSPH particle array."""
    wcsph_props = ['cs', 'ax', 'ay', 'az', 'arho', 'x0', 'y0', 'z0',
                   'u0', 'v0', 'w0', 'rho0', 'div', 'dt_cfl', 'dt_force']
    return get_particle_array(
        constants=constants, additional_props=wcsph_props, **props)


def get_particle_array_tvf_fluid(constants=None, **props):
    """TVF fluid particle array."""
    tv_props = ['uhat', 'vhat', 'what',
                'auhat', 'avhat', 'awhat', 'vmag2', 'V']
    pa = get_particle_array(
        constants=constants, additional_props=tv_props, **props)
    pa.set_output_arrays(['x', 'y', 'z', 'u', 'v', 'w', 'rho', 'p', 'h',
                          'm', 'au', 'av', 'aw', 'V', 'vmag2', 'pid', 'gid',
                          'tag'])
    return pa


def get_particle_array_tvf_solid(constants=None, **props):
    """TVF solid particle array."""
    tv_props = ['u0', 'v0', 'w0', 'V', 'wij', 'ax', 'ay', 'az',
                'uf', 'vf', 'wf', 'ug', 'vg', 'wg']
    pa = get_particle_array(
        constants=constants, additional_props=tv_props, **props)
    pa.set_output_arrays(['x', 'y', 'z', 'u', 'v', 'w', 'rho', 'p', 'h',
                          'm', 'V', 'pid', 'gid', 'tag'])
    return pa


def get_particle_array_iisph(constants=None, **props):
    """IISPH particle array, with the constant ``tmp_comp`` (the pressure
    solve's compressed-particle count and compression sum, written by
    ``PressureSolve.reduce``)."""
    iisph_props = ['uadv', 'vadv', 'wadv', 'rho_adv',
                   'au', 'av', 'aw', 'ax', 'ay', 'az',
                   'dii0', 'dii1', 'dii2', 'V', 'dt_cfl', 'dt_force',
                   'aii', 'dijpj0', 'dijpj1', 'dijpj2', 'p', 'p0', 'piter',
                   'compression']
    consts = {'tmp_comp': [0.0, 0.0]}
    if constants:
        consts.update(constants)
    pa = get_particle_array(
        constants=consts, additional_props=iisph_props, **props)
    pa.set_output_arrays(['x', 'y', 'z', 'u', 'v', 'w', 'rho', 'h', 'm',
                          'p', 'pid', 'au', 'av', 'aw', 'tag', 'gid', 'V'])
    return pa


def get_particle_array_gasd(constants=None, **props):
    """Gas-dynamics particle array: the grad-h density iteration's
    ``h0``, ``dwdh``, ``omega`` and per-particle ``converged`` flag, the
    artificial viscosity and conduction switches ``alpha1`` and
    ``alpha2`` and their rates, and the CFL maximum ``dt_cfl``."""
    required_props = [
        'x', 'y', 'z', 'u', 'v', 'w', 'rho', 'h', 'm', 'cs', 'p', 'e',
        'au', 'av', 'aw', 'arho', 'ae', 'am', 'ah', 'x0', 'y0', 'z0',
        'u0', 'v0', 'w0', 'rho0', 'e0', 'h0', 'div', 'grhox', 'grhoy',
        'grhoz', 'dwdh', 'omega', 'converged', 'alpha1', 'alpha2', 'del2e',
        'aalpha1', 'aalpha2', 'alpha10', 'alpha20',
        'dt_cfl', 'dt_force']
    pa = get_particle_array(
        constants=constants, additional_props=required_props, **props)
    pa.set_output_arrays(['x', 'y', 'z', 'u', 'v', 'w', 'rho', 'p', 'e',
                          'au', 'av', 'ae', 'pid', 'gid', 'tag', 'h',
                          'alpha1', 'alpha2'])
    return pa
