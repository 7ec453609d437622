"""Build the CUDA kernels of ``pysph_tpu_torch/csrc`` with nvcc, and
launch them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes a shared
library, loaded with ``ctypes``: ``<name>_launch(const Args*, stream)``
returns a CUDA error code, ``<name>_error_string(code)`` names it and
``<name>_args_size()`` gives ``sizeof(Args)``, which must match the
wrapper's ``ctypes.Structure``.  The build runs at first use, into
``build/`` at the repository root, keyed by a hash of the source, of the
``csrc/`` headers it includes and of the flags, so an edited source or
header is rebuilt and an unchanged one is not.  The
compiler's resource report (``-Xptxas -v``: registers, spills, shared
memory per kernel) is kept beside the library as ``.log``.

The pair kernels instantiate their templates once a smoothing-kernel
kind (``base/kernels.py::kernel_kind``, ``csrc/shapes.cuh``).  Their
default library holds the kinds below ``BASE_KINDS``; each later kind is
a library of its own, built with ``-DPAIR_KIND=<kind>`` at its first
launch (``launch`` reads the kind from the argument struct's
``kernel_kind``), so that a path that runs none of them builds what it
built before they came.

Needs the CUDA toolkit (``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``,
else ``nvcc`` on ``PATH``) and a Hopper card: the code is built for
``sm_90a`` only.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
#: flags of one source only: delta_pair's accept test must round every
#: operation as the plain torch version does, so no FMA contraction;
#: tvf_pair's linked momentum launch must sum as its walking launch does,
#: bit for bit, so ptxas contracts no multiply and add into an FMA (it
#: does so as its schedule allows, which differs between the two
#: launches: 1-74 dests a call differed in their last bits on the wall
#: examples' edge cases; the front end's contractions, made on the source
#: expressions, stay)
EXTRA_FLAGS = {'delta_pair': ('-fmad=false',),
               'tvf_pair': ('-Xptxas', '--fmad=false')}
#: the kinds of a pair kernel's default library, and the kinds in all
#: (csrc/shapes.cuh kBaseKinds, kKinds)
BASE_KINDS = 4
KINDS = 8

_loaded = {}


def nvcc():
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = Path(home) / 'bin' / 'nvcc'
    if path.exists():
        return str(path)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on '
                           'PATH')
    return found


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name):
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes with
    ``#include "..."``, directly or through another header, in the order
    first reached."""
    found = []
    todo = [CSRC / (name + '.cu')]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            dep = path.parent / inc
            if not dep.is_file():
                raise FileNotFoundError('%s includes %r, which is not in %s'
                                        % (path.name, inc, path.parent))
            todo.append(dep)
    return found


def flags(name, extra=()):
    """The nvcc flags of ``csrc/<name>.cu`` (and ``extra``)."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ()) + tuple(extra)


def build_key(name, extra=()):
    """Hash of the sources of ``name`` and the flags: the library's
    name, so that an edit of the ``.cu`` or of a header it includes
    rebuilds it."""
    digest = hashlib.sha256(' '.join(flags(name, extra)).encode())
    for path in sources(name):
        digest.update(path.name.encode() + b'\0' + path.read_bytes())
    return digest.hexdigest()[:16]


def build(name, extra=()):
    """Path of ``lib<name>-<hash>.so``, compiling it if missing, with the
    flags ``extra`` beside the source's own (a variant: the library
    that ``load_library`` loads once ``EXTRA_FLAGS[name]`` holds them
    too)."""
    src = CSRC / (name + '.cu')
    lib = BUILD_DIR / ('lib%s-%s.so' % (name, build_key(name, extra)))
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(lib.name + '.%d.tmp' % os.getpid())
    proc = subprocess.run([nvcc(), *flags(name, extra), '-o', str(tmp),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError('nvcc failed on %s:\n%s%s' % (
            src, proc.stdout, proc.stderr))
    lib.with_suffix('.log').write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


_PROPERTIES = re.compile(r'Function properties for (\S+)')
_SPILLS = re.compile(r'(\d+) bytes spill stores, (\d+) bytes spill loads')
_REGISTERS = re.compile(r'Used (\d+) registers')


def resources(lib):
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from the ``-Xptxas -v`` log kept beside the library
    ``lib``."""
    found, name = {}, None
    for line in Path(lib).with_suffix('.log').read_text().splitlines():
        m = _PROPERTIES.search(line)
        if m:
            name = m.group(1)
            found[name] = [0, 0, 0]
            continue
        m = _SPILLS.search(line)
        if m and name is not None:
            found[name][1:] = int(m.group(1)), int(m.group(2))
        m = _REGISTERS.search(line)
        if m and name is not None:
            found[name][0] = int(m.group(1))
            name = None
    return {k: tuple(v) for k, v in found.items()}


def kind_flags(kind):
    """The flags beside a pair kernel's own of the library that holds
    the shape ``kind``: none for the default library."""
    return () if kind < BASE_KINDS else ('-DPAIR_KIND=%d' % kind,)


def load_library(name, args_type, extra=()):
    """The built library of ``csrc/<name>.cu`` (with the flags
    ``extra``) as a ``ctypes.CDLL`` with its C interface declared,
    checked against the argument struct ``args_type``."""
    key = (name,) + tuple(extra)
    if key not in _loaded:
        lib = ctypes.CDLL(str(build(name, extra)))
        fn = getattr(lib, name + '_launch')
        fn.argtypes = [ctypes.POINTER(args_type), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, name + '_error_string')
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        fn = getattr(lib, name + '_args_size')
        fn.argtypes = []
        fn.restype = ctypes.c_int
        if fn() != ctypes.sizeof(args_type):
            raise RuntimeError('%s: argument struct is %d bytes in C and %d '
                               'in Python' % (name, fn(),
                                              ctypes.sizeof(args_type)))
        _loaded[key] = lib
    return _loaded[key]


def launch(name, args, device):
    """Launch ``csrc/<name>.cu`` with the ctypes struct ``args`` on the
    current stream of ``device`` (from the library of its
    ``kernel_kind``, where it has one); raises if CUDA refuses the
    launch."""
    lib = load_library(name, type(args),
                       kind_flags(getattr(args, 'kernel_kind', 0)))
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, name + '_launch')(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError('%s launch failed: %s (CUDA error %d)' % (
            name, getattr(lib, name + '_error_string')(rc).decode(), rc))


def data_ptr(t, n, dtype, device, what, width=None):
    """``t.data_ptr()``, once ``t`` is checked to be a contiguous
    ``(n,)`` tensor of ``dtype`` on ``device`` (``(n, width)`` for a
    strided prop)."""
    shape = (n,) if width is None else (n, width)
    if t.device != device or t.dtype != dtype or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError('%s must be a contiguous %s %s tensor on %s, '
                         'got %s %s on %s' % (what, shape, dtype, device,
                                              tuple(t.shape), t.dtype,
                                              t.device))
    return t.data_ptr()
