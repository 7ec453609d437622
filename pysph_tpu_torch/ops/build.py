"""Build the CUDA kernels of ``pysph_tpu_torch/csrc`` with nvcc.

Each ``csrc/<name>.cu`` has a plain C interface and becomes a shared
library, loaded with ``ctypes``.  The build runs at first use, into
``build/`` at the repository root, keyed by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is not.  The
compiler's resource report (``-Xptxas -v``: registers, spills, shared
memory per kernel) is kept beside the library as ``.log``.

Needs the CUDA toolkit (``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``,
else ``nvcc`` on ``PATH``) and a Hopper card: the code is built for
``sm_90a`` only.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

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


def build(name):
    """Path of ``lib<name>-<hash>.so``, compiling it if missing."""
    src = CSRC / (name + '.cu')
    key = hashlib.sha256(src.read_bytes() +
                         ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / ('lib%s-%s.so' % (name, key))
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(lib.name + '.%d.tmp' % os.getpid())
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError('nvcc failed on %s:\n%s%s' % (
            src, proc.stdout, proc.stderr))
    lib.with_suffix('.log').write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def load_library(name):
    """The built library of ``csrc/<name>.cu`` as a ``ctypes.CDLL``."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
