"""Output helpers (port of ``mkdir`` and ``get_files`` of
``pysph_tpu/solver/utils.py``)."""

import glob
import os


def get_files(dirname=None, fname=None, endswith=('hdf5', 'npz')):
    """The dump files ``<fname>_<count>.<ext>`` in ``dirname``, sorted by
    count (``fname`` defaults to the directory's name without
    ``_output``)."""
    if dirname is None:
        return []
    if fname is None:
        fname = os.path.basename(dirname).rsplit('_output', 1)[0]
    files = []
    for ext in endswith:
        files.extend(glob.glob(os.path.join(dirname, fname + '_?*.' + ext)))

    def _key(f):
        try:
            return int(os.path.splitext(os.path.basename(f))[0]
                       .rsplit('_', 1)[1])
        except ValueError:
            return -1
    return sorted(files, key=_key)


def mkdir(path):
    if path and not os.path.isdir(path):
        os.makedirs(path, exist_ok=True)
