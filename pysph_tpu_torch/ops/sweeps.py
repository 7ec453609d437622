"""What every iterated group's sweeps share, whichever kernel runs them
(``ops/iisph_solve.py``, ``ops/gasd_pair.py::gasd_sweep``): the loop
condition and the device log of sweep counts."""

import logging

import torch

logger = logging.getLogger(__name__)

#: the entries of a ``SweepLog``
LOG_ENTRIES = 4096


class SweepLog(object):
    """A ring of sweep counts on a device, which ``iisph_solve`` and the
    gas density sweeps append to on the device (the count of calls
    first, then ``entries`` counts); ``drain`` reads it (one read)."""

    def __init__(self, device, entries=LOG_ENTRIES):
        self.buf = torch.zeros(1 + entries, dtype=torch.int32,
                               device=device)

    def add(self, count, active=None):
        """Log ``count`` (an int or a 0-d int tensor) with device ops
        (nothing read; a capture takes them), where ``active`` (a 0-d
        device bool) is set if given."""
        buf = self.buf
        n = buf[:1]
        idx = (1 + torch.remainder(n, buf.shape[0] - 1)).long()
        val = torch.as_tensor(count, dtype=buf.dtype, device=buf.device)
        if active is not None:
            val = torch.where(active, val, buf[idx])
            n.add_(active.to(buf.dtype))
        else:
            n.add_(1)
        buf.index_put_((idx,), val.reshape(1))

    def drain(self):
        """The counts logged since the last drain, oldest first; empties
        the log."""
        vals = self.buf.tolist()
        n, ring = vals[0], vals[1:]
        if not n:
            return []
        cap = len(ring)
        if n > cap:
            logger.warning('sweep log: %d of %d counts overwritten before '
                           'a read', n - cap, n)
        kept = min(n, cap)
        self.buf[0] = 0
        return [ring[(n - kept + k) % cap] for k in range(kept)]


def keep_sweeping(it, conv, min_iterations, max_iterations):
    """An iterated group's loop condition after ``it`` sweeps, the last
    converged or not (``conv``): pysph_tpu's ``lax.while_loop`` cond,
    ``(it < max_it) & ~(conv & (it >= min_it))``
    (``pysph_tpu/ops/resident.py:1501``), as csrc/iisph_solve.cu and
    csrc/gasd_pair.cu's sweep slots evaluate it on the card."""
    return it < max_iterations and not (conv and it >= min_iterations)
