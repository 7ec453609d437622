"""What the port's tests share.

``one_torch_thread``: a module-scoped autouse fixture that runs the
module's torch CPU work on one intra-op thread and restores the count
after it.  The suite runs in several worker processes at once, and
torch's default of one thread a core in each of them makes the threads
of the workers fight for the cores.  A test file takes it by importing
it (with ``# noqa: F401``, as the name is not used):

    from pysph_tpu_torch.tools_dev.testing import one_torch_thread
"""

import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
