"""One intra-op thread for torch in the port's CPU tests.

The port's CPU tests run the kernels' plain versions: step loops of
small products, where torch's default of one thread per core spends
more time handing work between threads than computing, most of all with
several pytest workers sharing the cores.  Each port test module imports
this autouse fixture; it sets one thread for the module and restores the
previous count after it, so other modules in the same worker keep
theirs.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
