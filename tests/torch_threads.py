"""One intra-op thread for torch in each of the port's test modules.

The tier-1 run puts several pytest workers on one machine; torch's default
intra-op pool (one thread per core in every worker) then oversubscribes the
cores, and its spinning threads slow the small tensors of these tests by
tens of times. A test module imports ``one_torch_thread`` to run its tests
on one thread (restored after the module).
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
