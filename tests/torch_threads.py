"""One torch thread in each of the port's test modules.

The tier-1 suite runs six pytest workers on the machine's cores at once.
At its default of one OpenMP thread per core, each worker's torch spins
threads that starve the other workers: six concurrent runs of the GAN
step's parity tests (tests/test_torch_hifigan_train.py) took 714 s each at
eight threads and 151 s at one, on eight cores.  A test module imports
the fixture to run its tests at one thread."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
