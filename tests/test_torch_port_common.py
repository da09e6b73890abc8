"""What the port's CPU test files share (imported by them; holds no test)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several worker processes side by side on few cores:
    PyTorch with one thread per process takes no time waiting for its own
    thread pool (a small walk under contention took minutes, not seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
