"""One torch intra-op thread for a port test module, restored after it:
an autouse fixture that the ``test_torch_*`` files import.  Their
tensors are small, and with several test workers sharing the cores,
more threads only wait busily against each other's (and against the
emulated kernels' block threads)."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
