"""The port's test modules share one thread policy: import
``_one_torch_thread`` into a module to apply it there."""
import pytest


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the plain
    versions run many small ops, and while the test workers share the
    cores each parallel region's barrier waits on descheduled threads."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
