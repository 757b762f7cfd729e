"""A module-scoped fixture that runs a test module's torch work on one CPU
thread and restores the count after it: the suite runs in several worker
processes at once, and each worker's default thread pool (one thread a core)
would oversubscribe the cores; the modules that use it run small models,
which gain nothing from intra-op threads."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
