"""Shared by the port's CPU test files: hold torch to one thread for the
length of a test module. A file takes it with one line,

    from torch_threads import one_thread  # noqa: F401  (autouse)

The port's tests run tiny models whose ops are too small to share among
threads; beside other test processes (``pytest -n``), a thread pool a
process spins takes far longer than the work it computes."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
