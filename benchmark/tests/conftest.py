"""The benchmark's tests run the port's plain kernels on the CPU, several
test processes at once: one intra-op thread each keeps them from
crowding each other out."""

import pytest


@pytest.fixture(autouse=True, scope="session")
def _one_torch_thread():
    import torch
    torch.set_num_threads(1)
    yield
