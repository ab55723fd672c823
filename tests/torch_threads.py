"""The port's CPU tests on one intra-op thread.

A test file imports the fixture, which is then autouse for its tests:

    from tests.torch_threads import one_torch_thread  # noqa: F401

With the test workers sharing the cores, torch's intra-op threads stall
at every op's barrier on the port's small CPU batches: 50 thermalization
sweeps of a 4x4 snapshot took 97 s instead of 6 under six busy cores, and
a 6 + 2 step checkpoint test 139 s instead of 5.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread for the module's tests, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
