"""The port's CPU tests run torch on one intra-op thread.

Tier-1 runs the tests in six pytest workers on the host's cores. Each
worker's torch keeps a pool of as many threads as the host has cores, and
the six pools oversubscribed the cores: every test that runs torch on the
CPU, and every test beside it on the other workers, waited on them. Each
port test module takes `one_torch_thread` (module-scoped, autouse): torch
on one thread for that module, and the thread count it had back after it.

The thread count decides how some CPU products round, and
torch.set_num_threads leaves state behind in MKL (it turns MKL's dynamic
mode off, among others) that setting the count back does not undo. A test
pinned to the rounding of torch's default threads runs its torch in a
fresh interpreter (tests/test_torch_port_tevit.py's seed-51 crossing).
"""
import contextlib

import pytest
import torch


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to n, and the count it had on exit."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """torch on one thread for the module that imports this fixture."""
    with torch_threads(1):
        yield


def test_one_torch_thread_inside_a_port_module():
    assert torch.get_num_threads() == 1


@pytest.mark.parametrize('n', [2, 3])
def test_torch_threads_sets_and_restores(n):
    with torch_threads(n):
        assert torch.get_num_threads() == n
        with torch_threads(1):
            assert torch.get_num_threads() == 1
        assert torch.get_num_threads() == n
    assert torch.get_num_threads() == 1


def test_products_agree_across_thread_counts():
    """One thread changes only the rounding: a product on one thread and
    on four agree with float64 to f32 rounding of its sums."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(96, 512, generator=g)
    b = torch.randn(512, 64, generator=g)
    one = a @ b
    with torch_threads(4):
        many = a @ b
    ref = a.double() @ b.double()
    scale = ref.abs().max().item()
    for got in (one, many):
        assert (got.double() - ref).abs().max().item() <= 1e-5 * scale
