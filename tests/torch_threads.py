"""Torch's CPU thread pool for the port's tests (tests/test_torch_*.py
import the fixture below).

Under pytest-xdist each of the N workers gets its share of the cores, at
least one, instead of an OpenMP pool as wide as the machine: N full-width
pools oversubscribe the cores, and the tiny tensors of these tests then
spend their time in the pools' barriers (one engine test took ~1.6 s alone
and ~145 s beside five busy workers). A single process keeps every core.
The thread count changes no result these tests compare: the port against
JAX within stated tolerances, and port against port in one process."""

import os

import pytest
import torch


def _worker_threads() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // max(1, workers))


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    prev = torch.get_num_threads()
    torch.set_num_threads(_worker_threads())
    yield
    torch.set_num_threads(prev)
