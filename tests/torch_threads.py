"""One intra-op thread for the port's CPU tests, module by module.

The tests run in several worker processes at once (pytest-xdist, one
worker per core or near it).  A torch CPU op otherwise starts one OpenMP
thread per core in every worker, and the workers' spinning threads stall
each other: six concurrent runs of ``test_torch_hybrid.py::
test_hybrid_serves_like_jax[fullcomp]`` on an 8-core host took 836-837 s
each with 8 intra-op threads and 42-44 s each with one
(``tests/torch_thread_probe.py concurrent``).  A test module imports the
fixture below; results do
not depend on the thread count beyond the summation order of torch's
own parallel reductions, which the tests' limits cover.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
