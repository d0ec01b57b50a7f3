"""A module-scoped fixture that runs a port test module's torch CPU work on
one intra-op thread.

The port's CPU tests run tiny tensors (tens of assets, a few hundred dates)
through many small torch calls: Cholesky factors of T x T matrices, the
ADMM segment's plain version, the window twins. With the default intra-op
pool (one thread a core) each such call fans out over OpenMP/MKL threads,
and under pytest-xdist's workers, one process a core, those pools
oversubscribe the host many times over: a 24 x 24 Cholesky measured 14 ms
a call with the pool against well under 1 ms on one thread. One thread
computes the same operations; the module's previous setting is restored
when it ends, so test modules of the JAX package sharing the worker are
untouched.

Import it into a test module (``from tests.torch_threads import
torch_one_thread  # noqa: F401``); it is autouse.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
