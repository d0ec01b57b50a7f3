"""Fixtures that run the port at JAX's x64 width: ``torch.get_default_dtype()``
float64, the port's counterpart of the ``jax_enable_x64`` flag the test
suite turns on (conftest). The port's seeded draws (``threefry``) and the
compat layer's densified panels take the default width, so a test holding
them against the JAX package in-process sets float64 first; the previous
default is restored afterwards.

Import the one a module needs (``from tests.torch_x64 import
torch_float64_module  # noqa: F401`` for a whole module, autouse; or ask
for ``torch_float64`` by name in a test).
"""

import pytest
import torch


def _float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


@pytest.fixture
def torch_float64():
    yield from _float64()


@pytest.fixture(autouse=True, scope="module")
def torch_float64_module():
    yield from _float64()
