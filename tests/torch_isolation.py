"""A module-scoped fixture that leaves no process-wide telemetry behind a
port test module.

Port test modules that build the JAX package's serving or streaming
in-process compile its jitted entry points, which record into the JAX
package's process-wide compile statistics (``obs.compile_log``) and its
streaming kernel cache. Under pytest-xdist another module of the same
worker may then see those records: a JAX test that asserts no entry point
of the process is ``retraced`` reads a bucket this module compiled first.
After each module this fixture resets the JAX package's compile
statistics, clears its streaming kernel cache, and resets the port's
compile statistics.

Import it into a test module (``from tests.torch_isolation import
reset_process_telemetry  # noqa: F401``); it is autouse.
"""

import pytest


@pytest.fixture(autouse=True, scope="module")
def reset_process_telemetry():
    yield
    from factormodeling_tpu.obs.compile_log import \
        reset_compile_stats as jax_reset
    from factormodeling_tpu.parallel.streaming import clear_streaming_cache
    from factormodeling_tpu_torch.obs.compile_log import reset_compile_stats

    jax_reset()
    clear_streaming_cache()
    reset_compile_stats()
