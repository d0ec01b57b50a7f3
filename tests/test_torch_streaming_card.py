"""Out-of-core streaming's pinned copy-stream path, on the card only (run
with ``-m cuda``; skips without a card). No JAX here: the card tests hold
the port against itself.

Host chunks staged through the pinned buffers and the side copy stream,
serially and with a prefetching loader of 1 and 2 chunks, give bitwise the
stats of a device source over the same values and of the one-shot
``daily_factor_stats``; a chunk-file source through the same path too.
"""

import numpy as np
import pytest
import torch

from factormodeling_tpu_torch import io as fio
from factormodeling_tpu_torch.metrics import daily_factor_stats
from factormodeling_tpu_torch.parallel import streaming as st
from tests.torch_threads import torch_one_thread  # noqa: F401

STATS = ("ic", "rank_ic", "factor_return")


def _equal(a, b):
    return torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))


@pytest.mark.cuda
def test_pinned_copy_stream_path_is_bitwise_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the pinned staging buffers and "
                    "the side copy stream exist only on CUDA")
    rng = np.random.default_rng(11)
    stack = rng.normal(size=(14, 64, 256)).astype(np.float32)
    stack[rng.random(stack.shape) < 0.03] = np.nan
    ret = torch.from_numpy(rng.normal(scale=0.02, size=(64, 256)).astype(
        np.float32)).cuda()
    uni = torch.from_numpy(rng.random((64, 256)) > 0.1).cuda()
    kw = dict(universe=uni, stats=STATS, shift_periods=2)
    src, sl = st.host_array_source(stack, 4)
    serial = st.streamed_factor_stats(src, len(sl), ret, **kw)
    dev = torch.from_numpy(stack).cuda()
    fused = st.streamed_factor_stats(lambda i: dev[sl[i]], len(sl), ret,
                                     fuse_source=True, **kw)
    one = daily_factor_stats(dev, ret, **kw)
    fio.save_factor_stack_chunks(tmp_path, (stack[s] for s in sl),
                                 factor_names=[f"f{i}" for i in range(14)])
    dsrc, dsl, _ = fio.disk_chunk_source(tmp_path)
    runs = [st.streamed_factor_stats(src, len(sl), ret, prefetch=p, **kw)
            for p in (1, 2)]
    runs.append(st.streamed_factor_stats(dsrc, len(dsl), ret, prefetch=1,
                                         **kw))
    for k in STATS:
        assert _equal(serial[k], fused[k]), k
        assert _equal(serial[k], one[k]), k
        for other in runs:
            assert _equal(serial[k], other[k]), k
