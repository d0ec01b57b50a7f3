"""Ops library (L2): the reference ``operations.py`` surface as dense masked
PyTorch ops over ``float[..., D, N]`` panels (date axis -2, asset axis -1),
port of ``factormodeling_tpu/ops``. All 28 reference transforms:

- time-series (per symbol, rolling):  :mod:`.timeseries`
- cross-sectional (per date):         :mod:`.cross_sectional`
- elementwise math:                   :mod:`.elementwise`
- group (per date x group):           :mod:`.group`
- regression (rolling + per-date):    :mod:`.regression`

Kernels: :mod:`._cuda_window` (the window-streaming ops behind ``ts_decay``,
``ts_rank``, ``ts_std``, ``ts_zscore`` on the card), :mod:`._cuda_fused`
(``cs_zscore_group_neutralize(..., use_kernel=True)``) and
:mod:`._cuda_admm` (the ADMM segment of the QP solver).
"""

from factormodeling_tpu_torch.ops._window import (  # noqa: F401
    forward_fill,
    masked_shift,
    rolling_sum,
    shift,
)
from factormodeling_tpu_torch.ops.cross_sectional import (  # noqa: F401
    cs_bool,
    cs_filter_center,
    cs_mean,
    cs_rank,
    cs_winsor,
    cs_zscore,
    market_neutralize,
)
from factormodeling_tpu_torch.ops.elementwise import abs_, clip, log, power, sign  # noqa: F401
from factormodeling_tpu_torch.ops.group import (  # noqa: F401
    bucket,
    cs_zscore_group_neutralize,
    group_mean,
    group_neutralize,
    group_normalize,
    group_rank_normalized,
)
from factormodeling_tpu_torch.ops.regression import cs_ols, cs_regression, ts_regression_fast  # noqa: F401
from factormodeling_tpu_torch.ops.timeseries import (  # noqa: F401
    ts_backfill,
    ts_decay,
    ts_delay,
    ts_diff,
    ts_mean,
    ts_rank,
    ts_std,
    ts_sum,
    ts_zscore,
)
