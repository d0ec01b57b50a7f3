"""The port's compat ``operations`` (the reference's 28 ops over pandas)
against the JAX package's compat ``operations``, on the CPU in float64, on
a ragged (date, symbol) MultiIndex in shuffled row order with NaN values,
ties (the pandas tie methods, ``'first'`` by row order), NaN group labels
and a second series on another ragged index. One case per op (the two rank
ops also with ``method='first'``); each compares the index, the name and
the values at 1e-10 (1e-9 for the rolling regression, as the dense ops'
test holds it), or the labels exactly.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from factormodeling_tpu.compat import operations as jop
from factormodeling_tpu_torch.compat import operations as top
from tests.torch_threads import torch_one_thread  # noqa: F401
from tests.torch_x64 import torch_float64_module  # noqa: F401

D, N = 24, 14


def _frames():
    rng = np.random.default_rng(7)
    dates = pd.date_range("2022-03-01", periods=D, freq="B")
    syms = [f"S{i:02d}" for i in range(N)]
    idx = pd.MultiIndex.from_product([dates, syms], names=["date", "symbol"])
    keep = rng.uniform(size=len(idx)) > 0.12
    vals = rng.normal(size=len(idx))
    vals[rng.uniform(size=len(idx)) < 0.08] = np.nan
    vals[::11] = np.round(vals[::11])                 # ties
    x = pd.Series(vals, index=idx, name="x")[keep]
    x = x.sample(frac=1.0, random_state=3)            # shuffled row order
    keep_y = rng.uniform(size=len(idx)) > 0.1
    y = pd.Series(0.5 * np.nan_to_num(vals) + rng.normal(scale=0.3,
                                                         size=len(idx)),
                  index=idx, name="y")[keep_y]
    y[rng.uniform(size=len(y)) < 0.05] = np.nan
    grp = pd.Series(rng.choice(["a", "b", "c", "d"], size=len(idx)),
                    index=idx, name="g").astype(object)[keep]
    grp[rng.uniform(size=len(grp)) < 0.07] = np.nan   # NaN labels
    unit = pd.Series(rng.uniform(-0.1, 1.2, size=len(idx)), index=idx,
                     name="u")[keep]
    cond = x > 0.2
    return dict(x=x, y=y, g=grp, u=unit, c=cond)


CASES = {
    "ts_sum": lambda m, a, kw: m.ts_sum(a["x"], 4, **kw),
    "ts_mean": lambda m, a, kw: m.ts_mean(a["x"], 4, **kw),
    "ts_std": lambda m, a, kw: m.ts_std(a["x"], 5, **kw),
    "ts_zscore": lambda m, a, kw: m.ts_zscore(a["x"], 5, **kw),
    "ts_rank": lambda m, a, kw: m.ts_rank(a["x"], 6, **kw),
    "ts_diff": lambda m, a, kw: m.ts_diff(a["x"], 2, **kw),
    "ts_delay": lambda m, a, kw: m.ts_delay(a["x"], 3, **kw),
    "ts_decay": lambda m, a, kw: m.ts_decay(a["x"], 5, **kw),
    "ts_backfill": lambda m, a, kw: m.ts_backfill(a["x"], **kw),
    "cs_rank": lambda m, a, kw: m.cs_rank(a["x"], **kw),
    "cs_rank_first": lambda m, a, kw: m.cs_rank(a["x"], method="first",
                                                **kw),
    "cs_winsor": lambda m, a, kw: m.cs_winsor(a["x"], (0.1, 0.9), **kw),
    "cs_filter_center": lambda m, a, kw: m.cs_filter_center(a["x"], **kw),
    "cs_zscore": lambda m, a, kw: m.cs_zscore(a["x"], **kw),
    "cs_bool": lambda m, a, kw: m.cs_bool(a["c"], 1.0, -0.5, **kw),
    "cs_mean": lambda m, a, kw: m.cs_mean(a["x"], **kw),
    "sign": lambda m, a, kw: m.sign(a["x"], **kw),
    "power": lambda m, a, kw: m.power(a["x"], 3, **kw),
    "log": lambda m, a, kw: m.log(a["x"], **kw),
    "abs_": lambda m, a, kw: m.abs_(a["x"], **kw),
    "clip": lambda m, a, kw: m.clip(a["x"], -0.5, 0.7, **kw),
    "bucket": lambda m, a, kw: m.bucket(a["u"], **kw),
    "group_mean": lambda m, a, kw: m.group_mean(a["x"], a["g"], **kw),
    "group_neutralize": lambda m, a, kw: m.group_neutralize(a["x"], a["g"],
                                                            **kw),
    "group_normalize": lambda m, a, kw: m.group_normalize(a["x"], a["g"],
                                                          **kw),
    "group_rank_normalized": lambda m, a, kw: m.group_rank_normalized(
        a["x"], a["g"], **kw),
    "group_rank_normalized_first": lambda m, a, kw: m.group_rank_normalized(
        a["x"], a["g"], method="first", **kw),
    "market_neutralize": lambda m, a, kw: m.market_neutralize(a["x"], **kw),
    "ts_regression_fast": lambda m, a, kw: m.ts_regression_fast(
        a["y"], a["x"], 6, lag=1, rettype=2, **kw),
    "cs_regression": lambda m, a, kw: m.cs_regression(a["y"], a["x"],
                                                      rettype="resid", **kw),
}


def test_every_reference_op_has_a_case():
    assert set(top.__all__) == set(jop.__all__)
    assert len(top.__all__) == 28
    assert {c.removesuffix("_first") for c in CASES} == set(top.__all__)


@pytest.mark.parametrize("case", list(CASES))
def test_compat_op_matches_jax_compat(case):
    a = _frames()
    got = CASES[case](top, a, {"device": "cpu"})
    want = CASES[case](jop, a, {})
    assert isinstance(got, pd.Series)
    assert got.index.equals(want.index)
    assert got.name == want.name
    if case == "bucket":
        pd.testing.assert_series_equal(got, want)
        return
    assert np.isfinite(got.to_numpy(dtype=float)).any()
    tol = 1e-9 if case == "ts_regression_fast" else 1e-10
    np.testing.assert_allclose(got.to_numpy(dtype=float),
                               want.to_numpy(dtype=float), atol=tol, rtol=0,
                               equal_nan=True)


def test_compat_ops_ask_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card error; a card is present")
    a = _frames()
    for case in ("ts_decay", "sign", "group_mean", "cs_regression"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CASES[case](top, a, {})
