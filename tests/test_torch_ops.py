"""The port's ops library (``factormodeling_tpu_torch.ops``) against the JAX
package's ops, on the CPU in float64 with the same seeded numpy inputs:
NaNs, a ragged universe, ties (signed zeros among them), group id -1, empty
groups and ids past the counted groups, and every pandas tie method. Each
op's case runs both packages and compares to 1e-10 unless stated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factormodeling_tpu_torch as fmt
from factormodeling_tpu import ops as jops
from factormodeling_tpu.ops import _rank as jrank
from factormodeling_tpu_torch import ops as tops
from factormodeling_tpu_torch.ops import _rank as trank
from tests.torch_threads import torch_one_thread  # noqa: F401

F, D, N, G = 3, 30, 16, 5
TOL = 1e-10
METHODS = ("average", "min", "max", "first", "dense")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(D, N))
    x[rng.uniform(size=x.shape) < 0.12] = np.nan
    x[:, 1] = np.round(x[:, 1] * 2) / 2                  # ties along dates
    x[2] = np.round(x[2])                                # ties across assets
    x[3, :6] = [0.0, -0.0, 0.0, -0.0, 1.0, 1.0]          # -0.0 ties +0.0
    x[5:12, 4] = 1.25                                    # constant window
    x[7] = np.nan                                        # all-NaN date
    x[8, :] = 2.5
    x[8, 3] = np.nan                                     # constant date
    y = 0.5 * np.nan_to_num(x) + rng.normal(scale=0.3, size=(D, N))
    y[rng.uniform(size=y.shape) < 0.08] = np.nan
    stack = rng.normal(size=(F, D, N))
    stack[rng.uniform(size=stack.shape) < 0.1] = np.nan
    stack[0, 2] = np.round(stack[0, 2])
    uni = rng.uniform(size=(D, N)) > 0.15
    uni[:, 0] = True
    uni[9, :] = False
    uni[10, :] = False
    uni[10, 5] = True                                    # single-row date
    gid = rng.integers(-1, G - 1, size=(D, N))           # group G-1 empty
    gid[11, :] = 2                                       # one group per date
    gid[12, 3] = G + 1                                   # id past the groups
    tie = np.argsort(rng.uniform(size=(D, N)), axis=-1)  # a permutation per row
    unit = rng.uniform(-0.1, 1.2, size=(D, N))
    unit[0, :4] = [0.2, 0.4, 1.0, np.nan]                # bin edges, NaN
    gid_full = rng.integers(-1, G - 1, size=(F, D, N)).astype(np.int32)
    return dict(x=x, y=y, stack=stack, uni=uni, gid=gid.astype(np.int32),
                gid_full=gid_full,
                tie=tie.astype(np.int32), unit=unit)


def _both(case, seed=0):
    a = _inputs(seed)
    j = case(jops, jrank, {k: jnp.asarray(v) for k, v in a.items()})
    t = case(tops, trank, {k: torch.from_numpy(np.asarray(v))
                           for k, v in a.items()})
    return j, t


def _compare(j, t, tol=TOL):
    if isinstance(j, (tuple, list)):
        assert len(j) == len(t)
        for jj, tt in zip(j, t):
            _compare(jj, tt, tol)
        return
    want = np.asarray(j)
    got = t.numpy()
    assert got.shape == want.shape
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, equal_nan=True)


TS_CASES = {
    f"{name}-w{w}-{'uni' if uni else 'dense'}":
        (lambda m, r, a, name=name, w=w, uni=uni: getattr(m, name)(
            a["x"], w, universe=a["uni"] if uni else None))
    for name, windows in (("ts_sum", (1, 3, 7)), ("ts_mean", (1, 4)),
                          ("ts_std", (1, 2, 5)), ("ts_zscore", (2, 4)),
                          ("ts_rank", (1, 3, 6)), ("ts_diff", (1, 5)),
                          ("ts_delay", (1, 5)), ("ts_decay", (0, 1, 4, 9)))
    for w in windows for uni in (False, True)}
TS_CASES["ts_backfill-dense"] = lambda m, r, a: m.ts_backfill(a["x"])
TS_CASES["ts_backfill-uni"] = lambda m, r, a: m.ts_backfill(
    a["x"], universe=a["uni"])
TS_CASES["ts_mean-stack-uni"] = lambda m, r, a: m.ts_mean(
    a["stack"], 3, universe=a["uni"])
TS_CASES["ts_decay-stack"] = lambda m, r, a: m.ts_decay(a["stack"], 6)


@pytest.mark.parametrize("case", list(TS_CASES))
def test_timeseries_ops_match_jax(case):
    _compare(*_both(TS_CASES[case]))


CS_CASES = {
    **{f"cs_rank-{meth}-{'uni' if uni else 'dense'}":
       (lambda m, r, a, meth=meth, uni=uni: m.cs_rank(
           a["x"], universe=a["uni"] if uni else None, method=meth))
       for meth in METHODS for uni in (False, True)},
    "cs_rank-first-tie_order": lambda m, r, a: m.cs_rank(
        a["x"], a["uni"], method="first", tie_order=a["tie"]),
    "cs_rank-stack": lambda m, r, a: m.cs_rank(a["stack"], a["uni"]),
    "cs_winsor": lambda m, r, a: m.cs_winsor(a["x"]),
    "cs_winsor-uni": lambda m, r, a: m.cs_winsor(
        a["x"], (0.05, 0.9), min_valid=8, universe=a["uni"]),
    "cs_filter_center": lambda m, r, a: m.cs_filter_center(a["x"]),
    "cs_filter_center-uni": lambda m, r, a: m.cs_filter_center(
        a["x"], (0.2, 0.6), universe=a["uni"]),
    "cs_zscore": lambda m, r, a: m.cs_zscore(a["x"]),
    "cs_zscore-uni-stack": lambda m, r, a: m.cs_zscore(a["stack"], a["uni"]),
    "cs_bool": lambda m, r, a: m.cs_bool(a["x"] > 0.1, a["x"], a["y"]),
    "cs_mean": lambda m, r, a: m.cs_mean(a["x"]),
    "cs_mean-uni": lambda m, r, a: m.cs_mean(a["x"], a["uni"]),
    "market_neutralize": lambda m, r, a: m.market_neutralize(a["x"]),
    "market_neutralize-uni": lambda m, r, a: m.market_neutralize(
        a["x"], a["uni"]),
    "sign": lambda m, r, a: m.sign(a["x"]),
    "power-int": lambda m, r, a: m.power(a["x"], 3),
    "power-frac": lambda m, r, a: m.power(a["x"], 0.5),
    "log": lambda m, r, a: m.log(a["x"]),
    "abs_": lambda m, r, a: m.abs_(a["x"]),
    "clip": lambda m, r, a: m.clip(a["x"], -0.5, 0.75),
}


@pytest.mark.parametrize("case", list(CS_CASES))
def test_cross_sectional_and_elementwise_ops_match_jax(case):
    _compare(*_both(CS_CASES[case]))


GROUP_CASES = {
    "bucket": lambda m, r, a: m.bucket(a["unit"]),
    "bucket-range": lambda m, r, a: m.bucket(a["unit"], (0.0, 1.0, 0.25)),
    # ids [D, N] on a panel, shared by a stack, and per row of the stack
    **{f"{name}-{form}": (lambda m, r, a, name=name, form=form: getattr(
        m, name)(a["x"] if form == "panel" else a["stack"],
                 a["gid_full"] if form == "full" else a["gid"], G))
       for name in ("group_mean", "group_neutralize", "group_normalize")
       for form in ("panel", "shared", "full")},
    **{f"group_rank_normalized-{meth}":
       (lambda m, r, a, meth=meth: m.group_rank_normalized(
           a["stack"], a["gid"], G, method=meth))
       for meth in METHODS},
    "group_rank_normalized-first-tie_order": lambda m, r, a:
        m.group_rank_normalized(a["x"], a["gid"], G, method="first",
                                tie_order=a["tie"]),
    "cs_zscore_group_neutralize": lambda m, r, a:
        m.cs_zscore_group_neutralize(a["stack"], a["gid"], G),
    "cs_zscore_group_neutralize-uni": lambda m, r, a:
        m.cs_zscore_group_neutralize(a["x"], a["gid"], G, a["uni"]),
}


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_group_ops_match_jax(case):
    _compare(*_both(GROUP_CASES[case]))


REG_CASES = {
    **{f"ts_regression_fast-r{rt}-lag{lag}-{'uni' if uni else 'dense'}":
       (lambda m, r, a, rt=rt, lag=lag, uni=uni: m.ts_regression_fast(
           a["y"], a["x"], 6, lag=lag, rettype=rt,
           universe=a["uni"] if uni else None))
       for rt in (0, 1, 2, 3, 6) for lag, uni in ((0, False), (2, True))},
    **{f"cs_regression-{rt}-{'uni' if uni else 'dense'}":
       (lambda m, r, a, rt=rt, uni=uni: m.cs_regression(
           a["y"], a["x"], rt, universe=a["uni"] if uni else None))
       for rt in ("resid", "beta", "alpha", "fitted", "r2")
       for uni in (False, True)},
    "cs_ols": lambda m, r, a: m.cs_ols(a["y"], a["stack"]),
    "cs_ols-uni-ridge": lambda m, r, a: m.cs_ols(
        a["y"], a["stack"], universe=a["uni"], ridge=0.05),
    "cs_ols-no-intercept": lambda m, r, a: m.cs_ols(
        a["y"], a["stack"], intercept=False),
}


@pytest.mark.parametrize("case", list(REG_CASES))
def test_regression_ops_match_jax(case):
    # cs_ols: the normal equations summed in another order, then solved
    _compare(*_both(REG_CASES[case]), tol=1e-9 if "ols" in case else TOL)


PRIM_CASES = {
    "forward_fill": lambda m, r, a: m.forward_fill(a["x"]),
    "forward_fill-axis0": lambda m, r, a: m.forward_fill(a["stack"], axis=0),
    "masked_shift": lambda m, r, a: m.masked_shift(a["x"], a["uni"], 2),
    "masked_shift-back": lambda m, r, a: m.masked_shift(a["x"], a["uni"], -1),
    "rolling_sum": lambda m, r, a: m.rolling_sum(a["y"], 4),
    "shift": lambda m, r, a: m.shift(a["x"], 3),
    "shift-back": lambda m, r, a: m.shift(a["x"], -2, axis=-1),
    **{f"avg_rank-{meth}": (lambda m, r, a, meth=meth: r.avg_rank(
        a["x"], method=meth)) for meth in METHODS},
    "avg_rank-first-tie_order": lambda m, r, a: r.avg_rank(
        a["x"], method="first", tie_order=a["tie"]),
    "avg_rank-axis0": lambda m, r, a: r.avg_rank(a["x"], axis=0),
    **{f"rank_sorted-{meth}": (lambda m, r, a, meth=meth: r.rank_sorted(
        a["x"], method=meth, carry=(a["y"],))) for meth in METHODS},
    **{f"segment_avg_rank-{meth}":
       (lambda m, r, a, meth=meth: r.segment_avg_rank(
           a["stack"], a["gid"], method=meth)) for meth in METHODS},
    "segment_avg_rank-first-tie_order": lambda m, r, a: r.segment_avg_rank(
        a["x"], a["gid"], method="first", tie_order=a["tie"]),
    "masked_quantile": lambda m, r, a: r.masked_quantile(
        a["x"], (0.1, 0.5, 0.9)),
}


@pytest.mark.parametrize("case", list(PRIM_CASES))
def test_window_and_rank_primitives_match_jax(case):
    _compare(*_both(PRIM_CASES[case]))


def test_ops_surface_matches_jax_export_list():
    import factormodeling_tpu.ops as jax_ops_pkg

    want = {n for n in vars(jax_ops_pkg) if not n.startswith("_")
            and callable(getattr(jax_ops_pkg, n))}
    have = {n for n in vars(fmt.ops) if not n.startswith("_")
            and callable(getattr(fmt.ops, n))}
    # the 28 reference ops, cs_zscore_group_neutralize, cs_ols, 4 primitives
    assert want == have and len(want) == 34


def test_rank_method_is_checked():
    with pytest.raises(ValueError, match="rank method"):
        tops.cs_rank(torch.zeros(2, 3), method="ordinal")
